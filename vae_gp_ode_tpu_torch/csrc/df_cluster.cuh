// The split that the divergence-free (DF) cluster kernels share: the
// per-step eval (df_pathwise_fwd.cu, #5), its VJP (df_pathwise_bwd.cu,
// #6), the euler trajectory (df_flow_fused.cu, #7) and its discrete
// adjoint (df_flow_fused_bwd.cu, #8). One (draw, tile of batch rows) is a
// cluster of C thread blocks, and the block of rank b owns a contiguous
// share of its work:
//
//  - feature columns c in [b CB, (b + 1) CB) of the S*D ORFF columns
//    ("column items": x . omf[:, c], one sincosf per row, the G
//    contraction for all D outputs);
//  - inducing points m in [b MB, (b + 1) MB), each as D "(point, output)
//    items" (m, i): the D pairs (j, i) of the matrix-valued update that
//    feed output i, so a point's D^2 pairs go to D threads. (The forward
//    in a cluster of one block takes each point as one item of all D^2
//    pairs instead: there the row tiles fill the card, and a point's
//    distance is computed once for its D outputs.)
//
// A block's threads take its items in order, one per thread and round
// (columns first, then the (point, output) items). Partial sums over a
// block go through warp shuffles and a pass over the warps; over the
// cluster through distributed shared memory, every block's partials read
// in rank order. No atomics: a result does not depend on the order in
// which threads or blocks run, and two launches give the same bits.
//
// #5, #7 and #8 take a tile of R rows (plan_for), fitted on an H100 to
// df_pathwise_probe.py's sweep of 11 plans at 13 shapes (PERF.md section
// 6): R = 4 rows per cluster up to D = 8, else 2, halved while 4 L
// ceil(N/R) blocks would not fill the card (L = 5, N = 20: 50 two-row
// clusters; L = 1, N = 20: 20 one-row clusters); then C = ceil(1.5 SMs /
// clusters) blocks per cluster up to the portable 8, and no more than one
// block per ~128 items. Where the clusters alone fill the card a cluster
// is one block and its barriers are skipped. At the main shapes the sweep
// put 8-block clusters of 4 rows 13% (#5) and 19% (#8) behind 4-block
// clusters of 2 rows. #6 walks a tile of RT rows, R at a time
// (walk_plan_for): its blocks keep their items' cotangents across the
// tile, so the tiles are as large as still gives about two blocks per SM.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "df_common.cuh"

namespace dfc {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;   // the portable cluster size

struct Plan {
  int R;              // batch rows per cluster (the instance's rows)
  int C;              // blocks per cluster
  int RT;             // rows per tile: R, or for the walk of #6 a multiple
  int n_tiles;        // row tiles per draw, ceil(N / RT)
  int CB, MB;         // feature columns and inducing points per block
  long long groups;   // clusters: L * n_tiles
};

// Whether (R, C) is a plan the kernels take at state dim D (an edited
// plan_for may give others; df_pathwise_probe.py --plans).
inline bool plan_ok(int D, int R, int C) {
  return (R == 1 || R == 2 || (R == 4 && D <= 8)) && C >= 1 &&
         C <= kMaxCluster;
}

// p split over C blocks per cluster.
inline Plan split(Plan p, int C, int SD, int M) {
  p.C = C;
  p.CB = (SD + C - 1) / C;
  p.MB = (M + C - 1) / C;
  return p;
}

// The plan for L draws, N rows, state dim D, SD feature columns and M
// inducing points on a card with `sms` SMs.
inline Plan plan_for(int L, int N, int D, int SD, int M, int sms) {
  Plan p;
  p.R = D <= 8 ? 4 : 2;
  while (p.R > 1 && (long long)L * ((N + p.R - 1) / p.R) * 4 < sms) p.R /= 2;
  p.n_tiles = (N + p.R - 1) / p.R;
  p.RT = p.R;
  p.groups = (long long)L * p.n_tiles;
  const long long items = SD + (long long)M * D;
  long long c = p.groups >= sms ? 1 : (3LL * sms + 2 * p.groups - 1) /
                                          (2 * p.groups);
  c = c < (items + 127) / 128 ? c : (items + 127) / 128;
  c = c < 1 ? 1 : c > kMaxCluster ? kMaxCluster : c;
  return split(p, (int)c, SD, M);
}

// The most rows a tile of the walk plan takes (its dx partials are in
// shared memory).
constexpr int kMaxTileRows = 256;

// The plan of the per-step VJP (#6) for the same shapes: C = ceil(items /
// kThreads) blocks per cluster up to 8 (about one item a thread; a block
// keeps its items' cotangents while it walks the tile), R = 4 rows a
// pass up to D = 8, else 2, halved while L ceil(N/R) C blocks would not
// fill the card, and tiles of RT rows (a multiple of R, at most
// kMaxTileRows) as large as still gives about two blocks per SM: at L = 1,
// N = 600, D = 6, S = 256, 8-block clusters of 20 rows (30 tiles); at L =
// 5, N = 20, of 4 rows (5 tiles a draw); at L = 1, N = 20, of one row.
inline Plan walk_plan_for(int L, int N, int D, int SD, int M, int sms) {
  Plan p;
  const long long items = SD + (long long)M * D;
  long long cl = (items + kThreads - 1) / kThreads;
  cl = cl < 1 ? 1 : cl > kMaxCluster ? kMaxCluster : cl;
  p.R = D <= 8 ? 4 : 2;
  while (p.R > 1 && (long long)L * ((N + p.R - 1) / p.R) * cl < sms)
    p.R /= 2;
  long long tiles = (((2LL * sms + cl - 1) / cl) + L - 1) / L;
  const long long most = (N + p.R - 1) / p.R;
  tiles = tiles < most ? tiles : most;
  tiles = tiles < 1 ? 1 : tiles;
  int rt = (int)((N + tiles - 1) / tiles);
  rt = (rt + p.R - 1) / p.R * p.R;
  p.RT = rt < kMaxTileRows ? rt : kMaxTileRows;
  p.n_tiles = (N + p.RT - 1) / p.RT;
  p.groups = (long long)L * p.n_tiles;
  return split(p, (int)cl, SD, M);
}

// This block's columns [c0, c0 + cn) and points [m0, m0 + mn), each point
// as pd items (D, or 1 for a whole point).
struct Share {
  int c0, cn, m0, mn;
  __device__ int items(int pd) const { return cn + mn * pd; }
};

__device__ inline Share share_of(int rank, int CB, int MB, int SD,
                                          int M) {
  Share s;
  s.c0 = rank * CB;
  s.cn = SD - s.c0 < CB ? SD - s.c0 : CB;
  s.cn = s.cn < 0 ? 0 : s.cn;
  s.m0 = rank * MB;
  s.mn = M - s.m0 < MB ? M - s.m0 : MB;
  s.mn = s.mn < 0 ? 0 : s.mn;
  return s;
}

// This thread's share of f at the R rows xs over the block's items, each
// inducing point as D (point, output) items, or for whole_points as one.
template <int R, int DMAX>
__device__ void eval_items(const df::Draw& p, const float* xs,
                           const float* par, int D, int SD,
                           const dfc::Share& sh, bool whole_points,
                           float (&acc)[R][DMAX]) {
  const float* inv = par;
  const float* var = par + D * D;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < DMAX; ++i) acc[r][i] = 0.f;
  const int items = sh.items(whole_points ? 1 : D);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    if (it < sh.cn) {
      // ORFF prior: feature column c for all D outputs
      const int c = sh.c0 + it;
      float u[R];
      const float ph = __ldg(p.phf + c);
#pragma unroll
      for (int r = 0; r < R; ++r) u[r] = ph;
      for (int d = 0; d < D; ++d) {
        const float o = __ldg(p.omf + (long long)d * SD + c);
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = fmaf(xs[r * D + d], o, u[r]);
      }
      float gc[DMAX], gs[DMAX];
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        gc[i] = i < D ? __ldg(p.G + (long long)c * D + i) : 0.f;
        gs[i] = i < D ? __ldg(p.G + ((long long)SD + c) * D + i) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float sn, cs;
        sincosf(u[r], &sn, &cs);
#pragma unroll
        for (int i = 0; i < DMAX; ++i)
          acc[r][i] = fmaf(cs, gc[i], fmaf(sn, gs[i], acc[r][i]));
      }
    } else if (whole_points) {
      // matrix-valued update: all D^2 pairs (j, i) of point m (in #5's
      // clusters of one block the (point, output) items below took 5.0%
      // and 8.4% longer at (L, N) = (1, 600) and (5, 160), D = 6, S = 256;
      // PERF.md section 6)
      const int m = sh.m0 + it - sh.cn;
      float zm[DMAX], nu[DMAX];
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        zm[k] = k < D ? __ldg(p.z + (long long)m * D + k) : 0.f;
        nu[k] = k < D ? __ldg(p.nur + (long long)m * D + k) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dk[DMAX];
        float sq = 0.f;
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          dk[k] = k < D ? xs[r * D + k] - zm[k] : 0.f;
          sq = fmaf(dk[k], dk[k], sq);
        }
#pragma unroll (DMAX <= 8 ? DMAX : 1)
        for (int i = 0; i < DMAX; ++i) {
          if (i >= D) continue;
          float s = 0.f;
#pragma unroll (DMAX <= 8 ? DMAX : 1)
          for (int j = 0; j < DMAX; ++j) {
            if (j >= D) continue;
            const float iv = inv[j * D + i];
            const float E = expf(-0.5f * sq * iv);
            float base = dk[j] * dk[i] * iv;
            if (i == j) base += (float)(D - 1) - sq * iv;
            s = fmaf(E * base * (var[i] * iv), nu[j], s);
          }
          acc[r][i] += s;
        }
      }
    } else {
      // matrix-valued update: point m's pairs (j, i) for output i
      const int q = it - sh.cn;
      const int m = sh.m0 + q / D, i = q % D;
      float zm[DMAX], nu[DMAX];
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        zm[k] = k < D ? __ldg(p.z + (long long)m * D + k) : 0.f;
        nu[k] = k < D ? __ldg(p.nur + (long long)m * D + k) : 0.f;
      }
      const float zi = __ldg(p.z + (long long)m * D + i);
      const float vi = var[i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dk[DMAX];
        float sq = 0.f;
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          dk[k] = k < D ? xs[r * D + k] - zm[k] : 0.f;
          sq = fmaf(dk[k], dk[k], sq);
        }
        const float di = xs[r * D + i] - zi;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < DMAX; ++j) {
          if (j >= D) continue;
          const float iv = inv[j * D + i];
          const float E = expf(-0.5f * sq * iv);
          float base = dk[j] * di * iv;
          if (i == j) base += (float)(D - 1) - sq * iv;
          s = fmaf(E * base * (vi * iv), nu[j], s);
        }
#pragma unroll
        for (int ii = 0; ii < DMAX; ++ii)
          if (ii == i) acc[r][ii] += s;
      }
    }
  }
}

// out[v] (shared, V floats) <- acc[r][i] (v = r * D + i) and, for
// V = R * D + 1, out[R * D] <- extra, each summed over the block's threads
// (warp shuffles, then the warps in order through red, kWarps * V
// floats). Thread v writes out[v]; one barrier, between the warps'
// partials and their sum: a caller reads another thread's out[v] only
// after a barrier of its own.
template <int R, int DMAX>
__device__ void block_sums(float (&acc)[R][DMAX], float extra, int D, int V,
                           float* red, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < D) {
        const float v = df::warp_sum(acc[r][i]);
        if (lane == 0) red[warp * V + r * D + i] = v;
      }
  if (V > R * D) {
    const float v = df::warp_sum(extra);
    if (lane == 0) red[warp * V + R * D] = v;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < V; t += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * V + t];
    out[t] = s;
  }
}

// Launch `kernel` on `grid` blocks of kThreads threads in clusters of C
// (no cluster attribute for C = 1) with `smem` bytes of dynamic shared
// memory, asked for past 48 KB.
template <class Args>
inline cudaError_t launch_clusters(void (*kernel)(Args), const Args& a,
                                   long long grid, int C, size_t smem,
                                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace dfc
