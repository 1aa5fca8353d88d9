// The split that the divergence-free (DF) cluster kernels share: the
// per-step eval (df_pathwise_fwd.cu, #5), its VJP (df_pathwise_bwd.cu,
// #6), the euler trajectory (df_flow_fused.cu, #7) and its discrete
// adjoint (df_flow_fused_bwd.cu, #8), on cluster.cuh's split. One (draw,
// tile of batch rows) is a cluster of C thread blocks, and the block of
// rank b owns a contiguous share of its work:
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
// #5, #7 and #8 take a tile of R rows (plan_for, cluster.cuh's plan with
// R0 = 4 rows per cluster up to D = 8, else 2, and S*D + M*D items),
// fitted on an H100 to df_pathwise_probe.py's sweep of 11 plans at 13
// shapes (PERF.md section 6): at L = 5, N = 20, 50 two-row clusters; at
// L = 1, N = 20, 20 one-row clusters. At the main shapes the sweep put
// 8-block clusters of 4 rows 13% (#5) and 19% (#8) behind 4-block
// clusters of 2 rows. #6 walks a tile of RT rows, R at a time
// (walk_plan_for): its blocks keep their items' cotangents across the
// tile, so the tiles are as large as still gives about two blocks per SM.

#pragma once

#include "cluster.cuh"
#include "df_common.cuh"

namespace dfc {

using cl::block_sums;
using cl::kMaxCluster;
using cl::kThreads;
using cl::kWarps;
using cl::launch_clusters;
using cl::Plan;
using cl::Share;
using cl::share_of;
using cl::split;

// Whether (R, C) is a plan the kernels take at state dim D (an edited
// plan_for may give others; df_pathwise_probe.py --plans).
inline bool plan_ok(int D, int R, int C) {
  return (R == 1 || R == 2 || (R == 4 && D <= 8)) && C >= 1 &&
         C <= kMaxCluster;
}

// The plan for L draws, N rows, state dim D, SD feature columns and M
// inducing points on a card with `sms` SMs.
inline Plan plan_for(int L, int N, int D, int SD, int M, int sms) {
  return cl::plan_for(L, N, D <= 8 ? 4 : 2, SD + (long long)M * D, SD, M,
                      sms);
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

}  // namespace dfc
