// What the port's cluster kernels share, whatever their GP family: the
// divergence-free (DF) kernels of df_cluster.cuh (#5-#8) and the
// dimwise-RBF euler pair of flow_cluster.cuh (#1, #2). One (draw, tile of
// batch rows) is a cluster of C thread blocks, and the block of rank b
// owns a contiguous share of the work items for the whole launch:
//
//  - column items c in [b CB, (b + 1) CB) of n1 (the feature columns);
//  - point items m in [b MB, (b + 1) MB) of n2 (the inducing points or
//    columns), each taken by the family as one or more items.
//
// A block's threads take its items in order, one per thread and round.
// Partial sums over a block go through warp shuffles and a pass over the
// warps (block_sums); over the cluster through distributed shared memory,
// every block's partials read in rank order (cluster_sum). A kernel that
// leaves per-(draw, row tile) slabs of cotangents has them summed by a
// second kernel of the same library call (finish_slabs). No atomics: a
// result does not depend on the order in which threads or blocks run, and
// two launches give the same bits.
//
// The plan (plan_for) was fitted on an H100 to df_pathwise_probe.py's
// sweep of 11 plans at 13 shapes (PERF.md section 6): R0 rows per cluster
// (the family's choice from D), halved while 4 L ceil(N/R) blocks would
// not fill the card; then C = ceil(1.5 SMs / clusters) blocks per cluster
// up to the portable 8, and no more than one block per ~128 items. Where
// the clusters alone fill the card a cluster is one block and its
// barriers are skipped.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cl {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;   // the portable cluster size

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

struct Plan {
  int R;              // batch rows per cluster (the instance's rows)
  int C;              // blocks per cluster
  int RT;             // rows per tile: R, or for the walk of #6 a multiple
  int n_tiles;        // row tiles per draw, ceil(N / RT)
  int CB, MB;         // column items and point items per block
  long long groups;   // clusters: L * n_tiles
};

// p split over C blocks per cluster: n1 column items, n2 point items.
inline Plan split(Plan p, int C, int n1, int n2) {
  p.C = C;
  p.CB = (n1 + C - 1) / C;
  p.MB = (n2 + C - 1) / C;
  return p;
}

// The plan for L draws and N rows, at most R0 rows per cluster, `items`
// work items a tile (n1 column items, n2 points), on a card with `sms`
// SMs.
inline Plan plan_for(int L, int N, int R0, long long items, int n1, int n2,
                     int sms) {
  Plan p;
  p.R = R0;
  while (p.R > 1 && (long long)L * ((N + p.R - 1) / p.R) * 4 < sms) p.R /= 2;
  p.n_tiles = (N + p.R - 1) / p.R;
  p.RT = p.R;
  p.groups = (long long)L * p.n_tiles;
  long long c = p.groups >= sms ? 1 : (3LL * sms + 2 * p.groups - 1) /
                                          (2 * p.groups);
  c = c < (items + 127) / 128 ? c : (items + 127) / 128;
  c = c < 1 ? 1 : c > kMaxCluster ? kMaxCluster : c;
  return split(p, (int)c, n1, n2);
}

// This block's columns [c0, c0 + cn) and points [m0, m0 + mn), each point
// as pd items.
struct Share {
  int c0, cn, m0, mn;
  __device__ int items(int pd) const { return cn + mn * pd; }
};

__device__ inline Share share_of(int rank, int CB, int MB, int n1, int n2) {
  Share s;
  s.c0 = rank * CB;
  s.cn = n1 - s.c0 < CB ? n1 - s.c0 : CB;
  s.cn = s.cn < 0 ? 0 : s.cn;
  s.m0 = rank * MB;
  s.mn = n2 - s.m0 < MB ? n2 - s.m0 : MB;
  s.mn = s.mn < 0 ? 0 : s.mn;
  return s;
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
        const float v = warp_sum(acc[r][i]);
        if (lane == 0) red[warp * V + r * D + i] = v;
      }
  if (V > R * D) {
    const float v = warp_sum(extra);
    if (lane == 0) red[warp * V + R * D] = v;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < V; t += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * V + t];
    out[t] = s;
  }
}

// Entry v of `mine`, this block's sums in its dynamic shared memory,
// summed over the cluster's C blocks in rank order (C = 1: this block's
// own). Every block adds the same numbers in the same order, so all get
// the same bits. The C reads are issued before the first add, so their
// round trips overlap. The blocks pass a cluster barrier between writing
// their sums and this read, and none overwrites them before the next one.
__device__ __forceinline__ float cluster_sum(float* mine, int C, int v) {
  if (C == 1) return mine[v];
  cg::cluster_group cluster = cg::this_cluster();
  float x[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    x[q] = q < C ? cluster.map_shared_rank(mine, q)[v] : 0.f;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < C) s += x[q];
  return s;
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

// The slabs of a trajectory adjoint (#2, #8) and where its finished
// cotangents go: kOut outputs, output 0 z0bar (per draw in z0w, (L, N*D)),
// the others summed from the (draw, row tile) slabs of P floats. Output q
// has n[q] entries per draw, per[q] says whether it is per draw (else
// summed over the draws), o_out[q] is where it starts in out, off[q]
// where it lies in a slab. The kernels' argument structs hold these
// fields under these names.
constexpr int kOut = 9;

// Fills a's output layout from each output's entries per draw and
// whether it is per draw; returns the summing kernel's blocks (a thread
// per entry of the per-draw outputs, a warp per entry of the shared ones).
template <class A>
inline long long layout_slabs(A& a, const long long (&sizes)[kOut],
                              const int (&per)[kOut]) {
  long long off = 0, at = 0, n_thread = 0, n_warp = 0;
  for (int q = 0; q < kOut; ++q) {
    a.n[q] = sizes[q];
    a.per[q] = per[q];
    a.off[q] = off;
    a.o_out[q] = at;
    if (q > 0) off += sizes[q];
    at += (per[q] ? a.L : 1) * sizes[q];
    if (per[q])
      n_thread += a.L * sizes[q];
    else
      n_warp += sizes[q];
  }
  return (n_thread + kThreads - 1) / kThreads + (n_warp + kWarps - 1) / kWarps;
}

// The summing kernel's body: the finished cotangents from the slabs.
// Entries of a per-draw output (a sum over its draw's row tiles) get a
// thread each, in the first blocks; entries of a shared one (a sum over
// every draw's row tiles, or z0bar's over the draws) a warp each, whose
// lanes split the terms and meet in a shuffle tree. Fixed order
// throughout.
template <class A>
__device__ void finish_slabs(const A& a) {
  const int L = a.L, nt = a.n_tiles;
  const long long ND = (long long)a.N * a.D, P = a.P;
  long long n_thread = 0;
  for (int q = 0; q < kOut; ++q)
    if (a.per[q]) n_thread += L * a.n[q];
  const long long thread_blocks = (n_thread + blockDim.x - 1) / blockDim.x;
  if (blockIdx.x < thread_blocks) {
    long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n_thread) return;
    for (int q = 0; q < kOut; ++q) {
      if (!a.per[q]) continue;
      if (e >= L * a.n[q]) {
        e -= L * a.n[q];
        continue;
      }
      const long long l = e / a.n[q], j = e % a.n[q];
      float s = 0.f;
      if (q == 0) {
        s = a.z0w[l * ND + j];
      } else {
        const float* p = a.slab + l * nt * P + a.off[q] + j;
#pragma unroll 4
        for (int t = 0; t < nt; ++t) s += p[t * P];
      }
      a.out[a.o_out[q] + e] = s;
      return;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  long long w = (blockIdx.x - thread_blocks) * (blockDim.x >> 5) +
                (threadIdx.x >> 5);
  for (int q = 0; q < kOut; ++q) {
    if (a.per[q]) continue;
    if (w >= a.n[q]) {
      w -= a.n[q];
      continue;
    }
    // term k: draw k / nt's row tile k % nt (z0bar: draw k)
    const long long terms = q == 0 ? L : (long long)L * nt;
    float s = 0.f;
    for (long long k = lane; k < terms; k += 32)
      s += q == 0 ? a.z0w[k * ND + w] : a.slab[k * P + a.off[q] + w];
    s = warp_sum(s);
    if (lane == 0) a.out[a.o_out[q] + w] = s;
    return;
  }
}

}  // namespace cl
