// Reverse mode (VJP) of the grid-tiled per-step pathwise evaluation in
// pathwise_tiled_fwd.cu, one library call for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_bwd_kernel` of
// vae_gp_ode_tpu/ops/pathwise_tiled.py. It computes what autograd through
// `pathwise_eval_reference` computes for a cotangent g (L, N, K), the same
// function as pathwise_bwd.cu (whose header states the terms), recomputing
// the forward intermediates instead of storing them.
//
// What bounds it on an H100. At the main widths (L=5, N=20, D=K=6, S=256,
// M=100) recompute and VJP are ~6 MFLOP on ~0.6 MB, at the wide shapes
// (D=K=12, S=1024) ~119 MFLOP on ~6.9 MB: 0.2 and 2 us of memory time,
// bound by bytes. In practice a launch is bound by its critical path at
// the main widths (one round trip to memory, one sincosf or expf per
// (row, column or point), three barriers, the dx sums) and by occupancy
// at the wide ones (1080 blocks in waves: bounded to 80 registers, three
// 256-thread blocks fit an SM, 24 warps, without spills; four blocks at
// 64 registers spill).
//
// Design. A 1-D grid of kThreads-thread blocks in two kinds, every block
// kItems columns or inducing points wide and kGroups row groups deep
// (thread (g, i) takes item i and the rows g, g + kGroups, ... of each
// tile of kTile = 20 rows, so N = 20 is one tile):
//  - update blocks (the lowest block indices): one draw, one output dim k
//    and kItems inducing points. Per (row, point) one expf; each thread
//    keeps its point's dnu in a register and its dZ and dls terms in
//    shared memory across the tiles.
//  - prior blocks: one draw and kItems contiguous columns s * K + k of
//    omega's (D, S*K) layout, so loads and stores are coalesced. Per (row,
//    column) one sincosf; domega, dphase and dw are summed over the rows
//    in shared memory and written once per column.
// Every staging loop is unrolled so that its loads go out together (a
// loop over a runtime bound waits a round trip per iteration), and a
// thread's cotangents are loaded beside the rows, so a block waits for
// memory once before it computes; the rows are staged with a stride of D
// rounded up to float4s and read as float4s. Each tile's per-(row, item)
// term (du or dq) goes to shared memory [item][row], and the rows' dx
// terms are a small product over the block's items with lane r of every
// warp on row r and each warp on 8 items: the per-row reads are
// conflict-free, the item rows (omega or Z) broadcasts; then each (row,
// d) adds the 8 warps' terms. Each block writes its dx into its slot of
// the workspace, whose slabs keep the terms of each finished entry last:
// dx (L, N, D, n_slots), dZ (M, D, L, K), dls (K, D, L, n_mc) and dvar's
// shares (K, L, n_chunks + n_mc: 0.5 sum w dw of each prior block, sum nu
// dnu of each update block). A second kernel of the same library call
// (pathwise_tiled_bwd_sum) sums them in a fixed order, a warp per entry of
// dx, dZ and dls reading its contiguous terms and a block per entry of
// dvar, each also over the draws where its operand is shared by all draws
// (stride 0), and domega, dphase, dw and dnu over the draws where theirs
// is. A call costs the host one library call and no PyTorch reductions.
// No atomics: two launches on the same inputs give the same bits. Any N,
// K, S and M is taken (S K up to 2^31 - 1), and D up to what the shared
// memory holds (D <= 65 at the H100's opt-in limit);
// pathwise_tiled_bwd_smem_bytes exports the need so the dispatch rule can
// decide before a launch, and pathwise_tiled_bwd_workspace the workspace
// size, which the launcher checks.
//
// The design it replaced: a (chunk, k, draw) grid of 128-thread blocks
// over 8-row tiles whose dx terms were summed by the (row, d) owners in one
// dependent chain over 128 columns (D-way bank conflicts), with K-strided
// loads, 90 blocks at the main widths, and slab sums in PyTorch.
//
// Accuracy. Accurate sincosf/expf, no fast-math; everything is f32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 64;                  // columns or points per block
constexpr int kGroups = kThreads / kItems;  // row groups
constexpr int kTile = 20;                   // rows per tile
constexpr int kPer = kTile / kGroups;       // rows per thread and tile
constexpr int kPad = kItems + 8;            // row stride of om and zs
constexpr int kSt = kTile + 1;              // item stride of sb, [i][r]
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = kItems / kWarps;     // items per warp in the product
constexpr int kSegs = 8;                    // sums of the second kernel

static_assert(kTile <= 32, "the dx product takes a row per lane");
static_assert(kThreads % kItems == 0,
              "a thread's epilogue entries are its own column's");

struct BwdArgs {
  const float* x;      // (N, D) per draw
  const float* omega;  // (D, S, K)
  const float* phase;  // (1, S, K)
  const float* w;      // (S, K)
  const float* z;      // (M, D)
  const float* nu;     // (K, M)
  const float* ls;     // (K, D)
  const float* var;    // (K,)
  long long x_ls, om_ls, ph_ls, w_ls, z_ls, nu_ls, ls_ls, var_ls;
  const float* g;      // (L, N, K) cotangent of the output
  // workspace, each slab with the terms of one finished entry last
  float* dx_slab;      // (L, N, D, n_slots), n_slots = n_chunks + K n_mc
  float* dz_slab;      // (M, D, L, K)
  float* dls_slab;     // (K, D, L, n_mc)
  float* dv_slab;      // (K, L, n_chunks + n_mc)
  // per-draw cotangents of omega, phase, w and nu: the outputs themselves
  // where the operand has a draw dim, workspace where it is shared
  float *dom_pd, *dph_pd, *dw_pd, *dnu_pd;
  // the finished cotangents, in their operands' shapes
  float *dx, *dom, *dph, *dw, *dz, *dnu, *dls, *dvar;
  int L, N, D, K, S, M, n_chunks, n_mc;
  int seg_blocks[kSegs];  // blocks of each sum of the second kernel
};

// The row stride of the staged rows: D rounded up to whole float4s.
__host__ __device__ inline int pad4(int D) { return (D + 3) & ~3; }

// Shared floats of a prior block and of an update block at state dim D.
__host__ __device__ inline long long prior_floats(int D) {
  return (long long)kTile * pad4(D) + (long long)D * kPad + kItems * kSt +
         (long long)kGroups * (D + 2) * kItems + (long long)kWarps * D * 32;
}

__host__ __device__ inline long long update_floats(int D) {
  return (long long)kTile * pad4(D) + D + (long long)D * kPad +
         kItems * kSt + (long long)kGroups * (2 * D + 1) * kItems +
         (long long)kWarps * D * 32;
}

size_t smem_bytes(int D) {
  const long long p = prior_floats(D), u = update_floats(D);
  return sizeof(float) * (size_t)(p > u ? p : u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stages the rows t0 .. t0 + rows - 1 of x into xs with a row stride of
// pad4(D) (zeros past them and past column D), and loads this thread's
// cotangents g[t0 + r, k] of its rows r = rg + kGroups j into gv; the
// caller's barrier then makes xs visible. The first tile's loads
// go out with the block's other operands, so a block waits for one round
// trip to memory before it computes.
__device__ __forceinline__ void load_tile(const float* x, const float* g,
                                          int t0, int rows, int D, int K,
                                          int k, int rg, float* xs,
                                          float (&gv)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = rg + kGroups * j;
    gv[j] = r < rows ? g[(long long)(t0 + r) * K + k] : 0.f;
  }
  const int Dp = pad4(D);
#pragma unroll 4
  for (int e = threadIdx.x; e < kTile * Dp; e += kThreads) {
    const int r = e / Dp, d = e - r * Dp;
    xs[e] = r < rows && d < D ? x[(long long)(t0 + r) * D + d] : 0.f;
  }
}

// The 4 entries of row r of the staged rows from column d4 (a float4).
__device__ __forceinline__ float4 row4(const float* xs, int Dp, int r,
                                       int d4) {
  return *reinterpret_cast<const float4*>(xs + r * Dp + d4);
}

// The tile's dx terms: red[w][d][r] = sum over warp w's items i of
// sb[i][r] rows[d][i] (prior: omega[d, i]) or sb[i][r] (x[r, d] - Z[i, d])
// (update, Upd), lane r of each warp taking row r, so that sb's reads are
// conflict-free and the item rows' reads are broadcasts. Then thread (r,
// d) adds the warps' terms (times 2 / ls_d^2 for the update, from ils) and
// writes them to its slot of dx_slab.
template <bool Upd>
__device__ __forceinline__ void dx_product(const float* sb, const float* rows_,
                                           const float* xs, const float* ils,
                                           float* red, float* dx, int rows,
                                           int D, int n_slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < rows) {
#pragma unroll 1
    for (int d0 = 0; d0 < D; d0 += 4) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, xr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xr[j] = Upd && d0 + j < D ? xs[lane * pad4(D) + d0 + j] : 0.f;
#pragma unroll
      for (int c = 0; c < kSlice; ++c) {
        const int i = warp * kSlice + c;
        const float sv = sb[i * kSt + lane];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (d0 + j < D)
            acc[j] = fmaf(sv, Upd ? xr[j] - rows_[(d0 + j) * kPad + i]
                                  : rows_[(d0 + j) * kPad + i], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (d0 + j < D) red[(warp * D + d0 + j) * 32 + lane] = acc[j];
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < 32 * D; p += kThreads) {
    const int r = p & 31, d = p >> 5;
    if (r >= rows) continue;
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += red[(w * D + d) * 32 + r];
    dx[((long long)r * D + d) * n_slots] =
        Upd ? 2.f * v * ils[d] * ils[d] : v;
  }
}

// The update term of output dim k for the points mc * kItems ... of draw l.
__device__ void update_block(const BwdArgs& a, int l, int k, int mc,
                             float* smem) {
  __shared__ float dv_warps[2];
  const int D = a.D, N = a.N, K = a.K, M = a.M, L = a.L;
  const int tid = threadIdx.x, i = tid % kItems, rg = tid / kItems;
  const int V = 2 * D + 1;           // per point: dZ terms, dls terms, dnu
  const int Dp = pad4(D);
  float* xs = smem;                  // kTile * Dp     the tile's rows
  float* ils = xs + kTile * Dp;      // D              1 / ls[k, :]
  float* zs = ils + D;               // D * kPad       Z of the points, [d][i]
  float* sb = zs + D * kPad;         // kItems * kSt   dq of the tile, [i][r]
  float* acc = sb + kItems * kSt;    // kGroups * V * kItems
  float* red = acc + kGroups * V * kItems;  // kWarps * D * 32
  const int m0 = mc * kItems;
  const int cnt = min(kItems, M - m0);
  const float* x = a.x + l * a.x_ls;
  const float* z = a.z + l * a.z_ls + (long long)m0 * D;
  const float* g = a.g + (long long)l * N * K;
  const float* ls = a.ls + l * a.ls_ls + (long long)k * D;
  // every load of a staging loop goes out before the first returns: a
  // loop whose bound is a runtime value would otherwise wait for each
#pragma unroll 4
  for (int e = tid; e < kItems * D; e += kThreads) {
    const int p = e / D;
    zs[(e - p * D) * kPad + p] = p < cnt ? z[e] : 0.f;
  }
  for (int v = 0; v < V; ++v) acc[(rg * V + v) * kItems + i] = 0.f;
  const float vk = a.var[l * a.var_ls + k];
  const float nv =
      i < cnt ? a.nu[l * a.nu_ls + (long long)k * M + m0 + i] : 0.f;
  float dnu = 0.f;
  const int n_slots = a.n_chunks + K * a.n_mc;
  float* dx = a.dx_slab + (long long)l * N * D * n_slots + a.n_chunks +
              k * a.n_mc + mc;

  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int rows = min(kTile, N - t0);
    if (t0 > 0) __syncthreads();  // the last tile's product has read xs, sb
    float gv[kPer];
    load_tile(x, g, t0, rows, D, K, k, rg, xs, gv);
    if (t0 == 0)
      for (int d = tid; d < D; d += kThreads) ils[d] = 1.f / ls[d];
    __syncthreads();
    float q[kPer], dq[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) q[j] = 0.f;
#pragma unroll 1
    for (int d4 = 0; d4 < Dp; d4 += 4) {
      float zd[4], il[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        zd[h] = d4 + h < D ? zs[(d4 + h) * kPad + i] : 0.f;
        il[h] = d4 + h < D ? ils[d4 + h] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float4 xv = row4(xs, Dp, rg + kGroups * j, d4);
        const float e0 = (xv.x - zd[0]) * il[0], e1 = (xv.y - zd[1]) * il[1];
        const float e2 = (xv.z - zd[2]) * il[2], e3 = (xv.w - zd[3]) * il[3];
        q[j] = fmaf(e0, e0, fmaf(e1, e1, fmaf(e2, e2, fmaf(e3, e3, q[j]))));
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      // every row: past the tile's, gv is 0 (and the rows zeros), so that
      // the kPer expf chains interleave
      const float kx = vk * expf(-0.5f * q[j]);
      dnu = fmaf(gv[j], kx, dnu);
      dq[j] = -0.5f * kx * gv[j] * nv;
      sb[i * kSt + rg + kGroups * j] = dq[j];
    }
#pragma unroll 1
    for (int d2 = 0; d2 < D; d2 += 2) {   // two columns at a time (float2)
      const float z0 = zs[d2 * kPad + i];
      const float z1 = d2 + 1 < D ? zs[(d2 + 1) * kPad + i] : 0.f;
      float a10 = 0.f, a11 = 0.f, a20 = 0.f, a21 = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float2 xv = *reinterpret_cast<const float2*>(
            xs + (rg + kGroups * j) * Dp + d2);
        const float e0 = xv.x - z0, e1 = xv.y - z1;
        const float t0 = dq[j] * e0, t1 = dq[j] * e1;
        a10 += t0;
        a11 += t1;
        a20 = fmaf(t0, e0, a20);
        a21 = fmaf(t1, e1, a21);
      }
      acc[(rg * V + d2) * kItems + i] += a10;
      acc[(rg * V + D + d2) * kItems + i] += a20;
      if (d2 + 1 < D) {
        acc[(rg * V + d2 + 1) * kItems + i] += a11;
        acc[(rg * V + D + d2 + 1) * kItems + i] += a21;
      }
    }
    __syncthreads();
    // dx[t0 + r, d] = 2 / ls_d^2 sum_m dq[r, m] (x[r, d] - Z[m, d])
    dx_product<true>(sb, zs, xs, ils, red, dx + (long long)t0 * D * n_slots,
                     rows, D, n_slots);
  }

  acc[(rg * V + 2 * D) * kItems + i] = dnu;
  __syncthreads();
  // dnu of the points, and their share of dvar[k] var_k = sum_m nu dnu
  float dv = 0.f;
  if (tid < kItems) {
    float s = 0.f;
    for (int q = 0; q < kGroups; ++q)
      s += acc[(q * V + 2 * D) * kItems + tid];
    if (tid < cnt) {
      a.dnu_pd[((long long)l * K + k) * M + m0 + tid] = s;
      dv = nv * s;
    }
    dv = warp_sum(dv);
    if ((tid & 31) == 0) dv_warps[tid >> 5] = dv;
  }
  // dZ[m, d] of output dim k = -2 / ls_d^2 sum_n dq (x_d - Z_md)
  for (int e = tid; e < cnt * D; e += kThreads) {
    const int p = e / D, d = e % D;
    float s = 0.f;
    for (int q = 0; q < kGroups; ++q) s += acc[(q * V + d) * kItems + p];
    a.dz_slab[(((long long)(m0 + p) * D + d) * L + l) * K + k] =
        -2.f * s * ils[d] * ils[d];
  }
  // dls[k, d] = -2 / ls_d^3 sum_{n, m} dq (x_d - Z_md)^2: a warp per d
  const int lane = tid & 31, warp = tid >> 5;
  for (int d = warp; d < D; d += kWarps) {
    float s = 0.f;
    for (int q = 0; q < kGroups; ++q)
      for (int p = lane; p < kItems; p += 32)
        s += acc[(q * V + D + d) * kItems + p];
    s = warp_sum(s);
    if (lane == 0)
      a.dls_slab[(((long long)k * D + d) * L + l) * a.n_mc + mc] =
          -2.f * s * ils[d] * ils[d] * ils[d];
  }
  __syncthreads();
  if (tid == 0)
    a.dv_slab[((long long)k * L + l) * (a.n_chunks + a.n_mc) + a.n_chunks +
              mc] = dv_warps[0] + dv_warps[1];
}

// The prior term over the columns ch * kItems ... of draw l.
__device__ void prior_block(const BwdArgs& a, int l, int ch, float* smem) {
  const int D = a.D, N = a.N, K = a.K, S = a.S, L = a.L;
  const int SK = S * K;
  const int tid = threadIdx.x, i = tid % kItems, rg = tid / kItems;
  const int V = D + 2;               // per column: domega, dphase, dw
  const int Dp = pad4(D);
  float* xs = smem;                  // kTile * Dp     the tile's rows
  float* om = xs + kTile * Dp;       // D * kPad       omega of the columns
  float* sb = om + D * kPad;         // kItems * kSt   du of the tile, [i][r]
  float* acc = sb + kItems * kSt;    // kGroups * V * kItems
  float* red = acc + kGroups * V * kItems;  // kWarps * D * 32
  const int c0 = ch * kItems;
  const int cnt = min(kItems, SK - c0);
  const bool own = i < cnt;
  const int col = c0 + i;
  const float* omega = a.omega + l * a.om_ls + c0;
#pragma unroll 4
  for (int e = tid; e < D * kItems; e += kThreads) {
    const int d = e / kItems, p = e % kItems;
    om[d * kPad + p] = p < cnt ? omega[(long long)d * SK + p] : 0.f;
  }
  for (int v = 0; v < V; ++v) acc[(rg * V + v) * kItems + i] = 0.f;
  const int k0 = c0 % K;
  const int k = own ? (k0 + i) % K : 0;
  const float ph = own ? a.phase[l * a.ph_ls + col] : 0.f;
  const float wv = own ? a.w[l * a.w_ls + col] : 0.f;
  const float c = sqrtf(a.var[l * a.var_ls + k] / (float)S);
  const float* x = a.x + l * a.x_ls;
  const float* g = a.g + (long long)l * N * K;
  float dwv = 0.f, dphv = 0.f;
  const int n_slots = a.n_chunks + K * a.n_mc;
  float* dx = a.dx_slab + (long long)l * N * D * n_slots + ch;

  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int rows = min(kTile, N - t0);
    if (t0 > 0) __syncthreads();  // the last tile's product has read xs, sb
    float gv[kPer];
    load_tile(x, g, t0, rows, D, K, k, rg, xs, gv);
    __syncthreads();
    float u[kPer], du[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) u[j] = ph;
#pragma unroll 1
    for (int d4 = 0; d4 < Dp; d4 += 4) {
      float o[4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
        o[h] = d4 + h < D ? om[(d4 + h) * kPad + i] : 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float4 xv = row4(xs, Dp, rg + kGroups * j, d4);
        u[j] = fmaf(xv.x, o[0], fmaf(xv.y, o[1], fmaf(xv.z, o[2],
                    fmaf(xv.w, o[3], u[j]))));
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      // every row and column: past the tile's rows gv is 0, past the
      // block's columns w is 0, so that the kPer sincosf chains interleave
      float sn, cs;
      sincosf(u[j], &sn, &cs);
      dwv = fmaf(gv[j], cs, dwv);
      du[j] = -sn * gv[j] * c * wv;
      dphv += du[j];
      sb[i * kSt + rg + kGroups * j] = du[j];
    }
#pragma unroll 1
    for (int d4 = 0; d4 < Dp; d4 += 4) {
      float a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float4 xv = row4(xs, Dp, rg + kGroups * j, d4);
        a1[0] = fmaf(xv.x, du[j], a1[0]);
        a1[1] = fmaf(xv.y, du[j], a1[1]);
        a1[2] = fmaf(xv.z, du[j], a1[2]);
        a1[3] = fmaf(xv.w, du[j], a1[3]);
      }
#pragma unroll
      for (int h = 0; h < 4; ++h)
        if (d4 + h < D) acc[(rg * V + d4 + h) * kItems + i] += a1[h];
    }
    __syncthreads();
    // dx[t0 + r, d] = sum_c du[r, c] omega[d, c]
    dx_product<false>(sb, om, xs, nullptr, red,
                      dx + (long long)t0 * D * n_slots, rows, D, n_slots);
  }

  acc[(rg * V + D) * kItems + i] = dphv;
  acc[(rg * V + D + 1) * kItems + i] = c * dwv;
  __syncthreads();
  float* half_w = sb;                // kItems: 0.5 w dw of each column
  for (int e = tid; e < V * kItems; e += kThreads) {
    const int v = e / kItems, p = e % kItems;
    if (p >= cnt) {
      if (v == D + 1) half_w[p] = 0.f;
      continue;
    }
    float s = 0.f;
    for (int q = 0; q < kGroups; ++q) s += acc[(q * V + v) * kItems + p];
    const long long o = (long long)l * SK + c0 + p;
    if (v < D) {
      a.dom_pd[((long long)l * D + v) * SK + c0 + p] = s;
    } else if (v == D) {
      a.dph_pd[o] = s;
    } else {
      a.dw_pd[o] = s;
      half_w[p] = 0.5f * wv * s;   // p is this thread's column
    }
  }
  __syncthreads();
  // the columns' share of dvar[k] var_k = 0.5 sum_s w dw, for every k
  const int n_sv = a.n_chunks + a.n_mc;
  for (int kk = tid; kk < K; kk += kThreads) {
    float s = 0.f;
    for (int p = (kk - k0 + K) % K; p < cnt; p += K) s += half_w[p];
    a.dv_slab[((long long)kk * L + l) * n_sv + ch] = s;
  }
}

__global__ void __launch_bounds__(kThreads, 3)
    pathwise_tiled_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  int b = blockIdx.x;
  const int n_upd = a.L * a.K * a.n_mc;
  if (b < n_upd) {
    const int mc = b % a.n_mc;
    b /= a.n_mc;
    update_block(a, b / a.K, b % a.K, mc, smem);
  } else {
    b -= n_upd;
    prior_block(a, b / a.n_chunks, b % a.n_chunks, smem);
  }
}

// Entries of sum `seg` of the second kernel: 0 dx, 1 dZ, 2 dls, 3 dvar
// (their terms last in the slabs, summed by a warp or, for dvar, a block
// per entry), 4-7 domega, dphase, dw, dnu (the draws of a shared operand;
// none for one given per draw).
__host__ __device__ inline long long seg_entries(const BwdArgs& a, int seg) {
  const long long L = a.L, D = a.D, K = a.K, M = a.M;
  const long long SK = (long long)a.S * K;
  switch (seg) {
    case 0: return L * a.N * D;
    case 1: return (a.z_ls ? L : 1) * M * D;
    case 2: return (a.ls_ls ? L : 1) * K * D;
    case 3: return (a.var_ls ? L : 1) * K;
    case 4: return a.om_ls ? 0 : D * SK;
    case 5: return a.ph_ls ? 0 : SK;
    case 6: return a.w_ls ? 0 : SK;
    default: return a.nu_ls ? 0 : K * M;
  }
}

// The n contiguous terms of entry e of sum `seg` (0-3) start at the
// returned pointer.
__device__ const float* seg_terms(const BwdArgs& a, int seg, long long e,
                                  long long* n) {
  const long long L = a.L, D = a.D, K = a.K, M = a.M, MD = M * D;
  const long long KD = K * D;
  switch (seg) {
    case 0:
      *n = a.n_chunks + K * a.n_mc;
      return a.dx_slab + e * *n;
    case 1:   // every (l, k) of a shared Z, the k of a per-draw one
      if (!a.z_ls) {
        *n = L * K;
        return a.dz_slab + e * *n;
      }
      *n = K;
      return a.dz_slab + ((e % MD) * L + e / MD) * K;
    case 2:
      if (!a.ls_ls) {
        *n = L * a.n_mc;
        return a.dls_slab + e * *n;
      }
      *n = a.n_mc;
      return a.dls_slab + ((e % KD) * L + e / KD) * a.n_mc;
    default: {
      const long long n_sv = a.n_chunks + a.n_mc;
      if (!a.var_ls) {
        *n = L * n_sv;
        return a.dv_slab + e * *n;
      }
      *n = n_sv;
      return a.dv_slab + ((e % K) * L + e / K) * n_sv;
    }
  }
}

__device__ __forceinline__ float* seg_out(const BwdArgs& a, int seg) {
  switch (seg) {
    case 0: return a.dx;
    case 1: return a.dz;
    case 2: return a.dls;
    case 3: return a.dvar;
    case 4: return a.dom;
    case 5: return a.dph;
    case 6: return a.dw;
    default: return a.dnu;
  }
}

// The finished cotangents from the slabs and per-draw buffers, in a fixed
// order: sums 0-2 give each entry a warp, whose lanes read its contiguous
// terms and meet in a shuffle tree; sum 3 (dvar, a few entries of up to
// L (n_chunks + n_mc) terms) gives each entry a block; sums 4-7 (L terms
// each) give each block 32 entries, a lane each, and split the draws over
// the warps.
__global__ void __launch_bounds__(kThreads)
    pathwise_tiled_bwd_sum_kernel(BwdArgs a) {
  __shared__ float red[kWarps][32];
  int b = blockIdx.x;
  int seg = 0;
  while (seg < kSegs - 1 && b >= a.seg_blocks[seg]) b -= a.seg_blocks[seg++];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_e = seg_entries(a, seg);
  if (seg < 3) {
    const long long e = (long long)b * kWarps + warp;
    if (e >= n_e) return;
    long long n;
    const float* p = seg_terms(a, seg, e, &n);
    float s = 0.f;
#pragma unroll 4
    for (long long t = lane; t < n; t += 32) s += p[t];
    s = warp_sum(s);
    if (lane == 0) seg_out(a, seg)[e] = s;
    return;
  }
  if (seg == 3) {
    long long n;
    const float* p = seg_terms(a, seg, b, &n);
    float s = 0.f;
#pragma unroll 4
    for (long long t = threadIdx.x; t < n; t += kThreads) s += p[t];
    s = warp_sum(s);
    if (lane == 0) red[warp][0] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = 0.f;
      for (int q = 0; q < kWarps; ++q) v += red[q][0];
      const long long l = a.var_ls ? b / a.K : 0;
      a.dvar[b] = v / a.var[l * a.var_ls + b % a.K];
    }
    return;
  }
  // the draws of a shared operand: per-draw buffers (L, n_e)
  const float* src = seg == 4 ? a.dom_pd : seg == 5 ? a.dph_pd
                     : seg == 6 ? a.dw_pd : a.dnu_pd;
  const long long e = (long long)b * 32 + lane;
  float s = 0.f;
  if (e < n_e)
    for (int l = warp; l < a.L; l += kWarps) s += src[l * n_e + e];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < n_e) {
    float v = 0.f;
    for (int q = 0; q < kWarps; ++q) v += red[q][lane];
    seg_out(a, seg)[e] = v;
  }
}

// Floats of the workspace: dx_slab, dz_slab, dls_slab, dv_slab, then the
// per-draw domega, dphase, dw and dnu of the operands that all draws share.
long long workspace_floats(int L, int N, int D, int K, int S, int M,
                           int n_chunks, int n_mc, long long om_ls,
                           long long ph_ls, long long w_ls, long long nu_ls) {
  const long long SK = (long long)S * K;
  return (long long)L * N * D * (n_chunks + (long long)K * n_mc) +
         (long long)M * D * L * K + (long long)K * D * L * n_mc +
         (long long)K * L * (n_chunks + n_mc) +
         (om_ls ? 0 : (long long)L * D * SK) + (ph_ls ? 0 : L * SK) +
         (w_ls ? 0 : L * SK) + (nu_ls ? 0 : (long long)L * K * M);
}

// Prior blocks per draw, and point chunks per (draw, output dim).
int n_chunks_of(int S, int K) {
  return (int)(((long long)S * K + kItems - 1) / kItems);
}
int n_mc_of(int M) { return (M + kItems - 1) / kItems; }

}  // namespace

// Floats of the workspace for these shapes and draw strides (0: shared);
// 0 for shapes the launcher refuses (S K past 2^31 - 1).
extern "C" long long pathwise_tiled_bwd_workspace(
    int L, int N, int D, int K, int S, int M, long long om_ls,
    long long ph_ls, long long w_ls, long long nu_ls) {
  if (L < 1 || N < 1 || D < 1 || K < 1 || S < 1 || M < 1 ||
      (long long)S * K > 0x7fffffffLL)
    return 0;
  return workspace_floats(L, N, D, K, S, M, n_chunks_of(S, K),
                          n_mc_of(M), om_ls, ph_ls, w_ls, nu_ls);
}

// Bytes of shared memory a block needs at state dim D.
extern "C" long long pathwise_tiled_bwd_smem_bytes(int D) {
  return (long long)smem_bytes(D);
}

// The device's opt-in limit of shared memory per block, in bytes (0 if it
// cannot be read).
extern "C" int pathwise_tiled_bwd_smem_optin(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return optin;
}

// Launches the VJP kernel and its sums on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take (a
// workspace size other than pathwise_tiled_bwd_workspace's, shared memory
// above the opt-in limit, a grid past its limit). Operands as in pathwise_tiled_fwd; g is (L, N, K);
// the outputs are dx (L, N, D) and the operands' cotangents in their
// operands' shapes (summed over the draws of a shared operand); every
// entry is written.
extern "C" int pathwise_tiled_bwd(
    const float* x, long long x_ls, const float* omega, long long om_ls,
    const float* phase, long long ph_ls, const float* w, long long w_ls,
    const float* z, long long z_ls, const float* nu, long long nu_ls,
    const float* ls, long long ls_ls, const float* var, long long var_ls,
    const float* g, float* workspace, long long ws_floats, float* dx,
    float* dom, float* dph, float* dw, float* dz, float* dnu, float* dls,
    float* dvar, int L, int N, int D, int K, int S, int M, int device,
    void* stream) {
  const long long need = pathwise_tiled_bwd_workspace(
      L, N, D, K, S, M, om_ls, ph_ls, w_ls, nu_ls);
  if (need == 0 || ws_floats != need) return (int)cudaErrorInvalidValue;
  const int n_chunks = n_chunks_of(S, K), n_mc = n_mc_of(M);
  const long long blocks = (long long)L * (n_chunks + (long long)K * n_mc);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const int optin = pathwise_tiled_bwd_smem_optin(device);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(pathwise_tiled_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }

  BwdArgs a;
  a.x = x; a.omega = omega; a.phase = phase; a.w = w; a.z = z; a.nu = nu;
  a.ls = ls; a.var = var;
  a.x_ls = x_ls; a.om_ls = om_ls; a.ph_ls = ph_ls; a.w_ls = w_ls;
  a.z_ls = z_ls; a.nu_ls = nu_ls; a.ls_ls = ls_ls; a.var_ls = var_ls;
  a.g = g;
  a.L = L; a.N = N; a.D = D; a.K = K; a.S = S; a.M = M;
  a.n_chunks = n_chunks; a.n_mc = n_mc;
  const long long SK = (long long)S * K;
  float* p = workspace;
  a.dx_slab = p;
  p += (long long)L * N * D * (n_chunks + (long long)K * n_mc);
  a.dz_slab = p;
  p += (long long)M * D * L * K;
  a.dls_slab = p;
  p += (long long)K * D * L * n_mc;
  a.dv_slab = p;
  p += (long long)K * L * (n_chunks + n_mc);
  a.dom_pd = om_ls ? dom : p;
  p += om_ls ? 0 : (long long)L * D * SK;
  a.dph_pd = ph_ls ? dph : p;
  p += ph_ls ? 0 : L * SK;
  a.dw_pd = w_ls ? dw : p;
  p += w_ls ? 0 : L * SK;
  a.dnu_pd = nu_ls ? dnu : p;
  a.dx = dx; a.dom = dom; a.dph = dph; a.dw = dw; a.dz = dz; a.dnu = dnu;
  a.dls = dls; a.dvar = dvar;
  long long sum_blocks = 0;
  for (int seg = 0; seg < kSegs; ++seg) {
    const long long n_e = seg_entries(a, seg);
    const long long nb = seg < 3 ? (n_e + kWarps - 1) / kWarps
                         : seg == 3 ? n_e : (n_e + 31) / 32;
    if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    a.seg_blocks[seg] = (int)nb;
    sum_blocks += nb;
  }
  if (sum_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pathwise_tiled_bwd_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pathwise_tiled_bwd_sum_kernel<<<(unsigned)sum_blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
