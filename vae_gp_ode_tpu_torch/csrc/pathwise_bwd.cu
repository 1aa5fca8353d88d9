// Reverse mode (VJP) of the per-step pathwise evaluation in pathwise_fwd.cu,
// one library call for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_pathwise_bwd_kernel` of
// vae_gp_ode_tpu/ops/pathwise.py. It computes what autograd through
// `pathwise_eval_reference` computes for a cotangent g (L, N, K), recomputing
// the forward intermediates instead of storing them. Per output dim k, with
// u = x . omega[:, s, k] + phase[s, k], c = sqrt(var_k / S) and
// q = ((x - Z_m) / ls_k)^2 summed over d:
//
//   du[n, s]   = -sin(u) g[n, k] c w[s, k]
//   dw[s, k]   = c sum_n g[n, k] cos(u)        dphase[s, k] = sum_n du[n, s]
//   domega[d, s, k] = sum_n x[n, d] du[n, s]
//   dq[n, m]   = -0.5 var_k exp(-0.5 q) g[n, k] nu[k, m]
//   dnu[k, m]  = sum_n g[n, k] var_k exp(-0.5 q)
//   dx[n, d]  += sum_s du omega[d, s, k] + sum_m dq 2 (x_d - Z_md) / ls_kd^2
//   dZ[m, d]  -= sum_n dq 2 (x_d - Z_md) / ls_kd^2
//   dls[k, d]  = -sum_{n,m} dq 2 (x_d - Z_md)^2 / ls_kd^3
//   dvar[k]    = (0.5 sum_s w[s, k] dw[s, k] + sum_m nu[k, m] dnu[k, m]) / var_k
//
// It takes the VJP where #10 (pathwise_tiled_bwd.cu), whose blocks keep all
// D of their items in shared memory, does not fit: states wider than D = 65
// (the RBF rk4 steps at --latent_dim 72), and the rounds of the single-block
// pair at the main widths.
//
// What bounds it on an H100. Recompute and VJP are ~6D + 10 operations per
// (row, feature column) and ~12D + 10 per (row, inducing point, output):
// 1.44 GFLOP at L=5, N=20, D=K=72, S=256, M=100, 21.6 us at the f32 peak,
// bound by operations (its ~55 MB of operands and cotangents take 16 us).
// In practice the instruction rate bounds it: every FMA of its products
// (x . omega, x^T du, du omega^T, and their inducing counterparts) reads
// one operand from shared memory, one load per four FMAs.
//
// Design. Of the two designs that were open, clusters of blocks per (draw,
// row tile) as in df_pathwise_bwd.cu, or a grid of column blocks beside
// blocks of inducing points as in pathwise_tiled_bwd.cu (#10), this is the
// grid: at the widths it is for, one draw holds K S = 18,432 feature
// columns and K M = 7,200 (point, output) items, enough blocks to fill the
// card without a cluster, and no (draw, row tile) needs a sum within the
// call that a cluster's distributed shared memory would make cheaper. A 1-D
// grid of kThreads-thread blocks, one item per thread, in two kinds:
//  - update blocks (the lowest block indices): one draw, one output dim k
//    and kItems inducing points;
//  - prior blocks: one draw and kItems contiguous columns c = s K + k of
//    omega's (D, S K) layout, so that every load of omega, phase and w and
//    every store of their cotangents is coalesced across a warp.
// A thread holds kTile = 20 rows of its item in registers (u or q), then
// their du or dq in its own row of shared memory, where the block's dx
// product reads them too: N = 20 is one row tile. The rows sit in shared
// memory (a tile of kTile x D, padded to float4s), read as float4
// broadcasts; a block's Z rows are staged into shared memory [d][point] one
// sub-tile of kDT dims at a time, never read D floats apart by a thread. D is walked in sub-tiles
// of kDT = 16: for each, a thread adds its column's domega terms (or its
// point's dZ and dls terms) over the tile's rows, and the tile's dx terms
// are a small product over the block's items (lane (dd, half) of each warp
// on dim dd and 10 rows, each warp on 32 items; the item's du or dq read as
// float2 broadcasts), the warps' terms added by the block. So per-thread
// registers and shared memory hold a fixed number of dims whatever D is,
// apart from the tile of rows (kTile x D) and 1/ls (D). With one row tile a
// thread keeps its du or dq across the sub-tiles and writes each cotangent
// once. With more, the sub-tiles go in passes of kDA dims, each pass over
// all row tiles, recomputing u or q, with the pass's terms in shared memory
// (2 kDA floats an item), so nothing grows with D either; a cotangent is
// still written once. D is taken up to kMaxD = 1,024 (the tile of rows and
// 1/ls then take 84 KB, the block 151 KB); the library refuses wider.
//
// The owner of a column writes its domega, dphase and dw once, the owner of
// a (point, k) item its dnu once. Whatever crosses blocks is summed by a
// second kernel of the same library call (pathwise_bwd_sum) in a fixed
// order: dx over the blocks' slots (each block's terms of its rows in slot
// `chunk` or `n_chunks + k n_mc + point chunk` of dx_slab (L, n_slots, N,
// D)), dZ over k (dz_slab (L, K, D, M), a term per item), dls over the point
// chunks (dls_slab (L, K, D, n_mc), each block's sum over its items), dvar
// over the blocks' shares (dv_slab (K, L, n_chunks + n_mc): 0.5 sum w dw of
// a prior block's columns of each k, sum nu dnu of an update block's
// points), and each of them, and domega, dphase, dw and dnu, over the draws
// where its operand is shared by all draws (stride 0).
// So the call returns the cotangents in their operands' shapes and costs
// the host one library call and no PyTorch reductions. No atomics: two
// launches on the same inputs give the same bits. Any N, K, S and M is
// taken (S K up to 2^31 - 1); pathwise_bwd_workspace exports the size of
// the workspace, which the launcher checks.
//
// Accuracy. Accurate sincosf/expf, no fast-math; everything is f32. Three
// sums are ordered so that none rounds at a size far above its terms': x .
// omega is summed from 0 and the phase added last (a chain started at the
// phase put the prior's cotangents ~3x farther from float64 than the plain
// version), q takes its terms four dims at a time (its D terms are all >=
// 0), and dw, dphase and dnu are summed over each row tile, then over the
// tiles.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = kThreads;           // columns or points per block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 20;                  // rows per tile
constexpr int kDT = 16;                    // dims per sub-tile
constexpr int kHalf = 32 / kDT;            // row groups of the dx product
constexpr int kHRows = kTile / kHalf;      // rows of a lane in the product
constexpr int kDA = 32;                    // dims per pass over row tiles
constexpr int kIP = kItems + 1;            // item stride of [d][item] tables
constexpr int kMaxD = 1024;
constexpr int kSumThreads = 256;
constexpr int kParts = 16;                 // threads per entry of a long sum
constexpr int kLanes = kSumThreads / kParts;   // entries per block
constexpr int kSegs = 8;                   // sums of the second kernel

static_assert(kItems == 32 * kWarps, "a warp takes 32 items of the product");
static_assert(kTile % kHalf == 0 && kHRows % 2 == 0,
              "the product reads a lane's rows as float2s");
static_assert(kTile % 4 == 0, "an item's terms are read as float4s");
static_assert(kDA % kDT == 0 && kDT % 4 == 0,
              "a pass is whole sub-tiles of whole float4s");

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
  // workspace
  float* dx_slab;      // (L, n_slots, N, D), n_slots = n_chunks + K n_mc
  float* dz_slab;      // (L, K, D, M)
  float* dls_slab;     // (L, K, D, n_mc)
  float* dv_slab;      // (K, L, n_chunks + n_mc) dvar's shares of blocks
  // per-draw cotangents of omega, phase, w and nu: the outputs themselves
  // where the operand has a draw dim, workspace where it is shared
  float *dom_pd, *dph_pd, *dw_pd, *dnu_pd;
  // the finished cotangents, in their operands' shapes
  float *dx, *dom, *dph, *dw, *dz, *dnu, *dls, *dvar;
  int L, N, D, K, S, M, n_chunks, n_mc, n_rt;
  int seg_blocks[kSegs];  // blocks of each sum of the second kernel
};

// The row stride of the staged rows: D rounded up to whole float4s.
__host__ __device__ inline int pad4(int D) { return (D + 3) & ~3; }

// Shared floats of a block: the tile's du or dq [item][row], the warps'
// dx terms, the sub-tile's omega or Z [d][item], the dls terms [d][item],
// the rows, 1/ls, and with more than one row tile a pass's terms.
__host__ __device__ inline long long smem_floats(int D, int n_rt) {
  return (long long)kItems * kTile + kWarps * kTile * kDT + 2 * kDT * kIP +
         (long long)(kTile + 1) * pad4(D) + (n_rt > 1 ? 2 * kDA * kIP : 0);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Smem {
  float *sb, *red, *tab, *lbuf, *xs, *ils, *acc;
};

__device__ __forceinline__ Smem carve(float* smem, int D) {
  Smem s;
  s.sb = smem;                           // kItems * kTile
  s.red = s.sb + kItems * kTile;         // kWarps * kTile * kDT
  s.tab = s.red + kWarps * kTile * kDT;  // kDT * kIP
  s.lbuf = s.tab + kDT * kIP;            // kDT * kIP
  s.xs = s.lbuf + kDT * kIP;             // kTile * pad4(D)
  s.ils = s.xs + kTile * pad4(D);        // pad4(D)
  s.acc = s.ils + pad4(D);               // 2 * kDA * kIP, more than one tile
  return s;
}

// Stages the rows t0 .. t0 + rows - 1 of x into xs, row stride pad4(D),
// zeros past them and past column D.
__device__ __forceinline__ void stage_rows(const float* x, int t0, int rows,
                                           int D, float* xs) {
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

// The tile's dx terms of dims d0 .. d0 + kDT - 1: red[w][r][dd] = sum over
// warp w's 32 items i of sb[i][r] tab[dd][i] (prior: omega) or sb[i][r]
// (x[r, d0 + dd] - tab[dd][i]) (update, Upd: Z). Lane (dd, h) takes dim dd
// and rows h kHRows ..; tab's reads are conflict-free, sb's broadcasts.
template <bool Upd>
__device__ __forceinline__ void dx_terms(const Smem& s, int Dp, int d0,
                                         int nd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dd = lane % kDT, r0 = lane / kDT * kHRows;
  float acc[kHRows], xr[kHRows];
#pragma unroll
  for (int j = 0; j < kHRows; ++j) {
    acc[j] = 0.f;
    xr[j] = Upd && dd < nd ? s.xs[(r0 + j) * Dp + d0 + dd] : 0.f;
  }
#pragma unroll 2
  for (int c = 0; c < 32; ++c) {
    const int i = warp * 32 + c;
    const float t = s.tab[dd * kIP + i];
    const float2* s2 = reinterpret_cast<const float2*>(s.sb + i * kTile + r0);
#pragma unroll
    for (int j = 0; j < kHRows / 2; ++j) {
      const float2 v = s2[j];
      acc[2 * j] = fmaf(v.x, Upd ? xr[2 * j] - t : t, acc[2 * j]);
      acc[2 * j + 1] = fmaf(v.y, Upd ? xr[2 * j + 1] - t : t, acc[2 * j + 1]);
    }
  }
#pragma unroll
  for (int j = 0; j < kHRows; ++j)
    s.red[(warp * kTile + r0 + j) * kDT + dd] = acc[j];
}

// Adds the warps' dx terms of the tile's rows and dims d0 .. d0 + nd - 1
// (times 2 / ls_d^2 from ils for the update) and writes them to this
// block's slot of dx_slab (dxs: its rows t0 ..).
__device__ __forceinline__ void dx_store(const Smem& s, const float* ils,
                                         float* dxs, int rows, int D, int d0,
                                         int nd) {
  for (int e = threadIdx.x; e < kTile * kDT; e += kThreads) {
    const int r = e / kDT, dd = e % kDT;
    if (r >= rows || dd >= nd) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s.red[(w * kTile + r) * kDT + dd];
    if (ils) v *= 2.f * ils[d0 + dd] * ils[d0 + dd];
    dxs[(long long)r * D + d0 + dd] = v;
  }
}

// A term of a pass over several row tiles: the sum so far plus v, kept in
// acc until the last tile returns it; one tile: v itself.
__device__ __forceinline__ float carry(float* acc, int idx, float v, int rt,
                                       int n_rt) {
  if (n_rt == 1) return v;
  if (rt > 0) v += acc[idx];
  if (rt < n_rt - 1) acc[idx] = v;
  return v;
}

// The prior term over the columns ch * kItems ... of draw l.
__device__ void prior_block(const BwdArgs& a, int l, int ch, float* smem) {
  const int D = a.D, N = a.N, K = a.K, S = a.S, n_rt = a.n_rt;
  const long long SK = (long long)S * K;
  const int Dp = pad4(D), tid = threadIdx.x;
  const Smem s = carve(smem, D);
  const long long col = (long long)ch * kItems + tid;
  const bool own = col < SK;
  const int k = own ? (int)(col % K) : 0;
  const float* om = a.omega + l * a.om_ls + (own ? col : 0);
  const float ph = own ? a.phase[l * a.ph_ls + col] : 0.f;
  const float wv = own ? a.w[l * a.w_ls + col] : 0.f;
  const float cv = sqrtf(a.var[l * a.var_ls + k] / (float)S);
  const float* x = a.x + l * a.x_ls;
  const float* g = a.g + (long long)l * N * K + k;
  const int n_slots = a.n_chunks + K * a.n_mc;
  float* dxs = a.dx_slab + ((long long)l * n_slots + ch) * N * D;
  float* dom = a.dom_pd + (long long)l * D * SK + (own ? col : 0);
  const int W = n_rt == 1 ? D : kDA;   // dims of a pass
  const float* mine = s.sb + tid * kTile;   // this column's du
  float dwv = 0.f, dphv = 0.f;

  for (int p0 = 0; p0 < D; p0 += W) {
    const int p1 = min(D, p0 + W);
    for (int rt = 0; rt < n_rt; ++rt) {
      const int t0 = rt * kTile, rows = min(kTile, N - t0);
      if (p0 == 0 || n_rt > 1) {
        __syncthreads();   // the last sub-tile has read xs
        stage_rows(x, t0, rows, D, s.xs);
        __syncthreads();
        // x . omega from 0, the phase added last (see Accuracy above)
        float u[kTile];
#pragma unroll
        for (int r = 0; r < kTile; ++r) u[r] = 0.f;
#pragma unroll 2
        for (int d4 = 0; d4 < Dp; d4 += 4) {
          float o[4];
#pragma unroll
          for (int h = 0; h < 4; ++h)
            o[h] = own && d4 + h < D ? __ldg(om + (d4 + h) * SK) : 0.f;
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            const float4 xv = row4(s.xs, Dp, r, d4);
            u[r] = fmaf(xv.x, o[0], fmaf(xv.y, o[1], fmaf(xv.z, o[2],
                        fmaf(xv.w, o[3], u[r]))));
          }
        }
        // du of the tile's rows, kept in this column's row of sb (the
        // last product has read sb: the barrier above); dw and dphase
        // summed over the tile, then over the tiles
        float tw = 0.f, tph = 0.f;
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          // past the tile's rows g is 0, past the columns w: du is 0
          const float gv = r < rows ? g[(long long)(t0 + r) * K] : 0.f;
          float sn, cs;
          sincosf(u[r] + ph, &sn, &cs);
          const float du = -sn * gv * cv * wv;
          s.sb[tid * kTile + r] = du;
          tw = fmaf(gv, cs, tw);
          tph += du;
        }
        if (p0 == 0) {
          dwv += tw;
          dphv += tph;
        }
      }
      for (int d0 = p0; d0 < p1; d0 += kDT) {
        const int nd = min(kDT, p1 - d0);
        __syncthreads();   // the last product has read sb, tab and red
#pragma unroll
        for (int dd = 0; dd < kDT; ++dd)
          s.tab[dd * kIP + tid] =
              own && dd < nd ? __ldg(om + (d0 + dd) * SK) : 0.f;
        // domega[d, col] = sum_n x[n, d] du[n]
        for (int q4 = 0; q4 < nd; q4 += 4) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int r4 = 0; r4 < kTile; r4 += 4) {
            const float4 dv = *reinterpret_cast<const float4*>(mine + r4);
            const float du[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 xv = row4(s.xs, Dp, r4 + j, d0 + q4);
              t[0] = fmaf(xv.x, du[j], t[0]);
              t[1] = fmaf(xv.y, du[j], t[1]);
              t[2] = fmaf(xv.z, du[j], t[2]);
              t[3] = fmaf(xv.w, du[j], t[3]);
            }
          }
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int d = d0 + q4 + h;
            if (q4 + h >= nd) break;
            const float v = carry(s.acc, (d - p0) * kIP + tid, t[h], rt, n_rt);
            if (own && rt == n_rt - 1) dom[d * SK] = v;
          }
        }
        __syncthreads();
        dx_terms<false>(s, Dp, d0, nd);
        __syncthreads();
        dx_store(s, nullptr, dxs + (long long)t0 * D, rows, D, d0, nd);
      }
    }
  }
  if (own) {
    a.dph_pd[l * SK + col] = dphv;
    a.dw_pd[l * SK + col] = cv * dwv;
  }
  // the columns' share of dvar[k] var_k = 0.5 sum_s w dw, for every k
  __syncthreads();   // the last product has read sb
  s.sb[tid] = own ? 0.5f * wv * cv * dwv : 0.f;
  __syncthreads();
  const int k0 = (int)((long long)ch * kItems % K);
  const int n_sv = a.n_chunks + a.n_mc;
  for (int kk = tid; kk < K; kk += kThreads) {
    float v = 0.f;
    for (int i = (kk - k0 + K) % K; i < kItems; i += K) v += s.sb[i];
    a.dv_slab[((long long)kk * a.L + l) * n_sv + ch] = v;
  }
}

// Stages Z of the block's points (cnt of them, from z) for dims d0 ..
// d0 + kDT - 1 into tab [dd][point], zeros past them and past D.
__device__ __forceinline__ void stage_z(const float* z, int cnt, int D,
                                        int d0, float* tab) {
#pragma unroll 4
  for (int e = threadIdx.x; e < kItems * kDT; e += kThreads) {
    const int p = e / kDT, dd = e % kDT;
    tab[dd * kIP + p] =
        p < cnt && d0 + dd < D ? z[(long long)p * D + d0 + dd] : 0.f;
  }
}

// The update term of output dim k for the points mc * kItems ... of draw l.
__device__ void update_block(const BwdArgs& a, int l, int k, int mc,
                             float* smem) {
  const int D = a.D, N = a.N, K = a.K, M = a.M, n_rt = a.n_rt;
  const int Dp = pad4(D), tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const Smem s = carve(smem, D);
  const int m0 = mc * kItems;
  const int cnt = min(kItems, M - m0);
  const bool own = tid < cnt;
  const float* x = a.x + l * a.x_ls;
  const float* z = a.z + l * a.z_ls + (long long)m0 * D;
  const float* ls = a.ls + l * a.ls_ls + (long long)k * D;
  const float* g = a.g + (long long)l * N * K + k;
  for (int d = tid; d < Dp; d += kThreads) s.ils[d] = d < D ? 1.f / ls[d] : 0.f;
  const float vk = a.var[l * a.var_ls + k];
  const float nv = own ? a.nu[l * a.nu_ls + (long long)k * M + m0 + tid] : 0.f;
  const int n_slots = a.n_chunks + K * a.n_mc;
  float* dxs = a.dx_slab +
               ((long long)l * n_slots + a.n_chunks + k * a.n_mc + mc) * N * D;
  float* dz = a.dz_slab + ((long long)l * K + k) * D * M + m0 + tid;
  float* dls = a.dls_slab + ((long long)l * K + k) * D * a.n_mc + mc;
  const int W = n_rt == 1 ? D : kDA;   // dims of a pass
  const float* mine = s.sb + tid * kTile;   // this point's dq
  float dnu = 0.f;
  int staged = -1;                     // the dims of Z in tab

  for (int p0 = 0; p0 < D; p0 += W) {
    const int p1 = min(D, p0 + W);
    for (int rt = 0; rt < n_rt; ++rt) {
      const int t0 = rt * kTile, rows = min(kTile, N - t0);
      if (p0 == 0 || n_rt > 1) {
        float q[kTile];
#pragma unroll
        for (int r = 0; r < kTile; ++r) q[r] = 0.f;
        __syncthreads();   // the last sub-tile has read xs and tab
        stage_rows(x, t0, rows, D, s.xs);
        for (int d0 = 0; d0 < D; d0 += kDT) {
          if (d0 != staged) {
            if (d0 > 0) __syncthreads();   // the last dims' reads of tab
            stage_z(z, cnt, D, d0, s.tab);
            staged = d0;
          }
          __syncthreads();
          for (int q4 = 0; q4 < min(kDT, D - d0); q4 += 4) {
            float zd[4], il[4];
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              zd[h] = s.tab[(q4 + h) * kIP + tid];
              il[h] = s.ils[d0 + q4 + h];   // 0 past D
            }
#pragma unroll
            for (int r = 0; r < kTile; ++r) {
              const float4 xv = row4(s.xs, Dp, r, d0 + q4);
              const float e0 = (xv.x - zd[0]) * il[0];
              const float e1 = (xv.y - zd[1]) * il[1];
              const float e2 = (xv.z - zd[2]) * il[2];
              const float e3 = (xv.w - zd[3]) * il[3];
              // four dims' terms, then onto q
              q[r] += fmaf(e0, e0, fmaf(e1, e1, fmaf(e2, e2, e3 * e3)));
            }
          }
        }
        // dq of the tile's rows, kept in this point's row of sb (the last
        // product has read sb: the barrier above the rows' staging); dnu
        // summed over the tile, then over the tiles
        float tn = 0.f;
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          // past the tile's rows g is 0, past the points nu: dq is 0
          const float gv = r < rows ? g[(long long)(t0 + r) * K] : 0.f;
          const float kx = vk * expf(-0.5f * q[r]);
          tn = fmaf(gv, kx, tn);
          s.sb[tid * kTile + r] = -0.5f * kx * gv * nv;
        }
        if (p0 == 0) dnu += tn;
      }
      const bool last = rt == n_rt - 1;
      for (int d0 = p0; d0 < p1; d0 += kDT) {
        const int nd = min(kDT, p1 - d0);
        __syncthreads();   // the last product has read sb, tab, red, lbuf
        if (d0 != staged) {
          stage_z(z, cnt, D, d0, s.tab);
          staged = d0;
        }
        __syncthreads();
        // dZ[m, d] of output dim k = -2 / ls_d^2 sum_n dq (x_d - Z_md) and
        // this point's dls terms sum_n dq (x_d - Z_md)^2
        for (int q4 = 0; q4 < nd; q4 += 4) {
          float zd[4], tz[4] = {0.f, 0.f, 0.f, 0.f};
          float tl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 4; ++h) zd[h] = s.tab[(q4 + h) * kIP + tid];
#pragma unroll
          for (int r4 = 0; r4 < kTile; r4 += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(mine + r4);
            const float dq[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 xv = row4(s.xs, Dp, r4 + j, d0 + q4);
              const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                const float e = xr[h] - zd[h];
                tz[h] = fmaf(dq[j], e, tz[h]);
                tl[h] = fmaf(dq[j] * e, e, tl[h]);
              }
            }
          }
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int d = d0 + q4 + h;
            if (q4 + h >= nd) break;
            const int idx = (d - p0) * kIP + tid;
            const float vz = carry(s.acc, idx, tz[h], rt, n_rt);
            const float vl = carry(s.acc, idx + kDA * kIP, tl[h], rt, n_rt);
            if (last) {
              const float il = s.ils[d];
              if (own) dz[(long long)d * M] = -2.f * vz * il * il;
              s.lbuf[(q4 + h) * kIP + tid] = own ? vl : 0.f;
            }
          }
        }
        dx_terms<true>(s, Dp, d0, nd);
        __syncthreads();
        // dx[t0 + r, d] = 2 / ls_d^2 sum_m dq[r, m] (x[r, d] - Z[m, d])
        dx_store(s, s.ils, dxs + (long long)t0 * D, rows, D, d0, nd);
        if (last) {
          // dls[k, d] = -2 / ls_d^3 sum_{n, m} dq (x_d - Z_md)^2: a warp
          // per d over the block's points
          for (int dd = warp; dd < nd; dd += kWarps) {
            float v = 0.f;
            for (int i = lane; i < kItems; i += 32)
              v += s.lbuf[dd * kIP + i];
            v = warp_sum(v);
            const float il = s.ils[d0 + dd];
            if (lane == 0)
              dls[(long long)(d0 + dd) * a.n_mc] = -2.f * v * il * il * il;
          }
        }
      }
    }
  }
  if (own) a.dnu_pd[((long long)l * K + k) * M + m0 + tid] = dnu;
  // the points' share of dvar[k] var_k = sum_m nu dnu, the warps in order
  const float dv = warp_sum(nv * dnu);
  __syncthreads();   // the last sums have read lbuf
  if (lane == 0) s.lbuf[warp] = dv;
  __syncthreads();
  if (tid == 0) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) v += s.lbuf[q];
    a.dv_slab[((long long)k * a.L + l) * (a.n_chunks + a.n_mc) +
              a.n_chunks + mc] = v;
  }
}

__global__ void __launch_bounds__(kThreads) pathwise_bwd_kernel(BwdArgs a) {
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

// Entries of sum `seg` of the second kernel: 0 dx, 1 dZ, 2 dls, 3 dvar,
// 4-7 domega, dphase, dw, dnu over the draws of a shared operand (none for
// one given per draw).
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

// Entries of sum `seg` per block of the second kernel: kLanes entries of
// kParts parts each for the sums over many terms (0-2), one entry a block
// for dvar (3), a thread per entry for the draws (4-7).
__host__ __device__ inline long long seg_per_block(int seg) {
  return seg < 3 ? kLanes : seg == 3 ? 1 : kSumThreads;
}

// Term t of entry e of sum `seg` (0-2); n: the entry's number of terms.
__device__ __forceinline__ const float* seg_terms(const BwdArgs& a, int seg,
                                                  long long e, long long* n,
                                                  long long* stride,
                                                  float** dst) {
  const long long L = a.L, N = a.N, D = a.D, K = a.K, M = a.M;
  if (seg == 0) {
    // dx[l, n, d] over the slots
    *n = a.n_chunks + K * a.n_mc;
    *stride = N * D;
    *dst = a.dx + e;
    return a.dx_slab + e / (N * D) * *n * N * D + e % (N * D);
  }
  if (seg == 1) {
    // dZ[(l,) m, d] over ((l,) k); entries in (l, d, m) order, so that a
    // warp's reads of dz_slab are contiguous
    const long long lz = e / (D * M), d = e / M % D, m = e % M;
    *n = a.z_ls ? K : L * K;
    *stride = D * M;
    *dst = a.dz + (lz * M + m) * D + d;
    return a.dz_slab + (lz * K * D + d) * M + m;
  }
  // dls[(l,) k, d] over ((l,) point chunks)
  const long long lz = e / (K * D), kd = e % (K * D);
  *n = a.ls_ls ? a.n_mc : L * a.n_mc;
  *stride = 1;
  *dst = a.dls + e;
  if (a.ls_ls) return a.dls_slab + (lz * K * D + kd) * a.n_mc;
  // a shared ls: term (l, chunk) at l K D n_mc + kd n_mc + chunk
  return a.dls_slab + kd * a.n_mc;
}

// The finished cotangents from the slabs and the per-draw buffers, each
// entry's terms added in a fixed order: sums 0-2 give each entry kParts
// threads that take every kParts-th term (so a warp reads kLanes entries'
// same term, contiguous, and no thread waits on a long chain) and then add
// the parts in order; dvar gives each entry a block over its blocks'
// shares, contiguous in dv_slab; the draws' sums give a thread per entry.
__global__ void __launch_bounds__(kSumThreads)
    pathwise_bwd_sum_kernel(BwdArgs a) {
  __shared__ float part[kParts][kLanes];
  int b = blockIdx.x;
  int seg = 0;
  while (seg < kSegs - 1 && b >= a.seg_blocks[seg]) b -= a.seg_blocks[seg++];
  const long long L = a.L, K = a.K;
  const long long n_e = seg_entries(a, seg);
  const int tid = threadIdx.x;
  if (seg < 3) {
    const int j = tid % kLanes, p = tid / kLanes;
    const long long e = (long long)b * kLanes + j;
    float v = 0.f;
    float* dst = nullptr;
    if (e < n_e) {
      long long n = 0, stride = 0;
      const float* src = seg_terms(a, seg, e, &n, &stride, &dst);
      if (seg == 2 && !a.ls_ls) {
        // a shared ls: the terms of draw l are K D n_mc floats apart
        const long long KDn = K * a.D * a.n_mc;
        for (long long t = p; t < n; t += kParts)
          v += src[t / a.n_mc * KDn + t % a.n_mc];
      } else {
#pragma unroll 4
        for (long long t = p; t < n; t += kParts) v += src[t * stride];
      }
    }
    part[p][j] = v;
    __syncthreads();
    if (p == 0 && e < n_e) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kParts; ++q) s += part[q][j];
      *dst = s;
    }
    return;
  }
  if (seg == 3) {
    // dvar[(l,) k] var_k = the shares of the (l,) blocks: a block per
    // entry, then its warps in order
    const long long e = b;
    const int k = (int)(e % K), lane = tid & 31, warp = tid >> 5;
    const long long lz = e / K, n_sv = a.n_chunks + a.n_mc;
    const float* src = a.dv_slab + ((long long)k * L + (a.var_ls ? lz : 0)) *
                                       n_sv;
    const long long n = (a.var_ls ? 1 : L) * n_sv;
    float v = 0.f;
    for (long long t = tid; t < n; t += kSumThreads) v += src[t];
    v = warp_sum(v);
    if (lane == 0) part[0][warp] = v;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int q = 0; q < kSumThreads / 32; ++q) s += part[0][q];
      a.dvar[e] = s / a.var[lz * a.var_ls + k];
    }
    return;
  }
  const long long e = (long long)b * kSumThreads + tid;
  if (e >= n_e) return;
  const float* src = seg == 4 ? a.dom_pd : seg == 5 ? a.dph_pd
                     : seg == 6 ? a.dw_pd : a.dnu_pd;
  float v = 0.f;
  for (long long l = 0; l < L; ++l) v += src[l * n_e + e];
  (seg == 4 ? a.dom : seg == 5 ? a.dph : seg == 6 ? a.dw : a.dnu)[e] = v;
}

// Prior blocks per draw, and point chunks per (draw, output dim).
long long n_chunks_of(int S, int K) {
  return ((long long)S * K + kItems - 1) / kItems;
}
int n_mc_of(int M) { return (M + kItems - 1) / kItems; }

// Floats of the workspace: dx_slab, dz_slab, dls_slab, dv_slab, then the
// per-draw domega, dphase, dw and dnu of the operands that all draws share.
long long workspace_floats(int L, int N, int D, int K, int S, int M,
                           long long om_ls, long long ph_ls, long long w_ls,
                           long long nu_ls) {
  const long long SK = (long long)S * K, n_mc = n_mc_of(M);
  return (long long)L * N * D * (n_chunks_of(S, K) + K * n_mc) +
         (long long)L * K * D * M + (long long)L * K * D * n_mc +
         (long long)K * L * (n_chunks_of(S, K) + n_mc) +
         (om_ls ? 0 : (long long)L * D * SK) + (ph_ls ? 0 : L * SK) +
         (w_ls ? 0 : L * SK) + (nu_ls ? 0 : (long long)L * K * M);
}

}  // namespace

// The widest state dim D the library takes.
extern "C" int pathwise_bwd_max_dim() { return kMaxD; }

// Floats of the workspace for these shapes and draw strides (0: shared);
// 0 for shapes the launcher refuses (D above pathwise_bwd_max_dim, S K past
// 2^31 - 1).
extern "C" long long pathwise_bwd_workspace(int L, int N, int D, int K, int S,
                                            int M, long long om_ls,
                                            long long ph_ls, long long w_ls,
                                            long long nu_ls) {
  if (L < 1 || N < 1 || D < 1 || K < 1 || S < 1 || M < 1 || D > kMaxD ||
      (long long)S * K > 0x7fffffffLL)
    return 0;
  return workspace_floats(L, N, D, K, S, M, om_ls, ph_ls, w_ls, nu_ls);
}

// Launches the VJP kernel and its sums on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take (a
// workspace size other than pathwise_bwd_workspace's, shared memory above
// the opt-in limit, a grid past its limit). Operands as in pathwise_fwd; g
// is (L, N, K); the outputs are dx (L, N, D) and the operands' cotangents in
// their operands' shapes (summed over the draws of a shared operand); every
// entry is written.
extern "C" int pathwise_bwd(
    const float* x, long long x_ls, const float* omega, long long om_ls,
    const float* phase, long long ph_ls, const float* w, long long w_ls,
    const float* z, long long z_ls, const float* nu, long long nu_ls,
    const float* ls, long long ls_ls, const float* var, long long var_ls,
    const float* g, float* workspace, long long ws_floats, float* dx,
    float* dom, float* dph, float* dw, float* dz, float* dnu, float* dls,
    float* dvar, int L, int N, int D, int K, int S, int M, int device,
    void* stream) {
  const long long need = pathwise_bwd_workspace(L, N, D, K, S, M, om_ls,
                                                ph_ls, w_ls, nu_ls);
  if (need == 0 || ws_floats != need) return (int)cudaErrorInvalidValue;
  const long long n_chunks = n_chunks_of(S, K);
  const int n_mc = n_mc_of(M), n_rt = (N + kTile - 1) / kTile;
  const long long blocks = (long long)L * (n_chunks + (long long)K * n_mc);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)smem_floats(D, n_rt);
  if (smem > 48 * 1024) {
    int optin = 0;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(pathwise_bwd_kernel,
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
  a.n_chunks = (int)n_chunks; a.n_mc = n_mc; a.n_rt = n_rt;
  const long long SK = (long long)S * K;
  float* p = workspace;
  a.dx_slab = p;
  p += (long long)L * N * D * (n_chunks + (long long)K * n_mc);
  a.dz_slab = p;
  p += (long long)L * K * D * M;
  a.dls_slab = p;
  p += (long long)L * K * D * n_mc;
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
    const long long per = seg_per_block(seg);
    const long long nb = (n_e + per - 1) / per;
    if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    a.seg_blocks[seg] = (int)nb;
    sum_blocks += nb;
  }
  if (sum_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pathwise_bwd_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pathwise_bwd_sum_kernel<<<(unsigned)sum_blocks, kSumThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
