// Reverse mode (VJP) of the grid-tiled per-step DF pathwise evaluation in
// df_pathwise_tiled_fwd.cu, one launch for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_bwd_kernel` of
// vae_gp_ode_tpu/ops/df_pathwise_tiled.py. It computes what autograd
// through `df_pathwise_reference` computes for a cotangent g (L, N, D), the
// same function as df_pathwise_bwd.cu (whose item loop states the terms),
// recomputing the forward intermediates, with the DF
// quirks kept (unscaled distances, the (D, D) ls2 envelope, the
// ((D - 1) - r2 / ls2) diagonal, nu points-major).
//
// What bounds it on an H100. At the wide shapes (L=5, N=20, D=12,
// SD = 12288, M=100) recompute and VJP are ~319 MFLOP on ~18 MB of operands
// and cotangents: ~5.4 us of memory time, bound by bytes on paper. In
// practice the issue rate bounds it: one sincosf and ~8D FMAs per (row,
// feature column), and one expf and ~35 FMAs per (row, inducing point,
// output pair (j, i)), 1.4 M of each at those shapes.
//
// Design. A 1-D grid of blocks of kThreads threads, in two kinds:
//  - update blocks (the lowest block indices, so their chains start first
//    and overlap the chunk blocks): one draw, kUpdRows batch rows and
//    kThreads / D inducing points. Thread (m, i) owns point m and output
//    column i; for each row it walks the D columns j with the loop
//    unrolled for the D it is built for (instances D = 6, 12 and a generic
//    one with guards up to 16), so every per-j array stays in registers.
//    It keeps its share of dnur[m, :], dZ[m, :], the ls2 column i and var_i
//    cotangents in registers; each row's dx terms go through warp shuffles.
//    At the end the D threads of a point and the block's points meet in
//    shared memory, and the block writes dZ and dnur of its points and its
//    dls2/dvar partial into the slab `upd` (L, n_rt, 2 M D + n_mc (D^2 + D))
//    at its row tile rt, and its rows' dx into dx_slab slot mc.
//  - chunk blocks: one draw and kChunk ORFF feature columns, one per thread,
//    for all N rows in tiles of kRows. One sincosf per (row, column); domf,
//    dphf and the chunk's rows of dG (cos and sin halves) are summed over
//    the rows in registers and written once. Each tile's du goes to shared
//    memory and dx = du . omf^T is a small product over the chunk's columns
//    (two threads per (row, d), float4 reads of the padded rows, one
//    shuffle), written into dx_slab slot n_mc + chunk.
// dx_slab is (L, n_mc + n_chunks, N, D). A second kernel of the same launch
// (a thread per dx entry, a warp per other entry, in a fixed order) sums
// dx_slab over its slots into dx, upd over its row tiles into dZ and dnur,
// and the dls2/dvar partials over the row tiles and point chunks, each also
// over the draws where its operand is shared by all draws (stride 0); so a
// call costs the host one library call and no PyTorch reductions. No
// atomics: two launches on the same inputs give the same bits. Any N, S and
// M is taken, and any D. The widest state dim is a template parameter
// DMAX of the blocks: instances for D <= 16 (D = 6 and 12 unrolled, and a
// generic one), and DT = DMAX = 0, the wide kernel for every D above 16,
// whose per-thread arrays run over output-dim tiles of a fixed width kW
// and whose shared memory is dynamic, sized at launch, with 1/ls2 and a
// chunk's omf read through L2 where they would not fit. A shape is
// refused only where the grid or a block's rows exceed the card's limits.
//
// The designs it replaced: up to D = 48 an instance with per-thread arrays
// of 48 floats (spilled: 145 us at L=5, N=20, D=20, S=256 on an H100), D
// above refused; before, D update blocks per draw of one thread per
// inducing point, each walking all N rows and D pairs with its pair loop
// not unrolled at D > 8, and chunk blocks with six register arrays of 16
// floats (161 registers, one block per SM) and a block reduction per 2
// rows.
//
// Accuracy. Accurate sincosf/expf, no fast-math; everything is f32.

#include "df_common.cuh"

namespace {

constexpr int kThreads = df::kThreads;
constexpr int kRows = 8;           // rows per tile of a chunk block
constexpr int kChunk = kThreads;   // feature columns per chunk block
constexpr int kPad = kChunk + 8;   // row stride of du and omf in shared memory
constexpr int kUpdRows = 4;        // rows per update block

struct BwdArgs {
  const float* x;    // (N, D) per draw at x_ls
  const float* omf;  // (D, SD)
  const float* phf;  // (1, SD)
  const float* G;    // (2SD, D)
  const float* z;    // (M, D)
  const float* nur;  // (M, D)
  const float* ls2;  // (D, D)
  const float* var;  // (D,)
  long long x_ls, omf_ls, phf_ls, G_ls, z_ls, nur_ls, ls2_ls, var_ls;
  const float* g;    // (L, N, D) cotangent of the output
  float* dx_slab;    // (L, n_mc + n_chunks, N, D)
  float* domf;       // (L, D, SD)
  float* dphf;       // (L, SD)
  float* dG;         // (L, 2SD, D)
  float* upd;        // (L, n_rt, 2 M D + n_mc (D D + D))
  // the finished cotangents, per draw or, for an operand with stride 0,
  // summed over the draws
  float* dx;         // (L, N, D)
  float* dz;         // ([L,] M, D)
  float* dnur;       // ([L,] M, D)
  float* dls2;       // ([L,] D, D)
  float* dvar;       // ([L,] D)
  int L, N, D, SD, M, n_chunks, n_mc, n_rt;
  int wide_par;       // the wide kernel: 1/ls2 | var in shared memory
};

template <int DMAX>
struct ChunkSmem {
  float om[DMAX * kPad];    // [d][c] omf of the chunk
  float du[kRows * kPad];   // [r][c] du of the tile
};

template <int DMAX>
struct UpdSmem {
  float buf[DMAX * kThreads];              // [j][thread] partials
  float dvb[kThreads];
  float redx[df::kWarps * kUpdRows * DMAX];   // [warp][r][k] dx terms
  float zs[kThreads];                      // the block's points' Z rows
  float nus[kThreads];                     // and nur rows
  float par[DMAX * DMAX + DMAX];           // 1 / ls2 [j, i] | var
};

template <int DMAX>
union Smem {
  ChunkSmem<DMAX> c;
  UpdSmem<DMAX> u;
};


// The update term of kUpdRows rows (tile rt) and the block's inducing
// points (chunk mc).
template <int DT, int DMAX>
__device__ __forceinline__ void update_block(const BwdArgs& a, long long l,
                                             int rt, int mc,
                                             UpdSmem<DMAX>& sm, float* xs,
                                             float* gsm) {
  constexpr int DM = DT ? DT : DMAX;
  const int D = DT ? DT : a.D;
  const int N = a.N, M = a.M;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int MU = kThreads / D;
  const int m0 = mc * MU;
  const int cnt = min(MU, M - m0);
  const int r0 = rt * kUpdRows;
  const int rows = min(kUpdRows, N - r0);
  const int ml = tid / D, i = tid % D;
  const bool own = ml < cnt;
  const float* x = a.x + l * a.x_ls + (long long)r0 * D;
  const float* g = a.g + (l * N + r0) * D;
  const float* z = a.z + l * a.z_ls + (long long)m0 * D;
  const float* nur = a.nur + l * a.nur_ls + (long long)m0 * D;
  df::load_par(sm.par, a.ls2 + l * a.ls2_ls, a.var + l * a.var_ls, D);
  for (int t = tid; t < rows * D; t += nt) {
    xs[t] = x[t];
    gsm[t] = g[t];
  }
  for (int t = tid; t < cnt * D; t += nt) {
    sm.zs[t] = z[t];
    sm.nus[t] = nur[t];
  }
  __syncthreads();
  const float* inv = sm.par;
  const float vi = own ? sm.par[D * D + i] : 0.f;
  const float* zm = sm.zs + ml * D;
  const float* nu = sm.nus + ml * D;
  float dl[DM], dnu[DM], dz[DM];
  float dv = 0.f;
#pragma unroll
  for (int k = 0; k < DM; ++k) dl[k] = dnu[k] = dz[k] = 0.f;

#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    float dk[DM], dd[DM];
    float sq = 0.f, sqb = 0.f, ddi = 0.f;
#pragma unroll
    for (int k = 0; k < DM; ++k) {
      dk[k] = own && k < D ? xs[r * D + k] - zm[k] : 0.f;
      sq = fmaf(dk[k], dk[k], sq);
      dd[k] = 0.f;
    }
    if (own) {
      const float di = xs[r * D + i] - zm[i];
      const float gi = gsm[r * D + i];
#pragma unroll
      for (int j = 0; j < DM; ++j) {
        if (j < D) {
          const float iv = inv[j * D + i];
          const float E = expf(-0.5f * sq * iv);
          const float dji = dk[j] * di;
          float base = dji * iv;
          if (i == j) base += (float)(D - 1) - sq * iv;
          const float c1 = vi * iv;
          const float contrib = E * base * c1;
          dnu[j] = fmaf(contrib, gi, dnu[j]);
          const float dcon = gi * nu[j];
          const float Eb = dcon * base * c1;
          const float bb = dcon * E * c1;
          const float cb = dcon * E * base;
          sqb = fmaf(Eb * E, -0.5f * iv, sqb);
          float ivb = -0.5f * Eb * E * sq + bb * dji + cb * vi;
          dd[j] = fmaf(bb * di, iv, dd[j]);
          ddi = fmaf(bb * dk[j], iv, ddi);
          if (i == j) {
            sqb -= bb * iv;
            ivb -= bb * sq;
          }
          dv = fmaf(cb, iv, dv);
          dl[j] -= ivb * iv * iv;
        }
      }
    }
    // this thread's dx[r, k] term t; dZ[m, k] gets -t
#pragma unroll
    for (int k = 0; k < DM; ++k) {
      if (k < D) {
        float t = fmaf(2.f * dk[k], sqb, dd[k]);
        if (k == i) t += ddi;
        if (!own) t = 0.f;
        dz[k] -= t;
        t = df::warp_sum(t);
        if (lane == 0) sm.redx[(warp * kUpdRows + r) * DMAX + k] = t;
      }
    }
  }

  const int n_slots = a.n_mc + a.n_chunks;
  float* dx = a.dx_slab + ((l * n_slots + mc) * N + r0) * (long long)D;
  float* out = a.upd + (l * a.n_rt + rt) *
                           (2LL * M * D + (long long)a.n_mc * (D * D + D));
  // dnur, then dZ, of the block's points: sums over their D threads
#pragma unroll
  for (int j = 0; j < DM; ++j)
    if (j < D) sm.buf[j * kThreads + tid] = dnu[j];
  __syncthreads();
  for (int t = tid; t < rows * D; t += nt) {
    const int r = t / D, k = t % D;
    float s = 0.f;
    for (int w = 0; w < df::kWarps; ++w)
      s += sm.redx[(w * kUpdRows + r) * DMAX + k];
    dx[t] = s;
  }
  for (int t = tid; t < cnt * D; t += nt) {
    const int p = t / D, j = t % D;
    float s = 0.f;
    for (int q = 0; q < D; ++q) s += sm.buf[j * kThreads + p * D + q];
    out[(long long)M * D + (long long)m0 * D + t] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < DM; ++k)
    if (k < D) sm.buf[k * kThreads + tid] = dz[k];
  __syncthreads();
  for (int t = tid; t < cnt * D; t += nt) {
    const int p = t / D, k = t % D;
    float s = 0.f;
    for (int q = 0; q < D; ++q) s += sm.buf[k * kThreads + p * D + q];
    out[(long long)m0 * D + t] = s;
  }
  __syncthreads();
  // the ls2 column i and var_i cotangents: sums over the block's points
#pragma unroll
  for (int j = 0; j < DM; ++j)
    if (j < D) sm.buf[j * kThreads + tid] = dl[j];
  sm.dvb[tid] = dv;
  __syncthreads();
  float* dpar = out + 2LL * M * D + (long long)mc * (D * D + D);
  for (int t = tid; t < D * D + D; t += nt) {
    float s = 0.f;
    if (t < D * D) {
      const int j = t / D, q = t % D;
      for (int p = 0; p < cnt; ++p) s += sm.buf[j * kThreads + p * D + q];
    } else {
      for (int p = 0; p < cnt; ++p) s += sm.dvb[p * D + t - D * D];
    }
    dpar[t] = s;
  }
}

// The ORFF prior's VJP over feature columns ch * kChunk .. (ch+1) * kChunk
// - 1, for all N rows.
template <int DT, int DMAX>
__device__ __forceinline__ void chunk_block(const BwdArgs& a, long long l,
                                            int ch, ChunkSmem<DMAX>& sm,
                                            float* xs, float* gsm) {
  constexpr int DM = DT ? DT : DMAX;
  const int D = DT ? DT : a.D;
  const int N = a.N, SD = a.SD;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c0 = ch * kChunk;
  const int cnt = min(kChunk, SD - c0);
  const bool own = tid < cnt;
  const int c = c0 + tid;
  const float* omf = a.omf + l * a.omf_ls;
  const float* G = a.G + l * a.G_ls;
  const float* x = a.x + l * a.x_ls;
  const float* g = a.g + l * N * D;
  // the column's omf in shared memory (the dx product reads it too), its
  // G rows and the cotangent sums in registers
  float gc[DM], gs[DM], ob[DM], gcb[DM], gsb[DM];
#pragma unroll
  for (int k = 0; k < DM; ++k) {
    const bool use = own && k < D;
    if (k < D) sm.om[k * kPad + tid] =
        use ? __ldg(omf + (long long)k * SD + c) : 0.f;
    gc[k] = use ? __ldg(G + (long long)c * D + k) : 0.f;
    gs[k] = use ? __ldg(G + ((long long)SD + c) * D + k) : 0.f;
    ob[k] = gcb[k] = gsb[k] = 0.f;
  }
  const float ph = own ? __ldg(a.phf + l * a.phf_ls + c) : 0.f;
  float pb = 0.f;
  const int n_slots = a.n_mc + a.n_chunks;
  float* dx = a.dx_slab + (l * n_slots + a.n_mc + ch) * (long long)N * D;

  for (int t0 = 0; t0 < N; t0 += kRows) {
    const int rows = min(kRows, N - t0);
    __syncthreads();  // the previous tile's product has read xs and du
    for (int t = tid; t < rows * D; t += nt) {
      xs[t] = x[(long long)t0 * D + t];
      gsm[t] = g[(long long)t0 * D + t];
    }
    __syncthreads();
    // one sincosf per (row, column); columns past SD carry u = 0 and
    // G = 0, so their du is 0
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      float u = ph;
#pragma unroll
      for (int d = 0; d < DM; ++d)
        if (d < D) u = fmaf(xs[r * D + d], sm.om[d * kPad + tid], u);
      float sn, cs;
      sincosf(u, &sn, &cs);
      float dc = 0.f, ds = 0.f;
#pragma unroll
      for (int k = 0; k < DM; ++k)
        if (k < D) {
          const float gg = gsm[r * D + k];
          gcb[k] = fmaf(cs, gg, gcb[k]);
          gsb[k] = fmaf(sn, gg, gsb[k]);
          dc = fmaf(gg, gc[k], dc);
          ds = fmaf(gg, gs[k], ds);
        }
      const float du = cs * ds - sn * dc;
      pb += du;
#pragma unroll
      for (int d = 0; d < DM; ++d)
        if (d < D) ob[d] = fmaf(xs[r * D + d], du, ob[d]);
      sm.du[r * kPad + tid] = du;
    }
    __syncthreads();
    // dx[t0 + r, d] = sum_c du[r, c] omf[d, c]: threads 2q and 2q + 1 take
    // the even and the odd float4s of pair q = r * D + d
    const int pairs = 2 * rows * D;
    for (int q0 = 0; q0 < pairs; q0 += nt) {
      const int q = q0 + tid;
      float v = 0.f;
      if (q < pairs) {
        const int rd = q >> 1, h = q & 1;
        const float4* du4 = reinterpret_cast<const float4*>(
            sm.du + (rd / D) * kPad);
        const float4* om4 = reinterpret_cast<const float4*>(
            sm.om + (rd % D) * kPad);
#pragma unroll 4
        for (int k = h; k < kChunk / 4; k += 2) {
          const float4 p = du4[k], o = om4[k];
          v = fmaf(p.x, o.x, v);
          v = fmaf(p.y, o.y, v);
          v = fmaf(p.z, o.z, v);
          v = fmaf(p.w, o.w, v);
        }
      }
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (q < pairs && !(q & 1)) dx[(long long)t0 * D + (q >> 1)] = v;
    }
  }
  if (own) {
    a.dphf[l * SD + c] = pb;
    float* dG = a.dG + l * 2LL * SD * D;
#pragma unroll
    for (int k = 0; k < DM; ++k)
      if (k < D) {
        a.domf[(l * D + k) * SD + c] = ob[k];
        dG[(long long)c * D + k] = gcb[k];
        dG[((long long)SD + c) * D + k] = gsb[k];
      }
  }
}

// The blocks of both kinds on the shared memory `sm`.
template <int DT, int DMAX>
__device__ __forceinline__ void run_block(const BwdArgs& a, Smem<DMAX>& sm,
                                          float* xs, float* gsm) {
  long long b = blockIdx.x;
  const long long n_upd = (long long)a.L * a.n_rt * a.n_mc;
  if (b < n_upd) {
    const int mc = (int)(b % a.n_mc);
    b /= a.n_mc;
    update_block<DT, DMAX>(a, b / a.n_rt, (int)(b % a.n_rt), mc, sm.u, xs,
                           gsm);
  } else {
    b -= n_upd;
    chunk_block<DT, DMAX>(a, b / a.n_chunks, (int)(b % a.n_chunks), sm.c,
                          xs, gsm);
  }
}

// DT: the state dim the block loops are unrolled for (0: any D <= DMAX);
// DMAX: the widest state dim of the instance, 16 (DT = DMAX = 0: the wide
// kernel below, for any D above 16).
template <int DT, int DMAX>
__global__ void __launch_bounds__(kThreads, DT ? 2 : 1)
    df_pathwise_tiled_bwd_kernel(BwdArgs a) {
  __shared__ float xs[kRows * DMAX];
  __shared__ float gsm[kRows * DMAX];
  __shared__ __align__(16) Smem<DMAX> sm;
  run_block<DT, DMAX>(a, sm, xs, gsm);
}

// -- the blocks for any state dim above 16 ------------------------------------
//
// Per-thread arrays have the fixed width kW (a tile of output dims), so
// none grows with D; the shared memory is dynamic, sized at launch
// (wide_smem_floats), with 1/ls2 | var in it where they fit the opt-in
// limit (a.wide_par), else read through L2. A feature column takes at
// most a block's threads, kW dims each: D up to kThreads kW = 2,048 (at
// M = 100 inducing points the reference's (M D)^2 gram is then 168 GB,
// past the card's memory); above, the layout refuses.

constexpr int kW = 8;   // output dims per tile of the wide blocks

__device__ __forceinline__ float wide_inv(const float* par, const float* ls2,
                                          int D, int j, int i) {
  return par ? par[j * D + i] : 1.f / __ldg(ls2 + j * D + i);
}

// Inducing points per wide update block: every (point, output) item a
// thread, one point above D = kThreads (its items in rounds of kThreads).
__host__ __device__ __forceinline__ int wide_points(int D) {
  return D <= kThreads ? kThreads / D : 1;
}

// The per-tile sums of the wide update block: the items' dx terms ddr[r]
// over the block (warp shuffles, then the warps) added into dxacc [r][j];
// dnu and dz over a point's items in this round added into nuacc and zacc
// [point][j]; the ls2 cotangent of (j, i) over the round's points written
// to dpar[j * D + i] (each i lies in one round). Items it = round * nt +
// tid are (point it / D, output it % D); buf rows are nt + 1 floats apart,
// so a warp's reads of kW rows hit distinct banks.
__device__ __forceinline__ void wide_tile_sums(
    float (&ddr)[kUpdRows][kW], const float (&dnu)[kW], const float (&dl)[kW],
    const float (&dz)[kW], int j0, int D, int cnt, int round, float* buf,
    float* redx, float* dxacc, float* nuacc, float* zacc, float* dpar) {
  const int tid = threadIdx.x, nt = blockDim.x, bs = nt + 1;
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < kUpdRows; ++r)
#pragma unroll
    for (int jj = 0; jj < kW; ++jj) {
      const float v = df::warp_sum(ddr[r][jj]);
      if (lane == 0) redx[(warp * kUpdRows + r) * kW + jj] = v;
    }
#pragma unroll
  for (int jj = 0; jj < kW; ++jj) {
    buf[jj * bs + tid] = dnu[jj];
    buf[(kW + jj) * bs + tid] = dl[jj];
    buf[(2 * kW + jj) * bs + tid] = dz[jj];
  }
  __syncthreads();
  const int base = round * nt;   // the round's first item
  for (int t = tid; t < kUpdRows * kW; t += nt) {
    const int r = t / kW, jj = t % kW;
    if (j0 + jj >= D) continue;
    float v = 0.f;
    for (int w = 0; w < df::kWarps; ++w)
      v += redx[(w * kUpdRows + r) * kW + jj];
    dxacc[r * D + j0 + jj] += v;
  }
  for (int t = tid; t < cnt * kW; t += nt) {
    const int ml = t / kW, jj = t % kW;
    if (j0 + jj >= D) continue;
    // this round's items of point ml
    const int lo = max(0, ml * D - base);
    const int hi = min(nt, min((ml + 1) * D, cnt * D) - base);
    float snu = 0.f, sz = 0.f;
    for (int q = lo; q < hi; ++q) {
      snu += buf[jj * bs + q];
      sz += buf[(2 * kW + jj) * bs + q];
    }
    nuacc[ml * D + j0 + jj] += snu;
    zacc[ml * D + j0 + jj] += sz;
  }
  // the round's outputs i and, for each, its items over the points
  const int i_lo = D <= nt ? 0 : base;
  const int i_n = D <= nt ? D : min(nt, D - base);
  for (int t = tid; t < kW * i_n; t += nt) {
    const int jj = t / i_n, i = i_lo + t % i_n;
    if (j0 + jj >= D) continue;
    float sl = 0.f;
    for (int ml = 0; ml < cnt; ++ml) {
      const int q = ml * D + i - base;
      if (q >= 0 && q < nt) sl += buf[(kW + jj) * bs + q];
    }
    dpar[(j0 + jj) * D + i] = sl;
  }
  __syncthreads();
}

// The update term of kUpdRows rows (tile rt) and the block's inducing
// points (chunk mc) at any D above 16: thread (point, output i) walks the
// columns j in tiles of kW with the rows inside; its dx / dZ terms
// 2 (x - z)_k sqb + [k == i] ddi of every dim k are added afterwards,
// sqb summed over each point's items first.
__device__ void update_block_wide(const BwdArgs& a, long long l, int rt,
                                  int mc, float* sm) {
  const int D = a.D, N = a.N, M = a.M;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int MU = wide_points(D);
  const int m0 = mc * MU;
  const int cnt = min(MU, M - m0);
  const int r0 = rt * kUpdRows;
  const int rows = min(kUpdRows, N - r0);
  const int RD = kUpdRows * D;
  const float* ls2 = a.ls2 + l * a.ls2_ls;
  const float* varp = a.var + l * a.var_ls;
  float* xs = sm;                              // RD
  float* gsm = xs + RD;                        // RD
  float* zsm = gsm + RD;                       // MU * D
  float* nsm = zsm + MU * D;                   // MU * D
  float* nuacc = nsm + MU * D;                 // MU * D
  float* zacc = nuacc + MU * D;                // MU * D
  float* ddis = zacc + MU * D;                 // kUpdRows * MU * D
  float* dxacc = ddis + kUpdRows * MU * D;     // RD
  float* sqs = dxacc + RD;                     // kUpdRows * MU
  float* sacc = sqs + kUpdRows * MU;           // kUpdRows * MU
  float* sqbs = sacc + kUpdRows * MU;          // kUpdRows * nt
  float* buf = sqbs + kUpdRows * nt;           // 3 kW (nt + 1)
  float* redx = buf + 3 * kW * (nt + 1);       // kWarps kUpdRows kW
  float* dvb = redx + df::kWarps * kUpdRows * kW;   // nt
  float* par = a.wide_par ? dvb + nt : nullptr;     // D * D + D
  if (par) df::load_par(par, ls2, varp, D);
  const float* x = a.x + l * a.x_ls + (long long)r0 * D;
  const float* g = a.g + (l * N + r0) * D;
  const float* z = a.z + l * a.z_ls + (long long)m0 * D;
  const float* nur = a.nur + l * a.nur_ls + (long long)m0 * D;
  for (int t = tid; t < RD; t += nt) {
    xs[t] = t < rows * D ? x[t] : 0.f;
    gsm[t] = t < rows * D ? g[t] : 0.f;
    dxacc[t] = 0.f;
  }
  for (int t = tid; t < MU * D; t += nt) {
    zsm[t] = t < cnt * D ? z[t] : 0.f;
    nsm[t] = t < cnt * D ? nur[t] : 0.f;
    nuacc[t] = zacc[t] = 0.f;
  }
  __syncthreads();
  for (int t = tid; t < kUpdRows * MU; t += nt) {
    const int r = t / MU, ml = t % MU;
    float sq = 0.f;
    for (int k = 0; k < D; ++k) {
      const float dk = xs[r * D + k] - zsm[ml * D + k];
      sq = fmaf(dk, dk, sq);
    }
    sqs[t] = sq;
    sacc[t] = 0.f;
  }
  __syncthreads();

  float* out = a.upd + (l * a.n_rt + rt) *
                           (2LL * M * D + (long long)a.n_mc * (D * D + D));
  float* dpar = out + 2LL * M * D + (long long)mc * (D * D + D);
  const int rounds = (MU * D + nt - 1) / nt;
  for (int round = 0; round < rounds; ++round) {
    const int it = round * nt + tid;
    const bool own = it < cnt * D;
    const int ml = own ? it / D : 0, i = own ? it % D : 0;
    const float vi = !own ? 0.f : par ? par[D * D + i] : __ldg(varp + i);
    const float* zm = zsm + ml * D;
    const float* nu = nsm + ml * D;
    float di[kUpdRows], gi[kUpdRows], sqv[kUpdRows], sqb[kUpdRows],
        ddi[kUpdRows];
#pragma unroll
    for (int r = 0; r < kUpdRows; ++r) {
      di[r] = xs[r * D + i] - zm[i];
      gi[r] = own ? gsm[r * D + i] : 0.f;
      sqv[r] = sqs[r * MU + ml];
      sqb[r] = ddi[r] = 0.f;
    }
    float dv = 0.f;
    for (int j0 = 0; j0 < D; j0 += kW) {
      float dnu[kW], dl[kW], dz[kW], ddr[kUpdRows][kW];
#pragma unroll
      for (int jj = 0; jj < kW; ++jj) {
        dnu[jj] = dl[jj] = dz[jj] = 0.f;
#pragma unroll
        for (int r = 0; r < kUpdRows; ++r) ddr[r][jj] = 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < kW; ++jj) {
        const int j = j0 + jj;
        if (!own || j >= D) continue;
        const float iv = wide_inv(par, ls2, D, j, i);
        const float nj = nu[j];
#pragma unroll
        for (int r = 0; r < kUpdRows; ++r) {
          const float dkj = xs[r * D + j] - zm[j];
          const float sq = sqv[r];
          const float E = expf(-0.5f * sq * iv);
          const float dji = dkj * di[r];
          float base = dji * iv;
          if (i == j) base += (float)(D - 1) - sq * iv;
          const float c1 = vi * iv;
          const float contrib = E * base * c1;
          dnu[jj] = fmaf(contrib, gi[r], dnu[jj]);
          const float dcon = gi[r] * nj;
          const float Eb = dcon * base * c1;
          const float bb = dcon * E * c1;
          const float cb = dcon * E * base;
          sqb[r] = fmaf(Eb * E, -0.5f * iv, sqb[r]);
          float ivb = -0.5f * Eb * E * sq + bb * dji + cb * vi;
          const float ddj = bb * di[r] * iv;
          ddi[r] = fmaf(bb * dkj, iv, ddi[r]);
          if (i == j) {
            sqb[r] -= bb * iv;
            ivb -= bb * sq;
          }
          dv = fmaf(cb, iv, dv);
          dl[jj] -= ivb * iv * iv;
          ddr[r][jj] = ddj;
          dz[jj] -= ddj;
        }
      }
      wide_tile_sums(ddr, dnu, dl, dz, j0, D, cnt, round, buf, redx, dxacc,
                     nuacc, zacc, dpar);
    }
    // the item's terms 2 (x - z)_k sqb + [k == i] ddi of every dim k: sqb
    // summed over the point's items here, ddi kept per item, both added
    // below for every (row, k) and (point, k) at once
#pragma unroll
    for (int r = 0; r < kUpdRows; ++r) {
      sqbs[r * nt + tid] = own ? sqb[r] : 0.f;
      if (own) ddis[r * MU * D + it] = ddi[r];
    }
    dvb[tid] = dv;
    __syncthreads();
    const int base = round * nt;
    for (int t = tid; t < kUpdRows * cnt; t += nt) {
      const int r = t / cnt, ml = t % cnt;
      const int lo = max(0, ml * D - base);
      const int hi = min(nt, (ml + 1) * D - base);
      float sb = 0.f;
      for (int q = lo; q < hi; ++q) sb += sqbs[r * nt + q];
      sacc[r * MU + ml] += sb;
    }
    // var_i over the round's points
    const int i_lo = D <= nt ? 0 : base;
    const int i_n = D <= nt ? D : min(nt, D - base);
    for (int t = tid; t < i_n; t += nt) {
      float sv = 0.f;
      for (int m2 = 0; m2 < cnt; ++m2) {
        const int q = m2 * D + i_lo + t - base;
        if (q >= 0 && q < nt) sv += dvb[q];
      }
      dpar[D * D + i_lo + t] = sv;
    }
    __syncthreads();
  }
  // dx[r, k] += sum over the points of 2 (x_r - z_m)_k S_m[r] + ddi of
  // item (m, k); dZ[m, k] -= the same summed over the rows
  for (int t = tid; t < RD; t += nt) {
    const int r = t / D, k = t % D;
    float v = 0.f;
    for (int ml = 0; ml < cnt; ++ml)
      v += fmaf(2.f * (xs[t] - zsm[ml * D + k]), sacc[r * MU + ml],
                ddis[r * MU * D + ml * D + k]);
    dxacc[t] += v;
  }
  for (int t = tid; t < cnt * D; t += nt) {
    const int ml = t / D, k = t % D;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kUpdRows; ++r)
      v += fmaf(2.f * (xs[r * D + k] - zsm[t]), sacc[r * MU + ml],
                ddis[r * MU * D + t]);
    zacc[t] -= v;
  }
  __syncthreads();

  const int n_slots = a.n_mc + a.n_chunks;
  float* dx = a.dx_slab + ((l * n_slots + mc) * N + r0) * (long long)D;
  for (int t = tid; t < rows * D; t += nt) dx[t] = dxacc[t];
  for (int t = tid; t < cnt * D; t += nt) {
    out[(long long)m0 * D + t] = zacc[t];
    out[(long long)M * D + (long long)m0 * D + t] = nuacc[t];
  }
}

// The wide chunk blocks give a feature column wide_tpc(D) threads, each
// with kW of the D output dims, and take wide_cpb(D) columns (a chunk).
__host__ __device__ __forceinline__ int wide_tpc(int D) {
  return (D + kW - 1) / kW;
}
__host__ __device__ __forceinline__ int wide_cpb(int D) {
  return kThreads / wide_tpc(D);
}

// The ORFF prior's VJP over the feature columns of chunk ch, for all N
// rows in tiles of kRows, at any D above 16 (up to kThreads kW): thread
// (column, t) holds omf, the G rows and the cotangent sums of the
// column's dims k in [t kW, (t + 1) kW) in registers for the whole walk;
// per tile its partial dot products x . omf and g . G over those dims meet
// the column's other threads' in shared memory (every thread adds them in
// the same order, so all hold the same u and du), one sincosf per (row,
// column) and thread, and the tile's dx = du . omf^T is a product over
// the chunk's columns from omf and du in shared memory.
__device__ void chunk_block_wide(const BwdArgs& a, long long l, int ch,
                                 float* sm) {
  const int D = a.D, N = a.N, SD = a.SD;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int TPC = wide_tpc(D), CPB = wide_cpb(D);
  const int col = tid / TPC, t = tid % TPC, k0 = t * kW;
  const int cq = (col < CPB ? col : 0) * TPC;   // the column's first thread
  const int c0 = ch * CPB;
  const int cnt = min(CPB, SD - c0);
  const bool own = col < cnt;
  const int c = c0 + col;
  const float* omf = a.omf + l * a.omf_ls;
  const float* G = a.G + l * a.G_ls;
  const float* x = a.x + l * a.x_ls;
  const float* g = a.g + l * N * D;
  float* xs = sm;                       // kRows * D
  float* gsm = xs + kRows * D;          // kRows * D
  float* om = gsm + kRows * D;          // [d][column], D * CPB
  float* du = om + D * CPB;             // [r][column], kRows * CPB
  float* trig = du + kRows * CPB;       // [cos | sin][r][column]
  float* ex = trig + 2 * kRows * CPB;   // [3][r][thread] partial sums
  for (int e = tid; e < D * CPB; e += nt) {
    const int d = e / CPB, cc = e % CPB;
    om[e] = cc < cnt ? __ldg(omf + (long long)d * SD + c0 + cc) : 0.f;
  }
  float om_r[kW], gc[kW], gs[kW], ob[kW], gcb[kW], gsb[kW];
#pragma unroll
  for (int kk = 0; kk < kW; ++kk) {
    const int k = k0 + kk;
    const bool use = own && k < D;
    om_r[kk] = use ? __ldg(omf + (long long)k * SD + c) : 0.f;
    gc[kk] = use ? __ldg(G + (long long)c * D + k) : 0.f;
    gs[kk] = use ? __ldg(G + ((long long)SD + c) * D + k) : 0.f;
    ob[kk] = gcb[kk] = gsb[kk] = 0.f;
  }
  const float ph = own ? __ldg(a.phf + l * a.phf_ls + c) : 0.f;
  float pb = 0.f;
  const int n_slots = a.n_mc + a.n_chunks;
  float* dx = a.dx_slab + (l * n_slots + a.n_mc + ch) * (long long)N * D;

  for (int t0 = 0; t0 < N; t0 += kRows) {
    const int rows = min(kRows, N - t0);
    __syncthreads();  // the previous tile's product has read xs and du
    for (int e = tid; e < kRows * D; e += nt) {
      xs[e] = e < rows * D ? x[(long long)t0 * D + e] : 0.f;
      gsm[e] = e < rows * D ? g[(long long)t0 * D + e] : 0.f;
    }
    __syncthreads();
    // u = x . omf[:, c] + phf[c] from the column's threads' partials;
    // columns past SD carry u = 0 and G = 0, rows past N g = 0, so their
    // du is 0
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float p = 0.f;
#pragma unroll
      for (int kk = 0; kk < kW; ++kk)
        if (k0 + kk < D) p = fmaf(xs[r * D + k0 + kk], om_r[kk], p);
      ex[r * nt + tid] = p;
    }
    __syncthreads();
    // one sincosf per (row, column): row r by the column's thread r % TPC
    if (col < CPB)
      for (int r = t; r < kRows; r += TPC) {
        float u = ph;
        for (int q = 0; q < TPC; ++q) u += ex[r * nt + cq + q];
        sincosf(u, &trig[(kRows + r) * CPB + col], &trig[r * CPB + col]);
      }
    __syncthreads();
    const int cc0 = cq / TPC;   // this thread's column (0 for an idle one)
    float cs[kRows], sn[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      cs[r] = trig[r * CPB + cc0];
      sn[r] = trig[(kRows + r) * CPB + cc0];
      float dcp = 0.f, dsp = 0.f;
#pragma unroll
      for (int kk = 0; kk < kW; ++kk)
        if (k0 + kk < D) {
          const float gg = gsm[r * D + k0 + kk];
          gcb[kk] = fmaf(cs[r], gg, gcb[kk]);
          gsb[kk] = fmaf(sn[r], gg, gsb[kk]);
          dcp = fmaf(gg, gc[kk], dcp);
          dsp = fmaf(gg, gs[kk], dsp);
        }
      ex[(kRows + r) * nt + tid] = dcp;
      ex[(2 * kRows + r) * nt + tid] = dsp;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float dc = 0.f, ds = 0.f;
      for (int q = 0; q < TPC; ++q) {
        dc += ex[(kRows + r) * nt + cq + q];
        ds += ex[(2 * kRows + r) * nt + cq + q];
      }
      const float v = cs[r] * ds - sn[r] * dc;   // du of row r
#pragma unroll
      for (int kk = 0; kk < kW; ++kk)
        if (k0 + kk < D) ob[kk] = fmaf(xs[r * D + k0 + kk], v, ob[kk]);
      if (t == 0) {
        pb += v;
        if (col < CPB) du[r * CPB + col] = v;
      }
    }
    __syncthreads();
    // dx[t0 + r, d] = sum over the chunk's columns of du[r, c] omf[d, c]
    for (int e = tid; e < rows * D; e += nt) {
      const float* dur = du + (e / D) * CPB;
      const float* omr = om + (e % D) * CPB;
      float v = 0.f;
      for (int cc = 0; cc < cnt; ++cc) v = fmaf(dur[cc], omr[cc], v);
      dx[(long long)t0 * D + e] = v;
    }
  }
  if (own) {
#pragma unroll
    for (int kk = 0; kk < kW; ++kk)
      if (k0 + kk < D) {
        float* dG = a.dG + l * 2LL * SD * D;
        dG[(long long)c * D + k0 + kk] = gcb[kk];
        dG[((long long)SD + c) * D + k0 + kk] = gsb[kk];
        a.domf[(l * D + k0 + kk) * SD + c] = ob[kk];
      }
    if (t == 0) a.dphf[l * SD + c] = pb;
  }
}

// DT = DMAX = 0, the wide kernel: the blocks for any state dim above 16.
template <>
__global__ void __launch_bounds__(kThreads)
    df_pathwise_tiled_bwd_kernel<0, 0>(BwdArgs a) {
  extern __shared__ float smem[];
  long long b = blockIdx.x;
  const long long n_upd = (long long)a.L * a.n_rt * a.n_mc;
  if (b < n_upd) {
    const int mc = (int)(b % a.n_mc);
    b /= a.n_mc;
    update_block_wide(a, b / a.n_rt, (int)(b % a.n_rt), mc, smem);
  } else {
    b -= n_upd;
    chunk_block_wide(a, b / a.n_chunks, (int)(b % a.n_chunks), smem);
  }
}

// Floats of the wide kernel's dynamic shared memory at state dim D, with
// 1/ls2 | var (par) in it or not.
long long wide_smem_floats(int D, bool par) {
  const long long MU = wide_points(D), RD = (long long)kUpdRows * D;
  const long long upd = 3 * RD + (4 + kUpdRows) * MU * D +
                        2 * kUpdRows * MU + kUpdRows * kThreads +
                        3LL * kW * (kThreads + 1) +
                        df::kWarps * kUpdRows * kW + kThreads +
                        (par ? (long long)D * D + D : 0);
  const long long cpb = wide_cpb(D);
  const long long chunk = 2LL * kRows * D + (D + 3 * kRows) * cpb +
                          3LL * kRows * kThreads;
  return upd > chunk ? upd : chunk;
}

// dx, dZ, dnur, dls2 and dvar from the slabs: the first blocks give each
// dx entry a thread (a sum over the slots); the others give each entry of
// dZ, dnur, dls2, dvar (laid end to end in that order) a warp, whose lanes
// split its sum over the row tiles (and point chunks, and the draws of an
// operand with stride 0) and meet in a shuffle tree. Fixed order
// throughout.
__global__ void __launch_bounds__(kThreads)
    df_pathwise_tiled_bwd_finish(BwdArgs a) {
  const int N = a.N, D = a.D, L = a.L;
  const long long ND = (long long)N * D, MD = (long long)a.M * D;
  const long long n_dx = L * ND;
  const long long dx_blocks = (n_dx + blockDim.x - 1) / blockDim.x;
  if (blockIdx.x < dx_blocks) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e < n_dx) {
      const int n_slots = a.n_mc + a.n_chunks;
      const float* p = a.dx_slab + (e / ND) * n_slots * ND + e % ND;
      float s = 0.f;
      for (int q = 0; q < n_slots; ++q) s += p[q * ND];
      a.dx[e] = s;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  long long e = (blockIdx.x - dx_blocks) * (blockDim.x >> 5) +
                (threadIdx.x >> 5);
  // the entry's output, entries per draw, offset in a row tile's slab,
  // point chunks (stride D^2 + D) and its operand's draw stride
  const long long DD = (long long)D * D;
  const long long P = 2 * MD + (long long)a.n_mc * (DD + D);
  float* out;
  long long n, off, ls, count;
  int chunks = a.n_mc;
  if (e < (count = (a.z_ls ? L : 1) * MD)) {
    out = a.dz; n = MD; off = 0; ls = a.z_ls; chunks = 1;
  } else if ((e -= count) < (count = (a.nur_ls ? L : 1) * MD)) {
    out = a.dnur; n = MD; off = MD; ls = a.nur_ls; chunks = 1;
  } else if ((e -= count) < (count = (a.ls2_ls ? L : 1) * DD)) {
    out = a.dls2; n = DD; off = 2 * MD; ls = a.ls2_ls;
  } else if ((e -= count) < (count = (a.var_ls ? L : 1) * D)) {
    out = a.dvar; n = D; off = 2 * MD + DD; ls = a.var_ls;
  } else {
    return;
  }
  const int l0 = ls ? (int)(e / n) : 0;
  const long long terms = (long long)(ls ? 1 : L) * a.n_rt * chunks;
  const float* u = a.upd + (long long)l0 * a.n_rt * P + off + e % n;
  float s = 0.f;
  for (long long k = lane; k < terms; k += 32)
    s += u[(k / chunks) * P + (k % chunks) * (DD + D)];
  s = df::warp_sum(s);
  if (lane == 0) out[e] = s;
}

static_assert(kChunk % 8 == 0 && kPad % 4 == 0,
              "the dx product reads rows of du and omf as float4 pairs");

}  // namespace

// The slabs' layout for N rows, state dim D, SD = S*D feature columns and
// M inducing points: out = {n_chunks, n_mc, n_rt} (chunk blocks per draw,
// inducing-point chunks, update row tiles); zeros for a D it refuses.
extern "C" void df_pathwise_tiled_bwd_layout(int N, int D, int SD, int M,
                                             int* out) {
  const bool ok = D >= 1 && D <= kThreads * kW && N >= 1 && SD >= 1 &&
                  M >= 1;
  const int MU = ok ? wide_points(D) : 1;
  const int chunk = D <= 16 ? kChunk : ok ? wide_cpb(D) : 1;
  out[0] = ok ? (SD + chunk - 1) / chunk : 0;
  out[1] = ok ? (M + MU - 1) / MU : 0;
  out[2] = ok ? (N + kUpdRows - 1) / kUpdRows : 0;
}

// Launches the VJP kernel and its finishing sums on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for shapes it does not take
// (a layout other than df_pathwise_tiled_bwd_layout's, a grid past its
// limit, a state dim whose rows do not fit a block's opt-in shared
// memory). Operands as in df_pathwise_tiled_fwd; g is (L, N, D);
// dx_slab and upd are workspace; the outputs are laid out as BwdArgs states,
// and every entry is written.
extern "C" int df_pathwise_tiled_bwd(
    const float* x, long long x_ls, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* G, long long G_ls,
    const float* z, long long z_ls, const float* nur, long long nur_ls,
    const float* ls2, long long ls2_ls, const float* var, long long var_ls,
    const float* g, float* dx_slab, float* upd, float* dx, float* domf,
    float* dphf, float* dG, float* dz, float* dnur, float* dls2, float* dvar,
    int n_chunks, int n_mc, int n_rt, int L, int N, int D, int SD, int M,
    int device, void* stream) {
  int lay[3];
  df_pathwise_tiled_bwd_layout(N, D, SD, M, lay);
  if (L < 1 || lay[0] == 0 || n_chunks != lay[0] || n_mc != lay[1] ||
      n_rt != lay[2])
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)L * (n_chunks + (long long)n_rt * n_mc);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  int wide_par = 0;
  if (D > 16) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    wide_par = sizeof(float) * wide_smem_floats(D, true) <= (size_t)optin;
    smem = sizeof(float) * wide_smem_floats(D, wide_par);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  BwdArgs a;
  a.x = x; a.omf = omf; a.phf = phf; a.G = G; a.z = z; a.nur = nur;
  a.ls2 = ls2; a.var = var;
  a.x_ls = x_ls; a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.G_ls = G_ls;
  a.z_ls = z_ls; a.nur_ls = nur_ls; a.ls2_ls = ls2_ls; a.var_ls = var_ls;
  a.g = g; a.dx_slab = dx_slab; a.domf = domf; a.dphf = dphf; a.dG = dG;
  a.upd = upd; a.dx = dx; a.dz = dz; a.dnur = dnur; a.dls2 = dls2;
  a.dvar = dvar;
  a.L = L; a.N = N; a.D = D; a.SD = SD; a.M = M;
  a.n_chunks = n_chunks; a.n_mc = n_mc; a.n_rt = n_rt;
  a.wide_par = wide_par;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 6) {
    df_pathwise_tiled_bwd_kernel<6, 16><<<(unsigned)blocks, kThreads, 0, s>>>(
        a);
  } else if (D == 12) {
    df_pathwise_tiled_bwd_kernel<12, 16><<<(unsigned)blocks, kThreads, 0,
                                           s>>>(a);
  } else if (D <= 16) {
    df_pathwise_tiled_bwd_kernel<0, 16><<<(unsigned)blocks, kThreads, 0, s>>>(
        a);
  } else {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(df_pathwise_tiled_bwd_kernel<0, 0>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    df_pathwise_tiled_bwd_kernel<0, 0><<<(unsigned)blocks, kThreads, smem,
                                         s>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long MD = (long long)M * D;
  const long long n_dx = (long long)L * N * D;
  const long long n_upd = (z_ls ? L : 1) * MD + (nur_ls ? L : 1) * MD +
                          (ls2_ls ? L : 1) * D * D + (var_ls ? L : 1) * D;
  const int warps = kThreads / 32;
  df_pathwise_tiled_bwd_finish<<<(unsigned)((n_dx + kThreads - 1) /
                                                kThreads +
                                            (n_upd + warps - 1) / warps),
                                 kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
