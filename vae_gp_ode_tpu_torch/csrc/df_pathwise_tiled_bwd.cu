// Reverse mode (VJP) of the grid-tiled per-step DF pathwise evaluation in
// df_pathwise_tiled_fwd.cu, one launch for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_bwd_kernel` of
// vae_gp_ode_tpu/ops/df_pathwise_tiled.py. It computes what autograd
// through `df_pathwise_reference` computes for a cotangent g (L, N, D), the
// same function as df_pathwise_bwd.cu (df_common.cuh `vjp_accumulate`
// states the terms), recomputing the forward intermediates, with the DF
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
// M is taken; D above 16 is refused (df_common.cuh kMaxD).
//
// The design it replaced: D update blocks per draw of one thread per
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
constexpr int kMaxD = df::kMaxD;

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
};

struct ChunkSmem {
  float om[kMaxD * kPad];   // [d][c] omf of the chunk
  float du[kRows * kPad];   // [r][c] du of the tile
};

struct UpdSmem {
  float buf[kMaxD * kThreads];             // [j][thread] partials
  float dvb[kThreads];
  float redx[df::kWarps * kUpdRows * kMaxD];  // [warp][r][k] dx terms
  float zs[kThreads];                      // the block's points' Z rows
  float nus[kThreads];                     // and nur rows
  float par[kMaxD * kMaxD + kMaxD];        // 1 / ls2 [j, i] | var
};

union Smem {
  ChunkSmem c;
  UpdSmem u;
};

// The update term of kUpdRows rows (tile rt) and the block's inducing
// points (chunk mc).
template <int DT>
__device__ __forceinline__ void update_block(const BwdArgs& a, long long l,
                                             int rt, int mc, UpdSmem& sm,
                                             float* xs, float* gsm) {
  constexpr int DM = DT ? DT : kMaxD;
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
        if (lane == 0) sm.redx[(warp * kUpdRows + r) * kMaxD + k] = t;
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
      s += sm.redx[(w * kUpdRows + r) * kMaxD + k];
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
template <int DT>
__device__ __forceinline__ void chunk_block(const BwdArgs& a, long long l,
                                            int ch, ChunkSmem& sm, float* xs,
                                            float* gsm) {
  constexpr int DM = DT ? DT : kMaxD;
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

// DT: the state dim the block loops are unrolled for (0: any D <= 16).
template <int DT>
__global__ void __launch_bounds__(kThreads, DT ? 2 : 1)
    df_pathwise_tiled_bwd_kernel(BwdArgs a) {
  __shared__ __align__(16) Smem sm;
  __shared__ float xs[kRows * kMaxD];
  __shared__ float gsm[kRows * kMaxD];
  long long b = blockIdx.x;
  const long long n_upd = (long long)a.L * a.n_rt * a.n_mc;
  if (b < n_upd) {
    const int mc = (int)(b % a.n_mc);
    b /= a.n_mc;
    update_block<DT>(a, b / a.n_rt, (int)(b % a.n_rt), mc, sm.u, xs, gsm);
  } else {
    b -= n_upd;
    chunk_block<DT>(a, b / a.n_chunks, (int)(b % a.n_chunks), sm.c, xs,
                    gsm);
  }
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
  const bool ok = D >= 1 && D <= kMaxD && N >= 1 && SD >= 1 && M >= 1;
  const int MU = ok ? kThreads / D : 1;
  out[0] = ok ? (SD + kChunk - 1) / kChunk : 0;
  out[1] = ok ? (M + MU - 1) / MU : 0;
  out[2] = ok ? (N + kUpdRows - 1) / kUpdRows : 0;
}

// Launches the VJP kernel and its finishing sums on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for shapes it does not take
// (D above 16, a layout other than df_pathwise_tiled_bwd_layout's, a grid
// past its limit). Operands as in df_pathwise_tiled_fwd; g is (L, N, D);
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

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 6)
    df_pathwise_tiled_bwd_kernel<6><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  else if (D == 12)
    df_pathwise_tiled_bwd_kernel<12><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  else
    df_pathwise_tiled_bwd_kernel<0><<<(unsigned)blocks, kThreads, 0, s>>>(a);
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
