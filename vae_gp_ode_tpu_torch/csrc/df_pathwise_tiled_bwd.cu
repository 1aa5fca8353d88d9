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
// Design. The grid is (slot, L). Slots 0 .. n_chunks-1 are chunks of
// kThreads ORFF feature columns, one column per thread, for all N rows and
// all D output columns: the TPU ran this as an (s outer, i inner) grid and
// carried domf/dphf across consecutive i; here i is a loop inside the
// block, after one sincosf per (row, column), so domf, dphf and the chunk's
// rows of dG (cos and sin halves) are written exactly once, from registers,
// into per-draw outputs. The block walks the rows in tiles of R and sums
// the rows' dx over its columns (warp shuffles and one pass over the warps'
// partials). Slots n_chunks + i are the update term of output column i (one
// per draw and i): each thread owns inducing points and keeps their dZ and
// dnur in registers over the row tiles, its share of the ls2 column i and
// var_i cotangents in registers to one block reduction at the end. The
// TPU's one-hot masks for the traced column i (`df_pathwise_tiled.py:25-30`)
// were a Pallas limit; here column i is an index. Slabs: dx_slab
// (L, n_slots, N, D) from every block, dz_slab and dnur_slab (L, D, M, D)
// from the update blocks; dls2 (L, D, D) column i and dvar (L, D) entry i
// are written once by update block i. The wrapper sums the slabs (and, for
// operands that all draws share, the draws). No atomics. Any N, S and M is
// taken; D above 16 is refused (df_common.cuh kMaxD).
//
// What bounds it on an H100. At the wide shapes (L=5, N=20, D=12,
// SD = 12288, M=100) recompute and VJP are ~319 MFLOP on ~18 MB of operands
// and cotangents: ~5.4 us of memory time, bound by bytes. Where
// df_pathwise_bwd.cu has L * ceil(N / R) blocks (50 there) that each walk
// all SD columns and D^2 pairs, this grid has L * (ceil(SD / kThreads) + D)
// blocks (300 there) of 256 threads. Per-thread register arrays of D
// floats (six per column, two per row) limit occupancy at D > 8. wgmma, TMA
// and tuning are later work.
//
// Accuracy. Accurate sincosf/expf, no fast-math; everything is f32.

#include "df_common.cuh"

namespace {

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
  float* dx_slab;    // (L, n_slots, N, D)
  float* domf;       // (L, D, SD)
  float* dphf;       // (L, SD)
  float* dG;         // (L, 2SD, D)
  float* dz_slab;    // (L, D, M, D)
  float* dnur_slab;  // (L, D, M, D)
  float* dls2;       // (L, D, D)
  float* dvar;       // (L, D)
  int N, D, SD, M, n_chunks;
};

template <int R, int DMAX>
__global__ void __launch_bounds__(df::kThreads)
    df_pathwise_tiled_bwd_kernel(BwdArgs a) {
  __shared__ float xs[R * DMAX];
  __shared__ float gsm[R * DMAX];
  __shared__ float par[DMAX * DMAX + DMAX];
  __shared__ float red[df::kWarps * (R * DMAX + 1)];
  __shared__ float out[R * DMAX + 1];
  const int D = a.D, N = a.N, SD = a.SD, M = a.M;
  const int slot = blockIdx.x;
  const long long l = blockIdx.y;
  const int n_slots = a.n_chunks + D;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* x = a.x + l * a.x_ls;
  float* dx_slab = a.dx_slab + (l * n_slots + slot) * (long long)N * D;

  // stages the rows of the tile at t0 and their cotangents; rows past N
  // carry x = 0 and g = 0, so every term they add is 0
  auto load_tile = [&](int t0) {
    __syncthreads();
    for (int t = tid; t < R * D; t += nt) {
      const int n = t0 + t / D;
      const bool in = n < N;
      xs[t] = in ? x[(long long)n * D + t % D] : 0.f;
      gsm[t] = in ? a.g[(l * N + n) * D + t % D] : 0.f;
    }
    __syncthreads();
  };

  if (slot < a.n_chunks) {
    // -- ORFF prior: column c of every output column i, for all rows
    const float* omf = a.omf + l * a.omf_ls;
    const float* G = a.G + l * a.G_ls;
    const int c = slot * nt + tid;
    const bool own = c < SD;
    float om[DMAX], gc[DMAX], gsn[DMAX], ob[DMAX], gcb[DMAX], gsb[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      const bool use = own && i < D;
      om[i] = use ? __ldg(omf + (long long)i * SD + c) : 0.f;
      gc[i] = use ? __ldg(G + (long long)c * D + i) : 0.f;
      gsn[i] = use ? __ldg(G + ((long long)SD + c) * D + i) : 0.f;
      ob[i] = 0.f;
      gcb[i] = 0.f;
      gsb[i] = 0.f;
    }
    const float ph = own ? __ldg(a.phf + l * a.phf_ls + c) : 0.f;
    float pb = 0.f;
    for (int t0 = 0; t0 < N; t0 += R) {
      load_tile(t0);
      float dxr[R][DMAX];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int d = 0; d < DMAX; ++d) dxr[r][d] = 0.f;
      if (own) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float u = ph;
#pragma unroll
          for (int d = 0; d < DMAX; ++d)
            if (d < D) u = fmaf(xs[r * D + d], om[d], u);
          float sn, cs;
          sincosf(u, &sn, &cs);
          float dc = 0.f, ds = 0.f;
#pragma unroll
          for (int i = 0; i < DMAX; ++i)
            if (i < D) {
              const float gg = gsm[r * D + i];
              gcb[i] = fmaf(cs, gg, gcb[i]);
              gsb[i] = fmaf(sn, gg, gsb[i]);
              dc = fmaf(gg, gc[i], dc);
              ds = fmaf(gg, gsn[i], ds);
            }
          const float du = cs * ds - sn * dc;
          pb += du;
#pragma unroll
          for (int d = 0; d < DMAX; ++d)
            if (d < D) {
              ob[d] = fmaf(xs[r * D + d], du, ob[d]);
              dxr[r][d] = du * om[d];
            }
        }
      }
      df::reduce_rows<R, DMAX>(dxr, 0.f, D, red, out);
      for (int t = tid; t < R * D; t += nt) {
        const int n = t0 + t / D;
        if (n < N) dx_slab[(long long)n * D + t % D] = out[t];
      }
    }
    if (own) {
      a.dphf[l * SD + c] = pb;
      float* dG = a.dG + l * 2LL * SD * D;
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < D) {
          a.domf[(l * D + i) * SD + c] = ob[i];
          dG[(long long)c * D + i] = gcb[i];
          dG[((long long)SD + c) * D + i] = gsb[i];
        }
    }
    return;
  }

  // -- matrix-valued update of output column i
  const int i = slot - a.n_chunks;
  const float* z = a.z + l * a.z_ls;
  const float* nur = a.nur + l * a.nur_ls;
  df::load_par(par, a.ls2 + l * a.ls2_ls, a.var + l * a.var_ls, D);
  __syncthreads();
  const float* inv = par;
  const float vi = par[D * D + i];
  float dl[1][DMAX];              // ls2[j, i] cotangent over j, this thread
  float dv = 0.f;                 // var_i cotangent, this thread
#pragma unroll
  for (int j = 0; j < DMAX; ++j) dl[0][j] = 0.f;
  for (int m0 = 0; m0 < M; m0 += nt) {
    const int m = m0 + tid;
    const bool own = m < M;
    float zm[DMAX], nu[DMAX], dz[DMAX], dnu[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      const bool use = own && k < D;
      zm[k] = use ? __ldg(z + (long long)m * D + k) : 0.f;
      nu[k] = use ? __ldg(nur + (long long)m * D + k) : 0.f;
      dz[k] = 0.f;
      dnu[k] = 0.f;
    }
    const float zi = own ? __ldg(z + (long long)m * D + i) : 0.f;
    for (int t0 = 0; t0 < N; t0 += R) {
      load_tile(t0);
      float dxr[R][DMAX];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int d = 0; d < DMAX; ++d) dxr[r][d] = 0.f;
      if (own) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float dk[DMAX], dd[DMAX];
          float sq = 0.f, sqb = 0.f, ddi = 0.f;
#pragma unroll
          for (int k = 0; k < DMAX; ++k) {
            dk[k] = k < D ? xs[r * D + k] - zm[k] : 0.f;
            sq = fmaf(dk[k], dk[k], sq);
            dd[k] = 0.f;
          }
          const float di = xs[r * D + i] - zi;
          const float gi = gsm[r * D + i];
#pragma unroll (DMAX <= 8 ? DMAX : 1)
          for (int j = 0; j < DMAX; ++j) {
            if (j >= D) continue;
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
            dl[0][j] -= ivb * iv * iv;
          }
#pragma unroll
          for (int k = 0; k < DMAX; ++k)
            if (k < D) {
              float t = fmaf(2.f * dk[k], sqb, dd[k]);
              if (k == i) t += ddi;
              dxr[r][k] += t;
              dz[k] -= t;
            }
        }
      }
      df::reduce_rows<R, DMAX>(dxr, 0.f, D, red, out);
      for (int t = tid; t < R * D; t += nt) {
        const int n = t0 + t / D;
        if (n < N) {
          float* o = dx_slab + (long long)n * D + t % D;
          *o = (m0 == 0 ? 0.f : *o) + out[t];
        }
      }
    }
    if (own) {
      const long long o = ((l * D + i) * M + m) * D;
#pragma unroll
      for (int k = 0; k < DMAX; ++k)
        if (k < D) {
          a.dz_slab[o + k] = dz[k];
          a.dnur_slab[o + k] = dnu[k];
        }
    }
  }
  df::reduce_rows<1, DMAX>(dl, dv, D, red, out);
  for (int j = tid; j < D; j += nt) a.dls2[(l * D + j) * D + i] = out[j];
  if (tid == 0) a.dvar[l * D + i] = out[D];
}

}  // namespace

// Feature columns per chunk slot: n_slots = ceil(SD / chunk) + D.
extern "C" int df_pathwise_tiled_bwd_chunk() { return df::kThreads; }

// Launches the VJP kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes it does not take (D above 16, L above
// the grid's 65535). Operands as in df_pathwise_tiled_fwd; g is (L, N, D);
// the outputs are laid out as BwdArgs states, and every entry is written.
extern "C" int df_pathwise_tiled_bwd(
    const float* x, long long x_ls, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* G, long long G_ls,
    const float* z, long long z_ls, const float* nur, long long nur_ls,
    const float* ls2, long long ls2_ls, const float* var, long long var_ls,
    const float* g, float* dx_slab, float* domf, float* dphf, float* dG,
    float* dz_slab, float* dnur_slab, float* dls2, float* dvar, int L, int N,
    int D, int SD, int M, int device, void* stream) {
  const int R = df::rows_for(D);
  if (L < 1 || N < 1 || SD < 1 || M < 1 || R == 0 || L > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  BwdArgs a;
  a.x = x; a.omf = omf; a.phf = phf; a.G = G; a.z = z; a.nur = nur;
  a.ls2 = ls2; a.var = var;
  a.x_ls = x_ls; a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.G_ls = G_ls;
  a.z_ls = z_ls; a.nur_ls = nur_ls; a.ls2_ls = ls2_ls; a.var_ls = var_ls;
  a.g = g; a.dx_slab = dx_slab; a.domf = domf; a.dphf = dphf; a.dG = dG;
  a.dz_slab = dz_slab; a.dnur_slab = dnur_slab; a.dls2 = dls2; a.dvar = dvar;
  a.N = N; a.D = D; a.SD = SD; a.M = M;
  a.n_chunks = (SD + df::kThreads - 1) / df::kThreads;

  const dim3 grid(a.n_chunks + D, L);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 8)
    df_pathwise_tiled_bwd_kernel<4, 8><<<grid, df::kThreads, 0, s>>>(a);
  else
    df_pathwise_tiled_bwd_kernel<2, 16><<<grid, df::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
