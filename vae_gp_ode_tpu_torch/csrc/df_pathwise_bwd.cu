// Reverse mode (VJP) of the per-step DF pathwise evaluation in
// df_pathwise_fwd.cu, one launch for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_make_bwd_kernel` of
// vae_gp_ode_tpu/ops/df_pathwise.py (`_df_eval_vjp_body`,
// `_df_update_vjp_body`). It computes what autograd through
// `df_pathwise_reference` computes for a cotangent g (L, N, D), recomputing
// the forward intermediates instead of storing them (df_common.cuh
// `vjp_accumulate` states the terms).
//
// Outputs: dx (L, N, D) per row, and per block one slab of operand
// cotangents [omf (D, SD) | phf (SD) | G (2SD, D) | Z (M, D) | nur (M, D) |
// ls2 (D, D) | var (D)] in (L, n_tiles, P). The wrapper sums the slabs
// over row tiles, and over draws for operands that all draws share: blocks
// never write to the same address, so the result does not depend on the
// order in which blocks run (no atomics). The continuous adjoint needs each
// draw's own cotangent of Z, ls2, var and G, which the per-draw slabs give.
//
// Design. One thread block owns one draw and R batch rows (4 up to D = 8,
// 2 up to D = 16). It zeroes its slab in global memory, then each thread
// adds the cotangents of the feature columns and inducing points it owns
// straight into the slab (no other thread touches them); dx, the ls2 and
// var cotangents are per-thread register partials summed over the block at
// the end. Any N, S and M is taken (the slab lives in global memory, so the
// shared memory does not grow with S or M); D above 16 is refused.
//
// What bounds it on an H100. Recompute and VJP are about SD(6D + 10) +
// M D^2 ~ 40 operations per row: ~150 kFLOP at the main shapes, 15 MFLOP
// at L*N = 100 rows (0.2 us at 67 TFLOP/s f32), about the time of its
// bytes (omf, G and their slabs). Bound in practice by launch latency and
// by the chain of loads, sincosf/expf and the global read-modify-writes of
// the slab, with L*ceil(N/R) blocks. wgmma, TMA and tuning are later work.

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
  float* dx;         // (L, N, D)
  float* slab;       // (L, n_tiles, P)
  int N, D, SD, M;
  long long P;       // floats per slab
};

long long slab_floats(int D, int SD, int M) {
  return (long long)D * SD + SD + 2LL * SD * D + 2LL * M * D +
         (long long)D * D + D;
}

template <int R, int DMAX>
__global__ void __launch_bounds__(df::kThreads)
    df_pathwise_bwd_kernel(BwdArgs a) {
  __shared__ float xs[R * DMAX];
  __shared__ float gsm[R * DMAX];
  __shared__ float par[DMAX * DMAX + DMAX];
  __shared__ float red[df::kWarps * (DMAX * DMAX + DMAX)];
  __shared__ float out[DMAX * DMAX + DMAX];
  const int D = a.D, N = a.N, SD = a.SD, M = a.M;
  const long long l = blockIdx.y;
  const int tile = blockIdx.x;
  const int r0 = tile * R;
  const float* x = a.x + l * a.x_ls;
  const df::Draw p = {a.omf + l * a.omf_ls, a.phf + l * a.phf_ls,
                      a.G + l * a.G_ls, a.z + l * a.z_ls,
                      a.nur + l * a.nur_ls};
  float* slab = a.slab + (l * gridDim.x + tile) * a.P;
  const df::Bars b = {slab, slab + (long long)D * SD,
                      slab + (long long)D * SD + SD,
                      slab + (long long)D * SD + SD + 2LL * SD * D,
                      slab + (long long)D * SD + SD + 2LL * SD * D +
                          (long long)M * D};
  float* dls2 = b.nur + (long long)M * D;     // (D, D) then var (D)

  // rows past N carry x = 0 and g = 0: every term they add is scaled by g
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int n = r0 + i / D;
    xs[i] = n < N ? x[(long long)n * D + i % D] : 0.f;
    gsm[i] = n < N ? a.g[(l * N + n) * D + i % D] : 0.f;
  }
  df::load_par(par, a.ls2 + l * a.ls2_ls, a.var + l * a.var_ls, D);
  for (long long i = threadIdx.x; i < a.P; i += blockDim.x) slab[i] = 0.f;
  __syncthreads();

  float dx[R][DMAX], dl[DMAX * DMAX], dv[DMAX];
  float fg = 0.f;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) dx[r][i] = 0.f;
#pragma unroll
    for (int j = 0; j < DMAX; ++j) dl[i * DMAX + j] = 0.f;
    dv[i] = 0.f;
  }
  df::vjp_accumulate<R, DMAX>(p, xs, gsm, 1.f, par, D, SD, M, b, dx, dl, dv,
                              fg);

  // dx per row (red and out reused: R*D + 1 <= DMAX*DMAX + DMAX)
  df::reduce_rows<R, DMAX>(dx, 0.f, D, red, out);
  for (int t = threadIdx.x; t < R * D; t += blockDim.x) {
    const int n = r0 + t / D;
    if (n < N) a.dx[(l * N + n) * D + t % D] = out[t];
  }
  df::reduce_params<DMAX>(dl, dv, D, red, out);
  for (int t = threadIdx.x; t < D * D + D; t += blockDim.x) dls2[t] = out[t];
}

}  // namespace

// Floats per block slab of operand cotangents, for the wrapper to size
// `slab` (L, n_tiles, P) and to split it.
extern "C" long long df_pathwise_bwd_slab_floats(int D, int SD, int M) {
  return slab_floats(D, SD, M);
}

// Rows per block for state dim D (0 for a D the kernel refuses):
// n_tiles = ceil(N / rows).
extern "C" int df_pathwise_bwd_rows(int D) { return df::rows_for(D); }

// Launches the VJP kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes it does not take (D above 16, L above
// the grid's 65535). Operands as in df_pathwise_fwd; g is (L, N, D), dx
// (L, N, D), slab (L, ceil(N/rows), P); every slab entry and every dx row is
// written.
extern "C" int df_pathwise_bwd(
    const float* x, long long x_ls, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* G, long long G_ls,
    const float* z, long long z_ls, const float* nur, long long nur_ls,
    const float* ls2, long long ls2_ls, const float* var, long long var_ls,
    const float* g, float* dx, float* slab, int L, int N, int D, int SD,
    int M, int device, void* stream) {
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
  a.g = g; a.dx = dx; a.slab = slab;
  a.N = N; a.D = D; a.SD = SD; a.M = M;
  a.P = slab_floats(D, SD, M);

  const dim3 grid((N + R - 1) / R, L);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 8)
    df_pathwise_bwd_kernel<4, 8><<<grid, df::kThreads, 0, s>>>(a);
  else
    df_pathwise_bwd_kernel<2, 16><<<grid, df::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
