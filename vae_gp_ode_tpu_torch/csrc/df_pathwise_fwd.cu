// Per-step pathwise evaluation of the divergence-free (DF) GP sample, one
// launch for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_make_fwd_kernel` of
// vae_gp_ode_tpu/ops/df_pathwise.py (`_df_eval_body`, `_df_update_body`),
// called through `fused_df_pathwise_eval`. It computes what
// `df_pathwise_reference` computes (df_common.cuh states the function) on
// x (N, D), omf (D, SD), phf (1, SD), G (2SD, D), Z (M, D), nur (M, D),
// ls2 (D, D) and var (D,), each either per draw (element stride `*_ls`
// between draws) or shared by all draws (stride 0). Output (L, N, D).
//
// Design. One thread block owns one draw and R batch rows (4 up to D = 8,
// 2 up to D = 16) and keeps the rows, 1/ls2 and var in shared memory. Its
// threads stride over the S*D feature columns (x . omf, cos/sin, the G
// contraction) and then over the M inducing points (the D^2 output-dim
// pairs of the matrix-valued update), with per-row partials in registers,
// and the block sums them with warp shuffles (df_common.cuh). Any N, S and
// M is taken; D above 16 is refused.
//
// What bounds it on an H100. Per row it does about SD(2D + 3) trig-and-FMA
// operations for the prior and M D^2 ~ 12 for the update: at the main
// shapes (D=6, S=256, M=100) ~95 kFLOP, 9.5 MFLOP for L*N = 100 rows
// (0.14 us at 67 TFLOP/s f32), on ~0.55 MB of per-draw omf and G at L=5
// (0.17 us at 3.35 TB/s): bound by bytes on paper, and in practice by
// launch latency and the dependent chain of loads, sincosf/expf and the
// block reduction, with only L*ceil(N/R) blocks. wgmma, TMA and tuning are
// later work.

#include "df_common.cuh"

namespace {

struct FwdArgs {
  const float* x;    // (N, D)
  const float* omf;  // (D, SD)
  const float* phf;  // (1, SD)
  const float* G;    // (2SD, D)
  const float* z;    // (M, D)
  const float* nur;  // (M, D)
  const float* ls2;  // (D, D)
  const float* var;  // (D,)
  long long x_ls, omf_ls, phf_ls, G_ls, z_ls, nur_ls, ls2_ls, var_ls;
  float* out;        // (L, N, D)
  int N, D, SD, M;
};

template <int R, int DMAX>
__global__ void __launch_bounds__(df::kThreads)
    df_pathwise_fwd_kernel(FwdArgs a) {
  __shared__ float xs[R * DMAX];
  __shared__ float par[DMAX * DMAX + DMAX];
  __shared__ float red[df::kWarps * (R * DMAX + 1)];
  __shared__ float f[R * DMAX + 1];
  const int D = a.D, N = a.N;
  const long long l = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const float* x = a.x + l * a.x_ls;
  const df::Draw p = {a.omf + l * a.omf_ls, a.phf + l * a.phf_ls,
                      a.G + l * a.G_ls, a.z + l * a.z_ls,
                      a.nur + l * a.nur_ls};

  // rows past N evaluate zeros and are never written
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int n = r0 + i / D;
    xs[i] = n < N ? x[(long long)n * D + i % D] : 0.f;
  }
  df::load_par(par, a.ls2 + l * a.ls2_ls, a.var + l * a.var_ls, D);
  __syncthreads();

  float acc[R][DMAX];
  df::eval_partials<R, DMAX>(p, xs, par, D, a.SD, a.M, acc);
  df::reduce_rows<R, DMAX>(acc, 0.f, D, red, f);
  for (int t = threadIdx.x; t < R * D; t += blockDim.x) {
    const int n = r0 + t / D;
    if (n < N) a.out[(l * N + n) * D + t % D] = f[t];
  }
}

}  // namespace

// Rows per block for state dim D (0 for a D the kernel refuses): the grid
// has ceil(N / rows) row tiles.
extern "C" int df_pathwise_fwd_rows(int D) { return df::rows_for(D); }

// Launches the per-step eval on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes it does not take (D above 16, L above
// the grid's 65535). Operands are f32 and contiguous; each `*_ls` is the
// element stride between draws (0 for an operand that all draws share).
// out is (L, N, D); every entry is written.
extern "C" int df_pathwise_fwd(
    const float* x, long long x_ls, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* G, long long G_ls,
    const float* z, long long z_ls, const float* nur, long long nur_ls,
    const float* ls2, long long ls2_ls, const float* var, long long var_ls,
    float* out, int L, int N, int D, int SD, int M, int device,
    void* stream) {
  const int R = df::rows_for(D);
  if (L < 1 || N < 1 || SD < 1 || M < 1 || R == 0 || L > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  FwdArgs a;
  a.x = x; a.omf = omf; a.phf = phf; a.G = G; a.z = z; a.nur = nur;
  a.ls2 = ls2; a.var = var;
  a.x_ls = x_ls; a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.G_ls = G_ls;
  a.z_ls = z_ls; a.nur_ls = nur_ls; a.ls2_ls = ls2_ls; a.var_ls = var_ls;
  a.out = out;
  a.N = N; a.D = D; a.SD = SD; a.M = M;

  const dim3 grid((N + R - 1) / R, L);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 8)
    df_pathwise_fwd_kernel<4, 8><<<grid, df::kThreads, 0, s>>>(a);
  else
    df_pathwise_fwd_kernel<2, 16><<<grid, df::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
