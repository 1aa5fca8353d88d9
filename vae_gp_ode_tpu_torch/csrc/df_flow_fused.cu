// Whole euler trajectory of the divergence-free (DF) pathwise GP sample, one
// launch for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_make_fwd_kernel` of
// vae_gp_ode_tpu/ops/df_flow_fused.py (called through
// `packed_df_euler_flow`). It computes what `df_euler_flow_reference`
// computes, per draw l and batch row:
//
//   z_{t+1} = z_t + dts[t] f(z_t),   zs[l, 0] = z0,
//
// f the DF evaluation of df_pathwise_fwd.cu (df_common.cuh states it), on
// the same operands, each per draw (stride `*_ls`) or shared (stride 0).
// DF flows are first order only (D_in = D_out), as in the JAX package.
//
// Design. One thread block owns one draw and R batch rows (4 up to D = 8,
// 2 up to D = 16) and keeps their state, 1/ls2 and var in shared memory
// through all T-1 steps; each step is df_common.cuh's block evaluation
// (feature columns, then inducing points, then a block reduction) and the
// euler update, and writes zs[l, t+1] for its rows. The draw's operands
// (~45 KB per draw at the main shapes) are read from global memory each step
// and stay in L2. Any N, S and M is taken; D above 16 is refused.
//
// What bounds it on an H100. T-1 evaluations of ~95 kFLOP per row at the
// main shapes (D=6, S=256, M=100): 143 MFLOP at L=5, N=20, T=16, about 2 us
// at 67 TFLOP/s f32, above its bytes: bound by operations on paper. In
// practice by launch latency and its T-1 dependent steps, each a chain of
// loads, sincosf/expf and a block reduction, with L*ceil(N/R) blocks.

#include "df_common.cuh"

namespace {

struct FlowArgs {
  const float* z0;   // (N, D) per draw at z0_ls (0 = shared)
  const float* omf;  // (D, SD)
  const float* phf;  // (1, SD)
  const float* G;    // (2SD, D)
  const float* z;    // (M, D)
  const float* nur;  // (M, D)
  const float* ls2;  // (D, D)
  const float* var;  // (D,)
  long long z0_ls, omf_ls, phf_ls, G_ls, z_ls, nur_ls, ls2_ls, var_ls;
  const float* dts;  // (T-1,)
  float* zs;         // (L, T, N, D)
  int N, D, SD, M, T;
};

template <int R, int DMAX>
__global__ void __launch_bounds__(df::kThreads)
    df_flow_fused_fwd_kernel(FlowArgs a) {
  __shared__ float zcur[R * DMAX];
  __shared__ float par[DMAX * DMAX + DMAX];
  __shared__ float red[df::kWarps * (R * DMAX + 1)];
  __shared__ float f[R * DMAX + 1];
  const int D = a.D, N = a.N;
  const long long l = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const float* z0 = a.z0 + l * a.z0_ls;
  const df::Draw p = {a.omf + l * a.omf_ls, a.phf + l * a.phf_ls,
                      a.G + l * a.G_ls, a.z + l * a.z_ls,
                      a.nur + l * a.nur_ls};
  float* zs = a.zs + l * a.T * N * D;

  // rows past N integrate zeros and are never written
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int n = r0 + i / D;
    const float v = n < N ? z0[(long long)n * D + i % D] : 0.f;
    zcur[i] = v;
    if (n < N) zs[(long long)n * D + i % D] = v;
  }
  df::load_par(par, a.ls2 + l * a.ls2_ls, a.var + l * a.var_ls, D);
  __syncthreads();

  for (int t = 0; t < a.T - 1; ++t) {
    float acc[R][DMAX];
    df::eval_partials<R, DMAX>(p, zcur, par, D, a.SD, a.M, acc);
    df::reduce_rows<R, DMAX>(acc, 0.f, D, red, f);
    const float dt = __ldg(a.dts + t);
    for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
      const float v = fmaf(dt, f[i], zcur[i]);
      zcur[i] = v;
      const int n = r0 + i / D;
      if (n < N) zs[((long long)(t + 1) * N + n) * D + i % D] = v;
    }
    __syncthreads();
  }
}

}  // namespace

// Rows per block for state dim D (0 for a D the kernel refuses).
extern "C" int df_flow_fused_fwd_rows(int D) { return df::rows_for(D); }

// Launches the trajectory kernel on `stream` and returns cudaGetLastError(),
// or cudaErrorInvalidValue for shapes it does not take (D above 16, L above
// the grid's 65535). Operands are f32 and contiguous; each `*_ls` is the
// element stride between draws (0 for an operand that all draws share). zs
// is (L, T, N, D); every entry is written.
extern "C" int df_flow_fused_fwd(
    const float* z0, long long z0_ls, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* G, long long G_ls,
    const float* z, long long z_ls, const float* nur, long long nur_ls,
    const float* ls2, long long ls2_ls, const float* var, long long var_ls,
    const float* dts, float* zs, int L, int N, int D, int SD, int M, int T,
    int device, void* stream) {
  const int R = df::rows_for(D);
  if (L < 1 || N < 1 || SD < 1 || M < 1 || T < 1 || R == 0 || L > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  FlowArgs a;
  a.z0 = z0; a.omf = omf; a.phf = phf; a.G = G; a.z = z; a.nur = nur;
  a.ls2 = ls2; a.var = var;
  a.z0_ls = z0_ls; a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.G_ls = G_ls;
  a.z_ls = z_ls; a.nur_ls = nur_ls; a.ls2_ls = ls2_ls; a.var_ls = var_ls;
  a.dts = dts; a.zs = zs;
  a.N = N; a.D = D; a.SD = SD; a.M = M; a.T = T;

  const dim3 grid((N + R - 1) / R, L);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 8)
    df_flow_fused_fwd_kernel<4, 8><<<grid, df::kThreads, 0, s>>>(a);
  else
    df_flow_fused_fwd_kernel<2, 16><<<grid, df::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
