// Discrete adjoint (reverse mode) of the whole DF euler trajectory of
// df_flow_fused.cu, one launch for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_make_bwd_kernel` of
// vae_gp_ode_tpu/ops/df_flow_fused.py. It computes what autograd through
// `df_euler_flow_reference` computes (`df_flow_vjp_reference`). Per draw l
// and batch row it walks t = T-2 .. 0 and recomputes the step's forward
// intermediates from the saved state z_t instead of storing them:
//
//   g_{T-1}    = zsbar[T-1]
//   g_t        = zsbar[t] + g_{t+1} + (d f / d z_t)^T (dt_t g_{t+1})
//   param_bar += (d f / d param)^T (dt_t g_{t+1})
//   dtsbar[t]  = <g_{t+1}, f(z_t)>
//
// Outputs: z0bar (L, N, D) per draw, and per block one slab of parameter
// cotangents [omf (D, SD) | phf (SD) | G (2SD, D) | Z (M, D) | nur (M, D) |
// ls2 (D, D) | var (D) | dts (T-1)] in (L, n_tiles, P). The wrapper sums
// the slabs over row tiles, and over draws for operands that all draws
// share: blocks never write to the same address (no atomics).
//
// Design. One thread block owns one draw and R batch rows (4 up to D = 8,
// 2 up to D = 16), as in the forward. Each thread owns fixed feature columns
// and inducing points for the whole walk and accumulates their cotangents
// in the block's slab in shared memory (df_common.cuh `vjp_accumulate`),
// which no other thread touches; the ls2 and var cotangents stay in
// per-thread registers until the end. The state cotangent and <g, f> are
// summed over the block every step. At the main shapes (D=6, S=256, M=100,
// T=16) the slab is 30,441 floats and a block needs 123,768 bytes of
// shared memory, above the 48 KB default: the launch raises the block's
// dynamic shared memory limit, and refuses shapes above the device's opt-in
// limit (232,448 bytes on an H100; S=512 at D=6 needs more).
// df_flow_fused_bwd_smem_bytes exports the need, so the caller can decide
// before the forward whether this pair of kernels will run.
//
// What bounds it on an H100. Per row and step the recompute and the VJP are
// ~150 kFLOP at the main shapes; a train step has L*N*(T-1) = 300 (L=1) or
// 1500 (L=5) row-steps, 45 / 225 MFLOP, 0.7 / 3.4 us at 67 TFLOP/s f32.
// Bound in practice by launch latency and by its T-1 dependent steps, each a
// chain of loads, sincosf/expf and two block reductions. wgmma, TMA and
// tuning are later work.

#include "df_common.cuh"

namespace {

struct BwdArgs {
  const float* zs;     // (L, T, N, D) forward trajectory
  const float* zsbar;  // (L, T, N, D) its cotangent
  const float* omf;    // (D, SD)   per draw at omf_ls (0 = shared)
  const float* phf;    // (1, SD)
  const float* G;      // (2SD, D)
  const float* z;      // (M, D)
  const float* nur;    // (M, D)
  const float* ls2;    // (D, D)
  const float* var;    // (D,)
  long long omf_ls, phf_ls, G_ls, z_ls, nur_ls, ls2_ls, var_ls;
  const float* dts;    // (T-1,)
  float* z0bar;        // (L, N, D)
  float* slab;         // (L, n_tiles, P)
  int N, D, SD, M, T;
  long long P;         // floats per slab
};

long long slab_floats(int D, int SD, int M, int T) {
  return (long long)D * SD + SD + 2LL * SD * D + 2LL * M * D +
         (long long)D * D + D + (T - 1);
}

__host__ __device__ int red_floats(int D, int R) {
  const int a = R * D + 1, b = D * D + D;
  return a > b ? a : b;
}

size_t smem_bytes(int D, int SD, int M, int T) {
  const int R = df::rows_for(D);
  return sizeof(float) *
         ((size_t)slab_floats(D, SD, M, T) + 3 * (size_t)R * D + D * D + D +
          (size_t)(df::kWarps + 1) * red_floats(D, R));
}

template <int R, int DMAX>
__global__ void __launch_bounds__(df::kThreads)
    df_flow_fused_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, N = a.N, SD = a.SD, M = a.M, T = a.T;
  const long long l = blockIdx.y;
  const int tile = blockIdx.x;
  const int r0 = tile * R;
  const int RD = R * D;
  const df::Draw p = {a.omf + l * a.omf_ls, a.phf + l * a.phf_ls,
                      a.G + l * a.G_ls, a.z + l * a.z_ls,
                      a.nur + l * a.nur_ls};
  const df::Bars b = {smem, smem + (long long)D * SD,
                      smem + (long long)D * SD + SD,
                      smem + (long long)D * SD + SD + 2LL * SD * D,
                      smem + (long long)D * SD + SD + 2LL * SD * D +
                          (long long)M * D};
  float* ls2bar = b.nur + (long long)M * D;   // (D, D) then var (D)
  float* dtsbar = ls2bar + D * D + D;         // (T-1,)
  float* g = smem + a.P;                      // RD  cotangent of z_{t+1}
  float* gn = g + RD;                         // RD  cotangent of z_t
  float* zt = gn + RD;                        // RD  z_t
  float* par = zt + RD;                       // D*D + D
  float* red = par + D * D + D;               // kWarps * V
  float* out = red + df::kWarps * red_floats(D, R);
  const float* zs = a.zs + l * T * N * D;
  const float* zsbar = a.zsbar + l * T * N * D;

  for (long long i = threadIdx.x; i < a.P; i += blockDim.x) smem[i] = 0.f;
  // rows past N carry g = 0 and z = 0 throughout: every contribution they
  // make is scaled by their g, so they add exactly nothing
  for (int i = threadIdx.x; i < RD; i += blockDim.x) {
    const int n = r0 + i / D;
    g[i] = n < N ? zsbar[((long long)(T - 1) * N + n) * D + i % D] : 0.f;
  }
  df::load_par(par, a.ls2 + l * a.ls2_ls, a.var + l * a.var_ls, D);

  float dl[DMAX * DMAX], dv[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
#pragma unroll
    for (int j = 0; j < DMAX; ++j) dl[i * DMAX + j] = 0.f;
    dv[i] = 0.f;
  }

  for (int t = T - 2; t >= 0; --t) {
    const float dt = __ldg(a.dts + t);
    for (int i = threadIdx.x; i < RD; i += blockDim.x) {
      const int n = r0 + i / D;
      zt[i] = n < N ? zs[((long long)t * N + n) * D + i % D] : 0.f;
    }
    __syncthreads();

    float dx[R][DMAX];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < DMAX; ++i) dx[r][i] = 0.f;
    float fg = 0.f;
    df::vjp_accumulate<R, DMAX>(p, zt, g, dt, par, D, SD, M, b, dx, dl, dv,
                                fg);
    df::reduce_rows<R, DMAX>(dx, fg, D, red, out);

    for (int i = threadIdx.x; i <= RD; i += blockDim.x) {
      if (i == RD) {
        dtsbar[t] = out[RD];
      } else {
        const int n = r0 + i / D;
        gn[i] = (n < N ? zsbar[((long long)t * N + n) * D + i % D] : 0.f) +
                g[i] + out[i];
      }
    }
    __syncthreads();
    float* tmp = g;
    g = gn;
    gn = tmp;
  }

  df::reduce_params<DMAX>(dl, dv, D, red, out);
  for (int i = threadIdx.x; i < D * D + D; i += blockDim.x)
    ls2bar[i] = out[i];
  for (int i = threadIdx.x; i < RD; i += blockDim.x) {
    const int n = r0 + i / D;
    if (n < N) a.z0bar[(l * N + n) * D + i % D] = g[i];
  }
  __syncthreads();
  float* slab = a.slab + (l * gridDim.x + tile) * a.P;
  for (long long i = threadIdx.x; i < a.P; i += blockDim.x) slab[i] = smem[i];
}

template <int R, int DMAX>
int launch(const BwdArgs& a, int L, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      df_flow_fused_bwd_kernel<R, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.N + R - 1) / R, L);
  df_flow_fused_bwd_kernel<R, DMAX><<<grid, df::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats per block slab of parameter cotangents, for the wrapper to size
// `slab` (L, n_tiles, P) and to split it.
extern "C" long long df_flow_fused_bwd_slab_floats(int D, int SD, int M,
                                                   int T) {
  return slab_floats(D, SD, M, T);
}

// Rows per block for state dim D (0 for a D the kernel refuses):
// n_tiles = ceil(N / rows).
extern "C" int df_flow_fused_bwd_rows(int D) { return df::rows_for(D); }

// Dynamic shared memory one block needs at these shapes; the launch refuses
// shapes where it exceeds df_flow_fused_bwd_smem_optin(device), so a caller
// can decide before the forward whether the pair of kernels will run.
extern "C" long long df_flow_fused_bwd_smem_bytes(int D, int SD, int M,
                                                  int T) {
  return (long long)smem_bytes(D, SD, M, T);
}

// The device's opt-in shared memory per block, or -1 if it cannot be read.
extern "C" int df_flow_fused_bwd_smem_optin(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin;
}

// Launches the adjoint kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes it does not take (D above 16, L above
// the grid's 65535, or a block's shared memory above the opt-in limit).
// Operands are f32 and contiguous; each `*_ls` is the element stride between
// draws (0 for an operand that all draws share). zs and zsbar are
// (L, T, N, D), z0bar (L, N, D), slab (L, ceil(N/rows), P); every slab entry
// and every z0bar row is written.
extern "C" int df_flow_fused_bwd(
    const float* zs, const float* zsbar, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* G, long long G_ls,
    const float* z, long long z_ls, const float* nur, long long nur_ls,
    const float* ls2, long long ls2_ls, const float* var, long long var_ls,
    const float* dts, float* z0bar, float* slab, int L, int N, int D, int SD,
    int M, int T, int device, void* stream) {
  if (L < 1 || N < 1 || SD < 1 || M < 1 || T < 2 ||
      df::rows_for(D) == 0 || L > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(D, SD, M, T);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;

  BwdArgs a;
  a.zs = zs; a.zsbar = zsbar;
  a.omf = omf; a.phf = phf; a.G = G; a.z = z; a.nur = nur; a.ls2 = ls2;
  a.var = var;
  a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.G_ls = G_ls; a.z_ls = z_ls;
  a.nur_ls = nur_ls; a.ls2_ls = ls2_ls; a.var_ls = var_ls;
  a.dts = dts; a.z0bar = z0bar; a.slab = slab;
  a.N = N; a.D = D; a.SD = SD; a.M = M; a.T = T;
  a.P = slab_floats(D, SD, M, T);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 8 ? launch<4, 8>(a, L, smem, s) : launch<2, 16>(a, L, smem, s);
}
