// Per-step pathwise evaluation of the dimwise-RBF GP sample, one launch for
// all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_pathwise_kernel` of
// vae_gp_ode_tpu/ops/pathwise.py (called through `fused_pathwise_eval`). It
// computes what `pathwise_eval_reference` computes, per draw l, batch row n
// and output dim k:
//
//   f_k(x) = sqrt(var_k / S) sum_s cos(x . omega[:, s, k] + phase[s, k]) w[s, k]
//          + var_k sum_m exp(-0.5 sum_d ((x_d - Z[m, d]) / ls[k, d])^2) nu[k, m]
//
// on the operands' own layouts: x (N, D), omega (D, S, K), phase (1, S, K),
// weights (S, K), Z (M, D), nu (K, M), ls (K, D), var (K,), each either per
// draw (element stride `*_ls` between draws) or shared by all draws (stride
// 0). Output (L, N, K). The squared distance is summed over (x - Z) / ls
// directly rather than expanded into norms and a cross term, which avoids
// the cancellation of the expanded form.
//
// Design. The TPU kernel loops over k statically and does two MXU matmuls
// per k. Here one thread block owns one (row tile of kRows rows, output dim
// k, draw l): it keeps its rows and 1/ls[k, :] in shared memory, its threads
// stride over the S features and then the M inducing points with kRows
// per-row f32 accumulators in registers, and the block reduces them with
// warp shuffles and one pass over the warps' partials. Any N, D, K, S and M
// is taken: rows and output dims are grid dimensions, features and inducing
// points are loops, and shared memory holds only (kRows + 1) D floats.
//
// What bounds it on an H100. At the main path's shapes (L=5, N=20, D=K=6,
// S=256, M=100) one launch is about 2.3 MFLOP on 0.2 MB of operands: well
// under a microsecond of f32 or memory time. The kernel is bound instead by
// launch latency and by the dependent chain of loads, cosf/expf and the
// block reduction. wgmma, TMA and persistent blocks are later work.
//
// Accuracy. Accurate cosf/expf, no fast-math (arguments x . omega can be
// large, where __cosf loses accuracy). Everything is f32, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;        // batch rows per block
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct FwdArgs {
  const float* x;      // (N, D)
  const float* omega;  // (D, S, K)
  const float* phase;  // (1, S, K)
  const float* w;      // (S, K)
  const float* z;      // (M, D)
  const float* nu;     // (K, M)
  const float* ls;     // (K, D)
  const float* var;    // (K,)
  long long x_ls, om_ls, ph_ls, w_ls, z_ls, nu_ls, ls_ls, var_ls;
  float* out;          // (L, N, K)
  int N, D, K, S, M;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) pathwise_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps][2 * kRows];
  const int D = a.D, K = a.K, S = a.S, M = a.M, N = a.N;
  const int k = blockIdx.y;
  const long long l = blockIdx.z;
  const int r0 = blockIdx.x * kRows;
  const long long SK = (long long)S * K;

  float* xs = smem;                 // kRows * D  the block's rows
  float* ils = xs + kRows * D;      // D          1 / ls[k, :]

  const float* x = a.x + l * a.x_ls;
  const float* omega = a.omega + l * a.om_ls;
  const float* phase = a.phase + l * a.ph_ls;
  const float* w = a.w + l * a.w_ls;
  const float* z = a.z + l * a.z_ls;
  const float* nu = a.nu + l * a.nu_ls;
  const float* ls = a.ls + l * a.ls_ls;
  const float* var = a.var + l * a.var_ls;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // rows past N evaluate zeros and are never written
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int n = r0 + i / D;
    xs[i] = n < N ? x[(long long)n * D + i % D] : 0.f;
  }
  for (int d = tid; d < D; d += blockDim.x) ils[d] = 1.f / ls[k * D + d];
  __syncthreads();

  float acc1[kRows], acc2[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) { acc1[r] = 0.f; acc2[r] = 0.f; }

  // prior term over the features s of output dim k
  for (int s = tid; s < S; s += blockDim.x) {
    const long long c = (long long)s * K + k;
    float xo[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) xo[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float o = __ldg(omega + d * SK + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) xo[r] = fmaf(xs[r * D + d], o, xo[r]);
    }
    const float ph = __ldg(phase + c);
    const float wv = __ldg(w + c);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc1[r] = fmaf(cosf(xo[r] + ph), wv, acc1[r]);
  }

  // update term over the inducing points m
  for (int m = tid; m < M; m += blockDim.x) {
    float d2[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) d2[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float zv = __ldg(z + (long long)m * D + d);
      const float il = ils[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float df = (xs[r * D + d] - zv) * il;
        d2[r] = fmaf(df, df, d2[r]);
      }
    }
    const float nv = __ldg(nu + (long long)k * M + m);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      acc2[r] = fmaf(expf(-0.5f * d2[r]), nv, acc2[r]);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float s1 = warp_sum(acc1[r]);
    const float s2 = warp_sum(acc2[r]);
    if (lane == 0) {
      red[warp][r] = s1;
      red[warp][kRows + r] = s2;
    }
  }
  __syncthreads();
  if (tid < kRows) {
    const int n = r0 + tid;
    if (n < N) {
      float f1 = 0.f, f2 = 0.f;
      for (int v = 0; v < kWarps; ++v) {
        f1 += red[v][tid];
        f2 += red[v][kRows + tid];
      }
      const float vk = var[k];
      a.out[(l * N + n) * K + k] = sqrtf(vk / (float)S) * f1 + vk * f2;
    }
  }
}

}  // namespace

// Rows per block: the grid has ceil(N / rows) row tiles.
extern "C" int pathwise_fwd_rows() { return kRows; }

// Launches the per-step eval on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes it does not take (L or K above the grid's
// 65535, or rows and 1/ls above 48 KB of shared memory). Operands are f32
// and contiguous; each `*_ls` is the element stride between draws (0 for an
// operand that all draws share). out is (L, N, K); every entry is written.
extern "C" int pathwise_fwd(
    const float* x, long long x_ls, const float* omega, long long om_ls,
    const float* phase, long long ph_ls, const float* w, long long w_ls,
    const float* z, long long z_ls, const float* nu, long long nu_ls,
    const float* ls, long long ls_ls, const float* var, long long var_ls,
    float* out, int L, int N, int D, int K, int S, int M, int device,
    void* stream) {
  if (L < 1 || N < 1 || D < 1 || K < 1 || S < 1 || M < 1 || L > 65535 ||
      K > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(kRows + 1) * D;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  FwdArgs a;
  a.x = x; a.omega = omega; a.phase = phase; a.w = w; a.z = z; a.nu = nu;
  a.ls = ls; a.var = var;
  a.x_ls = x_ls; a.om_ls = om_ls; a.ph_ls = ph_ls; a.w_ls = w_ls;
  a.z_ls = z_ls; a.nu_ls = nu_ls; a.ls_ls = ls_ls; a.var_ls = var_ls;
  a.out = out;
  a.N = N; a.D = D; a.K = K; a.S = S; a.M = M;

  const dim3 grid((N + kRows - 1) / kRows, K, L);
  pathwise_fwd_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
