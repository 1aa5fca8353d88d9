// Grid-tiled per-step pathwise evaluation of the dimwise-RBF GP sample for
// wide shapes (many output dims K, many features S), one launch for all L
// Monte-Carlo draws.
//
// Replaces the Pallas kernel `_fwd_kernel` of
// vae_gp_ode_tpu/ops/pathwise_tiled.py. It computes the same function as
// pathwise_fwd.cu (`pathwise_eval_reference`), per draw l, row n, output k:
//
//   f_k(x) = sqrt(var_k / S) sum_s cos(x . omega[:, s, k] + phase[s, k]) w[s, k]
//          + var_k sum_m exp(-0.5 sum_d ((x_d - Z[m, d]) / ls[k, d])^2) nu[k, m]
//
// on the same operand layouts and draw strides as pathwise_fwd.cu.
//
// Design. The grid is (slot, row tile, draw * K). Slots 0 .. n_chunks-1 are
// feature chunks of kChunk columns: such a block evaluates the prior term of
// its kRows rows over its chunk of output dim k. Slot n_chunks is the
// S-independent inducing update of those rows for output dim k, so it runs
// beside the prior chunks and not after chunk 0. On the TPU the output was
// carried across consecutive grid steps; blocks on the card run in no
// order, so each block writes its scaled partial sum to its own entry of a
// slab part (L, n_slots, N, K), and the wrapper sums the slab over the
// slots. No atomics: the result does not depend on the order of blocks.
// Within a block each thread owns kChunk / kThreads columns (or inducing
// points), with kRows per-row f32 accumulators in registers, reduced over
// the block with warp shuffles. Any N, D, K, S and M is taken.
//
// What bounds it on an H100. At the wide shapes (L=5, N=20, D=K=12,
// S=1024, M=100) one launch does ~41 MFLOP on ~3.4 MB of per-draw omega,
// phase and weights: ~1 us of memory time, bound by bytes. The grid has
// L * ceil(N / kRows) * K * (ceil(S / kChunk) + 1) blocks (900 there), so
// unlike pathwise_fwd.cu the card's 132 SMs all have work; each block is a
// short chain of loads, cosf/expf and one block reduction. wgmma, TMA and
// tuning of kChunk are later work.
//
// Accuracy. Accurate cosf/expf, no fast-math (x . omega can be large);
// everything is f32, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;        // batch rows per block
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;     // feature columns per chunk slot

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
  float* part;         // (L, n_slots, N, K)
  int N, D, K, S, M, n_chunks;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    pathwise_tiled_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps][kRows];
  const int D = a.D, K = a.K, S = a.S, M = a.M, N = a.N;
  const int slot = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int k = blockIdx.z % K;
  const long long l = blockIdx.z / K;
  const long long SK = (long long)S * K;
  const int n_slots = a.n_chunks + 1;

  float* xs = smem;                 // kRows * D  the block's rows
  float* ils = xs + kRows * D;      // D          1 / ls[k, :]

  const float* x = a.x + l * a.x_ls;
  const float* omega = a.omega + l * a.om_ls;
  const float* phase = a.phase + l * a.ph_ls;
  const float* w = a.w + l * a.w_ls;
  const float* z = a.z + l * a.z_ls;
  const float* nu = a.nu + l * a.nu_ls;
  const float* ls = a.ls + l * a.ls_ls;
  const float vk = a.var[l * a.var_ls + k];

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

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  float scale;

  if (slot < a.n_chunks) {
    // prior term over this chunk's features of output dim k
    const int s1 = min(S, (slot + 1) * kChunk);
    for (int s = slot * kChunk + tid; s < s1; s += blockDim.x) {
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
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(cosf(xo[r] + ph), wv, acc[r]);
    }
    scale = sqrtf(vk / (float)S);
  } else {
    // inducing update over the M inducing points of output dim k
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
        acc[r] = fmaf(expf(-0.5f * d2[r]), nv, acc[r]);
    }
    scale = vk;
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float v = warp_sum(acc[r]);
    if (lane == 0) red[warp][r] = v;
  }
  __syncthreads();
  if (tid < kRows) {
    const int n = r0 + tid;
    if (n < N) {
      float f = 0.f;
      for (int v = 0; v < kWarps; ++v) f += red[v][tid];
      a.part[((l * n_slots + slot) * N + n) * K + k] = scale * f;
    }
  }
}

}  // namespace

// Feature columns per chunk slot: the wrapper sizes the slab part
// (L, ceil(S / chunk) + 1, N, K) from it.
extern "C" int pathwise_tiled_fwd_chunk() { return kChunk; }

// Launches the tiled eval on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes it does not take (a grid dimension past
// its limit, or rows and 1/ls above 48 KB of shared memory). Operands as in
// pathwise_fwd; part is (L, ceil(S / chunk) + 1, N, K) and every entry of it
// is written; the output is its sum over the second dim.
extern "C" int pathwise_tiled_fwd(
    const float* x, long long x_ls, const float* omega, long long om_ls,
    const float* phase, long long ph_ls, const float* w, long long w_ls,
    const float* z, long long z_ls, const float* nu, long long nu_ls,
    const float* ls, long long ls_ls, const float* var, long long var_ls,
    float* part, int L, int N, int D, int K, int S, int M, int device,
    void* stream) {
  if (L < 1 || N < 1 || D < 1 || K < 1 || S < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const long long n_tiles = (N + kRows - 1) / kRows;
  if (n_tiles > 65535 || (long long)L * K > 65535)
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
  a.part = part;
  a.N = N; a.D = D; a.K = K; a.S = S; a.M = M; a.n_chunks = n_chunks;

  const dim3 grid(n_chunks + 1, (unsigned)n_tiles, L * K);
  pathwise_tiled_fwd_kernel<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
