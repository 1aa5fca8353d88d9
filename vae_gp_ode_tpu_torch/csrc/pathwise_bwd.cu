// Reverse mode (VJP) of the per-step pathwise evaluation in pathwise_fwd.cu,
// one launch for all L Monte-Carlo draws.
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
//   dvar[k]    = sum_n g[n, k] (0.5 f1[n, k] + f2[n, k]) / var_k
//
// Outputs: dx (L, N, D) per row, and per block one slab of operand
// cotangents [domega (D,S,K) | dphase (S,K) | dw (S,K) | dZ (M,D) |
// dnu (K,M) | dls (K,D) | dvar (K)] in (L, n_tiles, P). The wrapper sums the
// slabs over row tiles, and over draws for operands that all draws share:
// blocks never write to the same address, so the result does not depend on
// the order in which blocks run (no atomics).
//
// Design. One thread block owns one draw and kRows batch rows and loops over
// the output dims k. Within each k it walks the features and then the
// inducing points in chunks of one per thread: a thread computes its
// column's per-row terms in registers and writes its column's cotangents
// (domega, dphase, dw; dnu and its dZ row) straight into the block's slab,
// since no other thread of the block touches that column. The per-row terms
// (du, dq) of the chunk go to shared memory, where the threads that own the
// (row, d) pairs sum them into dx and dls. Any N, D, K, S and M is taken;
// shared memory holds the rows, a chunk of per-row terms and the pair
// accumulators (7 KB at D=24, K=12).
//
// What bounds it on an H100. Recompute and VJP are about
// K*S*(4D+14) + K*M*(9D+14) operations per row: 56 kFLOP at the main
// shapes, 5.6 MFLOP at L*N = 100 rows, a few microseconds of the card's f32
// rate. The kernel is bound instead by launch latency and by the chain of
// dependent loads, sincosf/expf and barriers within a block, with only
// L*ceil(N/kRows) blocks on 132 SMs. wgmma, TMA and tuning are later work.
//
// Accuracy. Accurate sincosf/expf, no fast-math; everything is f32.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;        // batch rows per block
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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
  float* dx;           // (L, N, D)
  float* slab;         // (L, n_tiles, P)
  int N, D, K, S, M;
  long long P;         // floats per slab
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

long long slab_floats(int D, int K, int S, int M) {
  const long long SK = (long long)S * K;
  return D * SK + 2 * SK + (long long)M * D + (long long)K * M +
         (long long)K * D + K;
}

size_t smem_bytes(int D, int K) {
  return sizeof(float) * ((size_t)3 * kRows * D + (size_t)kRows * K + D +
                          (size_t)kRows * kThreads);
}

__global__ void __launch_bounds__(kThreads) pathwise_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const int D = a.D, K = a.K, S = a.S, M = a.M, N = a.N;
  const long long l = blockIdx.y;
  const int tile = blockIdx.x;
  const int r0 = tile * kRows;
  const int RD = kRows * D;
  const long long SK = (long long)S * K;

  float* xs = smem;                  // RD          the block's rows
  float* dxacc = xs + RD;            // RD          dx of (row, d) pairs
  float* dlsacc = dxacc + RD;        // RD          dls[k] of (row, d) pairs
  float* gs = dlsacc + RD;           // kRows * K   the rows' cotangents
  float* ils = gs + kRows * K;       // D           1 / ls[k, :]
  float* buf = ils + D;              // kRows * kThreads  du or dq of a chunk

  float* slab = a.slab + (l * gridDim.x + tile) * a.P;
  float* dom = slab;
  float* dph = dom + D * SK;
  float* dw = dph + SK;
  float* dz = dw + SK;
  float* dnu = dz + (long long)M * D;
  float* dls = dnu + (long long)K * M;
  float* dvar = dls + (long long)K * D;

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
  const int nt = blockDim.x;

  // rows past N carry x = 0 and g = 0: every term they add is scaled by g
  for (int i = tid; i < RD; i += nt) {
    const int n = r0 + i / D;
    xs[i] = n < N ? x[(long long)n * D + i % D] : 0.f;
    dxacc[i] = 0.f;
  }
  for (int i = tid; i < kRows * K; i += nt) {
    const int n = r0 + i / K;
    gs[i] = n < N ? a.g[(l * N + n) * K + i % K] : 0.f;
  }
  // the thread that owns inducing point m accumulates dZ[m, :] over k
  for (int m = tid; m < M; m += nt)
    for (int d = 0; d < D; ++d) dz[(long long)m * D + d] = 0.f;

  for (int k = 0; k < K; ++k) {
    for (int d = tid; d < D; d += nt) ils[d] = 1.f / ls[k * D + d];
    for (int i = tid; i < RD; i += nt) dlsacc[i] = 0.f;
    __syncthreads();
    const float vk = var[k];
    const float c = sqrtf(vk / (float)S);
    float dvp = 0.f;      // this thread's share of dvar[k]

    // prior term, one feature per thread and chunk
    for (int s0 = 0; s0 < S; s0 += nt) {
      const int s = s0 + tid;
      float du[kRows];
      if (s < S) {
        const long long col = (long long)s * K + k;
        float u[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) u[r] = __ldg(phase + col);
        for (int d = 0; d < D; ++d) {
          const float o = __ldg(omega + d * SK + col);
#pragma unroll
          for (int r = 0; r < kRows; ++r) u[r] = fmaf(xs[r * D + d], o, u[r]);
        }
        const float wv = __ldg(w + col);
        float dwv = 0.f, dphv = 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float sn, cs;
          sincosf(u[r], &sn, &cs);
          const float gk = gs[r * K + k];
          dwv = fmaf(gk, cs, dwv);
          du[r] = -sn * gk * c * wv;
          dphv += du[r];
        }
        dwv *= c;
        dw[col] = dwv;
        dph[col] = dphv;
        dvp = fmaf(0.5f * wv / vk, dwv, dvp);
        for (int d = 0; d < D; ++d) {
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc = fmaf(xs[r * D + d], du[r], acc);
          dom[d * SK + col] = acc;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) du[r] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) buf[r * nt + tid] = du[r];
      __syncthreads();
      const int cnt = S - s0 < nt ? S - s0 : nt;
      for (int p = tid; p < RD; p += nt) {
        const int r = p / D, d = p % D;
        const float* om = omega + d * SK + (long long)s0 * K + k;
        float acc = 0.f;
        for (int j = 0; j < cnt; ++j)
          acc = fmaf(buf[r * nt + j], __ldg(om + (long long)j * K), acc);
        dxacc[p] += acc;
      }
      __syncthreads();
    }

    // update term, one inducing point per thread and chunk
    for (int m0 = 0; m0 < M; m0 += nt) {
      const int m = m0 + tid;
      float dq[kRows];
      if (m < M) {
        float q[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) q[r] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float zv = __ldg(z + (long long)m * D + d);
          const float il = ils[d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float df = (xs[r * D + d] - zv) * il;
            q[r] = fmaf(df, df, q[r]);
          }
        }
        const float nv = __ldg(nu + (long long)k * M + m);
        float dnuv = 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float kx = vk * expf(-0.5f * q[r]);
          const float gk = gs[r * K + k];
          dnuv = fmaf(gk, kx, dnuv);
          dq[r] = -0.5f * kx * gk * nv;
        }
        dnu[(long long)k * M + m] = dnuv;
        dvp = fmaf(dnuv, nv / vk, dvp);
        for (int d = 0; d < D; ++d) {
          const float zv = __ldg(z + (long long)m * D + d);
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc = fmaf(dq[r], xs[r * D + d] - zv, acc);
          dz[(long long)m * D + d] -= 2.f * acc * ils[d] * ils[d];
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) dq[r] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) buf[r * nt + tid] = dq[r];
      __syncthreads();
      const int cnt = M - m0 < nt ? M - m0 : nt;
      for (int p = tid; p < RD; p += nt) {
        const int r = p / D, d = p % D;
        const float xv = xs[p];
        float accx = 0.f, accl = 0.f;
        for (int j = 0; j < cnt; ++j) {
          const float b = buf[r * nt + j];
          const float df = xv - __ldg(z + (long long)(m0 + j) * D + d);
          accx = fmaf(b, df, accx);
          accl = fmaf(b * df, df, accl);
        }
        const float il = ils[d];
        dxacc[p] += 2.f * accx * il * il;
        dlsacc[p] -= 2.f * accl * il * il * il;
      }
      __syncthreads();
    }

    // dvar[k] over the block, dls[k, :] over the rows
    {
      const float v = warp_sum(dvp);
      if (lane == 0) red[warp] = v;
    }
    __syncthreads();
    if (tid == 0) {
      float v = 0.f;
      for (int i = 0; i < kWarps; ++i) v += red[i];
      dvar[k] = v;
    }
    for (int d = tid; d < D; d += nt) {
      float v = 0.f;
      for (int r = 0; r < kRows; ++r) v += dlsacc[r * D + d];
      dls[(long long)k * D + d] = v;
    }
    __syncthreads();
  }

  for (int p = tid; p < RD; p += nt) {
    const int n = r0 + p / D;
    if (n < N) a.dx[(l * N + n) * D + p % D] = dxacc[p];
  }
}

}  // namespace

// Floats per block slab of operand cotangents, for the wrapper to size
// `slab` (L, n_tiles, P) and to split it.
extern "C" long long pathwise_bwd_slab_floats(int D, int K, int S, int M) {
  return slab_floats(D, K, S, M);
}

// Rows per block: n_tiles = ceil(N / rows).
extern "C" int pathwise_bwd_rows() { return kRows; }

// Launches the VJP kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes it does not take (L above the grid's
// 65535, or shared memory above the block's opt-in limit). Operands as in
// pathwise_fwd; g is (L, N, K), dx (L, N, D), slab (L, ceil(N/rows), P);
// every slab entry and every dx row is written.
extern "C" int pathwise_bwd(
    const float* x, long long x_ls, const float* omega, long long om_ls,
    const float* phase, long long ph_ls, const float* w, long long w_ls,
    const float* z, long long z_ls, const float* nu, long long nu_ls,
    const float* ls, long long ls_ls, const float* var, long long var_ls,
    const float* g, float* dx, float* slab, int L, int N, int D, int K,
    int S, int M, int device, void* stream) {
  if (L < 1 || N < 1 || D < 1 || K < 1 || S < 1 || M < 1 || L > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(D, K);
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
  a.g = g; a.dx = dx; a.slab = slab;
  a.N = N; a.D = D; a.K = K; a.S = S; a.M = M;
  a.P = slab_floats(D, K, S, M);

  const dim3 grid((N + kRows - 1) / kRows, L);
  pathwise_bwd_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
