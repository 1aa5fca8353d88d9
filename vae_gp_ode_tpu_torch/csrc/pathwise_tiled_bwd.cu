// Reverse mode (VJP) of the grid-tiled per-step pathwise evaluation in
// pathwise_tiled_fwd.cu, one launch for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_bwd_kernel` of
// vae_gp_ode_tpu/ops/pathwise_tiled.py. It computes what autograd through
// `pathwise_eval_reference` computes for a cotangent g (L, N, K), the same
// function as pathwise_bwd.cu (whose header states the terms), recomputing
// the forward intermediates instead of storing them.
//
// Design. The grid is (slot, K, L). Slots 0 .. n_chunks-1 are feature
// chunks of kThreads columns of output dim k: such a block owns its columns
// for all N rows, one column per thread, and loops over the rows in tiles
// of kRows. A thread keeps its column's dw, dphase and dvar terms in
// registers and its domega[:, s, k] in shared memory across the row tiles, and
// writes its column's domega, dphase and dweights exactly once at the end,
// into per-draw outputs. The rows' dx terms sum over the block's columns:
// per row tile the threads put their du into shared memory and the threads
// that own the (row, d) pairs sum them against the chunk's omega, also in
// shared memory. Slot n_chunks is the update term of output dim k (its own
// slot per (draw, k)): each thread owns inducing points, keeps their dnu in
// registers and their dZ in shared memory over the row tiles, and the
// (row, d) pair owners sum the dx and dls terms as in pathwise_bwd.cu.
// Each block writes its dx (N, D) and its dvar[k] share to slabs, and the
// update block its dZ (M, D): dx_slab (L, n_slots, K, N, D), dvar_slab
// (L, n_slots, K), dz_slab (L, K, M, D); dnu (L, K, M) and dls (L, K, D) are
// written once by the update block. The wrapper sums the slabs (and, for
// operands that all draws share, the draws). No atomics: the result does
// not depend on the order of blocks. Any N, K, S and M is taken, and D up to
// what the shared memory holds (D <= 209 at the H100's opt-in limit);
// pathwise_tiled_bwd_smem_bytes exports the need so the dispatch rule can
// decide before a launch.
//
// What bounds it on an H100. At the wide shapes (L=5, N=20, D=K=12,
// S=1024, M=100) recompute and VJP are ~119 MFLOP on ~6.9 MB of operands
// and cotangents: ~2 us of memory time, bound by bytes. Where
// pathwise_bwd.cu has L * ceil(N / 8) blocks (15 there) that each walk all
// K * S columns, this grid has L * K * (ceil(S / kThreads) + 1) blocks
// (540 there) that each walk kThreads columns or the M inducing points, so
// every SM has work; each block is a chain of loads, sincosf/expf and
// barriers per row tile. wgmma, TMA and tuning are later work.
//
// Accuracy. Accurate sincosf/expf, no fast-math; everything is f32.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;        // batch rows per tile
constexpr int kThreads = 128;   // also the feature columns per chunk slot
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
  float* dx_slab;      // (L, n_slots, K, N, D)
  float* dvar_slab;    // (L, n_slots, K)
  float* dom;          // (L, D, S, K)
  float* dph;          // (L, S, K)
  float* dw;           // (L, S, K)
  float* dz_slab;      // (L, K, M, D)
  float* dnu;          // (L, K, M)
  float* dls;          // (L, K, D)
  int N, D, K, S, M, n_chunks;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)2 * kRows * D + kRows + D +
                          (size_t)kRows * kThreads + (size_t)2 * kThreads * D);
}

// The block's sum of v, returned to thread 0 (red holds kWarps floats).
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kWarps; ++i) s += red[i];
  return s;
}

__global__ void __launch_bounds__(kThreads)
    pathwise_tiled_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const int D = a.D, K = a.K, S = a.S, M = a.M, N = a.N;
  const int slot = blockIdx.x;
  const int k = blockIdx.y;
  const long long l = blockIdx.z;
  const int n_slots = a.n_chunks + 1;
  const int RD = kRows * D;
  const long long SK = (long long)S * K;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  float* xs = smem;                  // RD               the tile's rows
  float* gs = xs + RD;               // kRows            their g[:, k]
  float* ils = gs + kRows;           // D                1 / ls[k, :]
  float* buf = ils + D;              // kRows * kThreads du or dq of a tile
  float* ext = buf + kRows * kThreads;

  const float* x = a.x + l * a.x_ls;
  const float* omega = a.omega + l * a.om_ls;
  const float* phase = a.phase + l * a.ph_ls;
  const float* w = a.w + l * a.w_ls;
  const float* z = a.z + l * a.z_ls;
  const float* nu = a.nu + l * a.nu_ls;
  const float* ls = a.ls + l * a.ls_ls;
  const float vk = a.var[l * a.var_ls + k];
  float* dx_slab = a.dx_slab + ((l * n_slots + slot) * K + k) * N * D;

  // stages the rows of the tile at t0 and their cotangents g[:, k]; rows
  // past N carry x = 0 and g = 0, so every term they add is 0
  auto load_tile = [&](int t0) {
    __syncthreads();
    for (int i = tid; i < RD; i += nt) {
      const int n = t0 + i / D;
      xs[i] = n < N ? x[(long long)n * D + i % D] : 0.f;
    }
    for (int r = tid; r < kRows; r += nt) {
      const int n = t0 + r;
      gs[r] = n < N ? a.g[(l * N + n) * K + k] : 0.f;
    }
    __syncthreads();
  };

  if (slot < a.n_chunks) {
    // -- prior term: the columns s0 .. s0 + kThreads - 1 of output dim k
    float* om_s = ext;               // D * kThreads  omega of the chunk
    float* dom_s = om_s + D * nt;    // D * kThreads  domega of the chunk
    const int s0 = slot * kThreads;
    const int s = s0 + tid;
    const bool own = s < S;
    const long long col = (long long)s * K + k;
    for (int d = 0; d < D; ++d) {
      om_s[d * nt + tid] = own ? __ldg(omega + d * SK + col) : 0.f;
      dom_s[d * nt + tid] = 0.f;
    }
    const float ph = own ? __ldg(phase + col) : 0.f;
    const float wv = own ? __ldg(w + col) : 0.f;
    const float c = sqrtf(vk / (float)S);
    const int cnt = min(nt, S - s0);
    float dwv = 0.f, dphv = 0.f;
    for (int t0 = 0; t0 < N; t0 += kRows) {
      load_tile(t0);
      float du[kRows];
      if (own) {
        float u[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) u[r] = ph;
        for (int d = 0; d < D; ++d) {
          const float o = om_s[d * nt + tid];
#pragma unroll
          for (int r = 0; r < kRows; ++r) u[r] = fmaf(xs[r * D + d], o, u[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float sn, cs;
          sincosf(u[r], &sn, &cs);
          const float gk = gs[r];
          dwv = fmaf(gk, cs, dwv);
          du[r] = -sn * gk * c * wv;
          dphv += du[r];
        }
        for (int d = 0; d < D; ++d) {
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc = fmaf(xs[r * D + d], du[r], acc);
          dom_s[d * nt + tid] += acc;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) du[r] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) buf[r * nt + tid] = du[r];
      __syncthreads();
      for (int p = tid; p < RD; p += nt) {
        const int r = p / D, d = p % D;
        const int n = t0 + r;
        float acc = 0.f;
        for (int j = 0; j < cnt; ++j)
          acc = fmaf(buf[r * nt + j], om_s[d * nt + j], acc);
        if (n < N) dx_slab[(long long)n * D + d] = acc;
      }
    }
    dwv *= c;
    if (own) {
      const long long o = l * SK + col;
      a.dw[o] = dwv;
      a.dph[o] = dphv;
      for (int d = 0; d < D; ++d)
        a.dom[l * D * SK + d * SK + col] = dom_s[d * nt + tid];
    }
    const float dv = block_sum(own ? 0.5f * wv / vk * dwv : 0.f, red);
    if (tid == 0) a.dvar_slab[(l * n_slots + slot) * K + k] = dv;
    return;
  }

  // -- update term of output dim k, one inducing point per thread and chunk
  float* dlsacc = ext;               // RD          dls[k] of (row, d) pairs
  float* zs_s = dlsacc + RD;         // kThreads*D  Z rows of the m chunk
  float* dz_s = zs_s + nt * D;       // D*kThreads  dZ of the m chunk
  for (int d = tid; d < D; d += nt) ils[d] = 1.f / ls[k * D + d];
  for (int p = tid; p < RD; p += nt) dlsacc[p] = 0.f;
  float dvp = 0.f;
  for (int m0 = 0; m0 < M; m0 += nt) {
    const int m = m0 + tid;
    const bool own = m < M;
    const int cnt = min(nt, M - m0);
    __syncthreads();
    for (int i = tid; i < cnt * D; i += nt)
      zs_s[i] = z[(long long)m0 * D + i];
    for (int d = 0; d < D; ++d) dz_s[d * nt + tid] = 0.f;
    const float nv = own ? __ldg(nu + (long long)k * M + m) : 0.f;
    float dnuv = 0.f;
    for (int t0 = 0; t0 < N; t0 += kRows) {
      load_tile(t0);
      float dq[kRows];
      if (own) {
        float q[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) q[r] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float zv = zs_s[tid * D + d];
          const float il = ils[d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float df = (xs[r * D + d] - zv) * il;
            q[r] = fmaf(df, df, q[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float kx = vk * expf(-0.5f * q[r]);
          const float gk = gs[r];
          dnuv = fmaf(gk, kx, dnuv);
          dq[r] = -0.5f * kx * gk * nv;
        }
        for (int d = 0; d < D; ++d) {
          const float zv = zs_s[tid * D + d];
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc = fmaf(dq[r], xs[r * D + d] - zv, acc);
          dz_s[d * nt + tid] -= 2.f * acc * ils[d] * ils[d];
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) dq[r] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) buf[r * nt + tid] = dq[r];
      __syncthreads();
      for (int p = tid; p < RD; p += nt) {
        const int r = p / D, d = p % D;
        const int n = t0 + r;
        const float xv = xs[p];
        float accx = 0.f, accl = 0.f;
        for (int j = 0; j < cnt; ++j) {
          const float b = buf[r * nt + j];
          const float df = xv - zs_s[j * D + d];
          accx = fmaf(b, df, accx);
          accl = fmaf(b * df, df, accl);
        }
        const float il = ils[d];
        dlsacc[p] -= 2.f * accl * il * il * il;
        if (n < N) {
          float* o = dx_slab + (long long)n * D + d;
          *o = (m0 == 0 ? 0.f : *o) + 2.f * accx * il * il;
        }
      }
    }
    if (own) {
      a.dnu[(l * K + k) * M + m] = dnuv;
      dvp = fmaf(dnuv, nv / vk, dvp);
      float* dz = a.dz_slab + ((l * K + k) * M + m) * D;
      for (int d = 0; d < D; ++d) dz[d] = dz_s[d * nt + tid];
    }
  }
  __syncthreads();
  for (int d = tid; d < D; d += nt) {
    float v = 0.f;
    for (int r = 0; r < kRows; ++r) v += dlsacc[r * D + d];
    a.dls[(l * K + k) * D + d] = v;
  }
  const float dv = block_sum(dvp, red);
  if (tid == 0) a.dvar_slab[(l * n_slots + slot) * K + k] = dv;
}

}  // namespace

// Feature columns per chunk slot: the wrapper sizes the slabs, with
// n_slots = ceil(S / chunk) + 1.
extern "C" int pathwise_tiled_bwd_chunk() { return kThreads; }

// Bytes of shared memory a block needs at state dim D.
extern "C" long long pathwise_tiled_bwd_smem_bytes(int D) {
  return (long long)smem_bytes(D);
}

// The device's opt-in limit of shared memory per block, in bytes (0 if it
// cannot be read).
extern "C" int pathwise_tiled_bwd_smem_optin(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return optin;
}

// Launches the VJP kernel on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes it does not take (K or L above the grid's
// 65535, or shared memory above the block's opt-in limit). Operands as in
// pathwise_tiled_fwd; g is (L, N, K); the outputs are laid out as BwdArgs
// states, with n_slots = ceil(S / chunk) + 1, and every entry is written.
extern "C" int pathwise_tiled_bwd(
    const float* x, long long x_ls, const float* omega, long long om_ls,
    const float* phase, long long ph_ls, const float* w, long long w_ls,
    const float* z, long long z_ls, const float* nu, long long nu_ls,
    const float* ls, long long ls_ls, const float* var, long long var_ls,
    const float* g, float* dx_slab, float* dvar_slab, float* dom, float* dph,
    float* dw, float* dz_slab, float* dnu, float* dls, int L, int N, int D,
    int K, int S, int M, int device, void* stream) {
  if (L < 1 || N < 1 || D < 1 || K < 1 || S < 1 || M < 1 || L > 65535 ||
      K > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const int optin = pathwise_tiled_bwd_smem_optin(device);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(pathwise_tiled_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }

  BwdArgs a;
  a.x = x; a.omega = omega; a.phase = phase; a.w = w; a.z = z; a.nu = nu;
  a.ls = ls; a.var = var;
  a.x_ls = x_ls; a.om_ls = om_ls; a.ph_ls = ph_ls; a.w_ls = w_ls;
  a.z_ls = z_ls; a.nu_ls = nu_ls; a.ls_ls = ls_ls; a.var_ls = var_ls;
  a.g = g; a.dx_slab = dx_slab; a.dvar_slab = dvar_slab; a.dom = dom;
  a.dph = dph; a.dw = dw; a.dz_slab = dz_slab; a.dnu = dnu; a.dls = dls;
  a.N = N; a.D = D; a.K = K; a.S = S; a.M = M;
  a.n_chunks = (S + kThreads - 1) / kThreads;

  const dim3 grid(a.n_chunks + 1, K, L);
  pathwise_tiled_bwd_kernel<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
