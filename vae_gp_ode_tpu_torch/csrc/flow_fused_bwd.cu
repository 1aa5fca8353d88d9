// Discrete adjoint (reverse mode) of the whole euler trajectory of the
// dimwise-RBF pathwise GP sample, one launch for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_make_bwd_kernel` of
// vae_gp_ode_tpu/ops/flow_fused.py, the backward of the trajectory kernel in
// flow_fused.cu. It computes what autograd through `packed_flow_reference`
// computes (`packed_flow_vjp_reference`). Per draw l and batch row it walks
// t = T-2 .. 0 and recomputes the step's forward intermediates from the
// saved state z_t instead of storing (N, K*S) activations:
//
//   g_{T-1} = zsbar[T-1]
//   g_t     = zsbar[t] + g_{t+1} + dt_t (d rhs / d z_t)^T g_{t+1}
//   param_bar += dt_t (d rhs / d param)^T g_{t+1}
//   dtsbar[t]  = g_{t+1} . rhs(z_t)
//
// with rhs(z) = f(z) (order 1) or [z[K:], f(z)] (order 2, where g_t also
// takes the chain term g_t[K:] += dt_t g_{t+1}[:K]), f as in flow_fused.cu.
// Outputs: z0bar (L, N, D) per draw, and per block one slab of parameter
// cotangents [omf (D,KS) | phf (KS) | ws (KS) | Zb (D,KM) | zn (KM) |
// il2 (D,KM) | nus (KM) | dts (T-1)] in (L, n_tiles, P). The wrapper sums
// the slabs over row tiles, and over draws for operands that all draws
// share: blocks never write to the same address, so the result does not
// depend on the order in which blocks run (no atomics).
//
// Design. One thread block owns one draw and kRows batch rows, as in the
// forward. Each thread owns fixed feature and inducing columns for the whole
// walk, so it accumulates those columns' parameter cotangents in shared
// memory with no other thread touching them. The state cotangent
// d/dz_t = sum over columns is reduced per step across the block: warp
// shuffles, then one value per warp in shared memory. The per-block
// accumulators at the main shapes (D=K=6, S=256, M=100) are 20,703 floats
// (81 KB), above the 48 KB default, so the launch first raises the block's
// dynamic shared memory limit.
//
// What bounds it on an H100. Per row and step the recompute and the VJP are
// about K*S*(6D+12) + K*M*(12D+16) = 126 kFLOP at the main shapes; a train
// step has L*N*(T-1) = 300 (L=1) or 1500 (L=5) row-steps, 38 / 190 MFLOP,
// about 0.6 / 2.8 us at 67 TFLOP/s f32. Like the forward, the kernel is
// bound instead by launch latency and by its T-1 dependent steps, each a
// chain of loads, sincosf/expf and a block-wide reduction with two barriers.
// wgmma, TMA and tuning are later work.
//
// Accuracy. Accurate sincosf/expf, no fast-math; everything is f32, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;        // batch rows per block
constexpr int kThreads = 512;

struct BwdArgs {
  const float* zs;     // (L, T, N, D) forward trajectory
  const float* zsbar;  // (L, T, N, D) its cotangent
  const float* omf;    // (D, K*S)     per draw at omf_ls (0 = shared)
  const float* phf;    // (1, K*S)
  const float* ws;     // (1, K*S)
  const float* zb;     // (D, K*M)
  const float* zn;     // (1, K*M)
  const float* il2;    // (D, K*M)
  const float* nus;    // (1, K*M)
  long long omf_ls, phf_ls, ws_ls, zb_ls, zn_ls, il2_ls, nus_ls;
  const float* dts;    // (T-1,)
  float* z0bar;        // (L, N, D)
  float* slab;         // (L, n_tiles, P)
  int N, D, K, S, M, T, order;
  long long P;         // floats per slab
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

long long slab_floats(int D, int K, int S, int M, int T) {
  const long long KS = (long long)K * S, KM = (long long)K * M;
  return D * KS + 2 * KS + 2 * D * KM + 2 * KM + (T - 1);
}

size_t smem_bytes(int D, int K, int S, int M, int T) {
  const int RD = kRows * D;
  return sizeof(float) * ((size_t)slab_floats(D, K, S, M, T) + 3 * (size_t)RD +
                          (size_t)(kThreads / 32) * (RD + 1));
}

// DMAX bounds D at compile time so that the per-row partials stay in
// registers; loops over d run to DMAX and skip d >= D.
template <int DMAX>
__global__ void __launch_bounds__(kThreads) flow_fused_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, K = a.K, S = a.S, M = a.M, T = a.T, N = a.N;
  const int KS = K * S, KM = K * M;
  const int l = blockIdx.y;
  const int tile = blockIdx.x;
  const int r0 = tile * kRows;
  const int RD = kRows * D;
  const int nred = RD + 1;           // RD state partials + the dts partial
  const int off = a.order == 2 ? K : 0;   // g columns that f feeds

  float* omfbar = smem;              // D*KS, then the slab layout
  float* phfbar = omfbar + (long long)D * KS;
  float* wsbar = phfbar + KS;
  float* zbbar = wsbar + KS;
  float* znbar = zbbar + (long long)D * KM;
  float* il2bar = znbar + KM;
  float* nusbar = il2bar + (long long)D * KM;
  float* dtsbar = nusbar + KM;
  float* g = smem + a.P;             // RD  cotangent of z_{t+1}
  float* gn = g + RD;                // RD  cotangent of z_t
  float* zt = gn + RD;               // RD  z_t
  float* red = zt + RD;              // nwarps * nred

  const float* omf = a.omf + l * a.omf_ls;
  const float* phf = a.phf + l * a.phf_ls;
  const float* ws = a.ws + l * a.ws_ls;
  const float* zb = a.zb + l * a.zb_ls;
  const float* zn = a.zn + l * a.zn_ls;
  const float* il2 = a.il2 + l * a.il2_ls;
  const float* nus = a.nus + l * a.nus_ls;
  const float* zs = a.zs + (long long)l * T * N * D;
  const float* zsbar = a.zsbar + (long long)l * T * N * D;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (long long i = tid; i < a.P; i += blockDim.x) smem[i] = 0.f;
  // rows past N carry g = 0 and z = 0 throughout: every contribution they
  // make is scaled by their g, so they add exactly nothing
  for (int i = tid; i < RD; i += blockDim.x) {
    const int n = r0 + i / D;
    g[i] = n < N ? zsbar[((long long)(T - 1) * N + n) * D + i % D] : 0.f;
  }

  for (int t = T - 2; t >= 0; --t) {
    const float dt = __ldg(a.dts + t);
    for (int i = tid; i < RD; i += blockDim.x) {
      const int n = r0 + i / D;
      zt[i] = n < N ? zs[((long long)t * N + n) * D + i % D] : 0.f;
    }
    __syncthreads();

    float zp[kRows][DMAX];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int d = 0; d < DMAX; ++d) zp[r][d] = 0.f;
    float dp = 0.f;

    // prior term: phi = cos(z . omf + phf) * ws over feature column c
    for (int c = tid; c < KS; c += blockDim.x) {
      const int k = c / S;
      float o[DMAX], ob[DMAX];
#pragma unroll
      for (int d = 0; d < DMAX; ++d) {
        o[d] = d < D ? __ldg(omf + (long long)d * KS + c) : 0.f;
        ob[d] = 0.f;
      }
      const float ph = __ldg(phf + c);
      const float w = __ldg(ws + c);
      float pb = 0.f, wb = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float xo = 0.f;
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) xo = fmaf(zt[r * D + d], o[d], xo);
        float sn, cs;
        sincosf(xo + ph, &sn, &cs);
        const float gf = g[r * D + off + k];
        dp = fmaf(gf, cs * w, dp);
        const float fb = dt * gf;
        wb = fmaf(cs, fb, wb);
        const float xb = -sn * w * fb;
        pb += xb;
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) {
            ob[d] = fmaf(zt[r * D + d], xb, ob[d]);
            zp[r][d] = fmaf(xb, o[d], zp[r][d]);
          }
      }
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        if (d < D) omfbar[(long long)d * KS + c] += ob[d];
      phfbar[c] += pb;
      wsbar[c] += wb;
    }

    // update term: exp(-0.5 (xn + zn - 2 cross)) * nus over inducing column c
    for (int c = tid; c < KM; c += blockDim.x) {
      const int k = c / M;
      float b[DMAX], il[DMAX], bb[DMAX], ib[DMAX];
#pragma unroll
      for (int d = 0; d < DMAX; ++d) {
        b[d] = d < D ? __ldg(zb + (long long)d * KM + c) : 0.f;
        il[d] = d < D ? __ldg(il2 + (long long)d * KM + c) : 0.f;
        bb[d] = 0.f;
        ib[d] = 0.f;
      }
      const float znc = __ldg(zn + c);
      const float nuc = __ldg(nus + c);
      float znb = 0.f, nub = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float cr = 0.f, xn = 0.f;
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) {
            const float zv = zt[r * D + d];
            cr = fmaf(zv, b[d], cr);
            xn = fmaf(zv * zv, il[d], xn);
          }
        const float kx = expf(-0.5f * (xn + znc - 2.f * cr));
        const float gf = g[r * D + off + k];
        dp = fmaf(gf, kx * nuc, dp);
        const float fb = dt * gf;
        nub = fmaf(kx, fb, nub);
        const float sq = -0.5f * kx * nuc * fb;
        znb += sq;
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) {
            const float zv = zt[r * D + d];
            ib[d] = fmaf(zv * zv, sq, ib[d]);
            bb[d] = fmaf(-2.f * zv, sq, bb[d]);
            zp[r][d] += 2.f * zv * sq * il[d] - 2.f * sq * b[d];
          }
      }
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        if (d < D) {
          zbbar[(long long)d * KM + c] += bb[d];
          il2bar[(long long)d * KM + c] += ib[d];
        }
      znbar[c] += znb;
      nusbar[c] += nub;
    }

    // block-wide sums of the state partials and of g . f
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        if (d < D) {
          const float v = warp_sum(zp[r][d]);
          if (lane == 0) red[warp * nred + r * D + d] = v;
        }
    {
      const float v = warp_sum(dp);
      if (lane == 0) red[warp * nred + RD] = v;
    }
    __syncthreads();

    for (int i = tid; i < nred; i += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += red[w * nred + i];
      if (i < RD) {
        const int r = i / D;
        const int d = i % D;
        const int n = r0 + r;
        float v = (n < N ? zsbar[((long long)t * N + n) * D + d] : 0.f) +
                  g[i] + s;
        if (a.order == 2 && d >= K) v = fmaf(dt, g[r * D + d - K], v);
        gn[i] = v;
      } else {
        // order 2: rhs[:K] = z[K:] also feeds d/d dt
        if (a.order == 2)
          for (int r = 0; r < kRows; ++r)
            for (int k = 0; k < K; ++k)
              s = fmaf(g[r * D + k], zt[r * D + K + k], s);
        dtsbar[t] = s;
      }
    }
    __syncthreads();
    float* tmp = g;
    g = gn;
    gn = tmp;
  }

  for (int i = tid; i < RD; i += blockDim.x) {
    const int n = r0 + i / D;
    if (n < N) a.z0bar[((long long)l * N + n) * D + i % D] = g[i];
  }
  float* slab = a.slab + ((long long)l * gridDim.x + tile) * a.P;
  for (long long i = tid; i < a.P; i += blockDim.x) slab[i] = smem[i];
}

template <int DMAX>
int launch(const BwdArgs& a, int L, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flow_fused_bwd_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.N + kRows - 1) / kRows, L);
  flow_fused_bwd_kernel<DMAX><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats per block slab of parameter cotangents, for the wrapper to size
// `slab` (L, n_tiles, P) and to split it.
extern "C" long long flow_fused_bwd_slab_floats(int D, int K, int S, int M,
                                                int T) {
  return slab_floats(D, K, S, M, T);
}

// Rows per block: n_tiles = ceil(N / rows).
extern "C" int flow_fused_bwd_rows() { return kRows; }

// Dynamic shared memory one block needs at these shapes; the launch refuses
// shapes where it exceeds flow_fused_bwd_smem_optin(device), so a caller
// can decide before the forward whether the pair of kernels will run.
extern "C" long long flow_fused_bwd_smem_bytes(int D, int K, int S, int M,
                                               int T) {
  return (long long)smem_bytes(D, K, S, M, T);
}

// The device's opt-in shared memory per block, or -1 if it cannot be read.
extern "C" int flow_fused_bwd_smem_optin(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin;
}

// Launches the adjoint kernel on `stream` and returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes it does not take: D > 16, or a slab
// larger than the block's shared memory). Operands are f32 and contiguous;
// each `*_ls` is the element stride between draws (0 for an operand that
// all draws share). zs and zsbar are (L, T, N, D), z0bar (L, N, D), slab
// (L, ceil(N/rows), P); every slab entry and every z0bar row is written.
extern "C" int flow_fused_bwd(
    const float* zs, const float* zsbar, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* ws, long long ws_ls,
    const float* zb, long long zb_ls, const float* zn, long long zn_ls,
    const float* il2, long long il2_ls, const float* nus, long long nus_ls,
    const float* dts, float* z0bar, float* slab, int L, int N, int D, int K,
    int S, int M, int T, int order, int device, void* stream) {
  if (L < 1 || N < 1 || K < 1 || S < 1 || M < 1 || T < 2 ||
      (order != 1 && order != 2) || D != K * order || D > 16 || L > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(D, K, S, M, T);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;

  BwdArgs a;
  a.zs = zs; a.zsbar = zsbar;
  a.omf = omf; a.phf = phf; a.ws = ws; a.zb = zb; a.zn = zn; a.il2 = il2;
  a.nus = nus;
  a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.ws_ls = ws_ls; a.zb_ls = zb_ls;
  a.zn_ls = zn_ls; a.il2_ls = il2_ls; a.nus_ls = nus_ls;
  a.dts = dts; a.z0bar = z0bar; a.slab = slab;
  a.N = N; a.D = D; a.K = K; a.S = S; a.M = M; a.T = T; a.order = order;
  a.P = slab_floats(D, K, S, M, T);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 8 ? launch<8>(a, L, smem, s) : launch<16>(a, L, smem, s);
}
