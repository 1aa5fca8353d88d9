// Whole euler trajectory of the dimwise-RBF pathwise GP sample, one launch
// for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_make_kernel` of vae_gp_ode_tpu/ops/flow_fused.py
// (forward only; its discrete-adjoint backward `_make_bwd_kernel` is not
// ported yet). It computes what `packed_flow_reference` computes on the
// packed operands of `_pack_operands`, per draw l and batch row n:
//
//   f_k(z) = sum_s cos(z . omf[:, kS+s] + phf[kS+s]) ws[kS+s]
//          + sum_m exp(-0.5 ((z*z) . il2[:, kM+m] + zn[kM+m]
//                             - 2 z . Zb[:, kM+m])) nus[kM+m]
//   rhs(z) = f(z)                 (order 1)
//   rhs(z) = [z[K:], f(z)]        (order 2, z = (s, v), D = 2K)
//   z_{t+1} = z_t + dts[t] rhs(z_t),   zs[l, 0] = z0
//
// The TPU kernel does the per-k block sums as matmuls against 0/1 block-
// indicator matrices so that the MXU can do them; here they are plain
// warp reductions.
//
// Design. One thread block owns one draw l and kRows batch rows and keeps
// those rows' state in shared memory through all T-1 steps. Each warp takes
// one (output dim k, column part p) item per step: its lanes stride over the
// k-th block of feature columns and of inducing columns, accumulate per row
// in f32 registers, and reduce with shuffles into shared memory. Then the
// block applies the euler update and writes zs[l, t+1] for its rows. The
// draw's packed operands (tens of KB) are read from global memory each step
// and stay in L2.
//
// What bounds it on an H100. At the main path's shapes (L=5, N=20, D=K=6,
// S=256, M=100, T=16) the work is ~65 MFLOP on ~0.3 MB: the card's f32 and
// memory rates would finish it in about a microsecond. The kernel is bound
// instead by launch latency and by its T-1 serial steps, each a chain of
// dependent loads, cosf/expf and reductions across a few warps. Spreading
// the rows over blocks (kRows = 4) and each k over column parts shortens
// each step's chain; wgmma, TMA and tuning are later work.
//
// Accuracy. Accurate cosf/expf, no fast-math: the arguments z . omega can
// be large, where __cosf loses accuracy. Everything is f32, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;        // batch rows per block
constexpr int kMaxWarps = 32;   // 1024 threads

struct FlowArgs {
  const float* z0;   // (N, D)         per draw at z0_ls (0 = shared)
  const float* omf;  // (D, K*S)
  const float* phf;  // (1, K*S)
  const float* ws;   // (1, K*S)
  const float* zb;   // (D, K*M)
  const float* zn;   // (1, K*M)
  const float* il2;  // (D, K*M)
  const float* nus;  // (1, K*M)
  long long z0_ls, omf_ls, phf_ls, ws_ls, zb_ls, zn_ls, il2_ls, nus_ls;
  const float* dts;  // (T-1,)
  float* zs;         // (L, T, N, D)
  int N, D, K, S, M, T, order, parts;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int R>
__global__ void flow_fused_fwd_kernel(FlowArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, K = a.K, S = a.S, M = a.M, P = a.parts;
  const long long KS = (long long)K * S, KM = (long long)K * M;
  const int l = blockIdx.y;
  const int r0 = blockIdx.x * R;

  float* zcur = smem;                   // R*D
  float* znext = zcur + R * D;          // R*D
  float* part1 = znext + R * D;         // P*K*R  feature sums
  float* part2 = part1 + P * K * R;     // P*K*R  inducing sums

  const float* z0 = a.z0 + l * a.z0_ls;
  const float* omf = a.omf + l * a.omf_ls;
  const float* phf = a.phf + l * a.phf_ls;
  const float* ws = a.ws + l * a.ws_ls;
  const float* zb = a.zb + l * a.zb_ls;
  const float* zn = a.zn + l * a.zn_ls;
  const float* il2 = a.il2 + l * a.il2_ls;
  const float* nus = a.nus + l * a.nus_ls;
  float* zs = a.zs + (long long)l * a.T * a.N * D;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // rows past N integrate zeros and are never written
  for (int i = tid; i < R * D; i += blockDim.x) {
    const int n = r0 + i / D;
    const float v = n < a.N ? z0[(long long)n * D + i % D] : 0.f;
    zcur[i] = v;
    if (n < a.N) zs[(long long)n * D + i % D] = v;
  }
  __syncthreads();

  for (int t = 0; t < a.T - 1; ++t) {
    for (int item = warp; item < K * P; item += nwarps) {
      const int k = item % K;
      const int p = item / K;
      float acc1[R], acc2[R];
#pragma unroll
      for (int r = 0; r < R; ++r) { acc1[r] = 0.f; acc2[r] = 0.f; }

      // prior term: cos(z . omf + phf) * ws over the k-th feature block
      for (int s = p * 32 + lane; s < S; s += 32 * P) {
        const long long c = k * (long long)S + s;
        float xo[R];
#pragma unroll
        for (int r = 0; r < R; ++r) xo[r] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float o = __ldg(omf + d * KS + c);
#pragma unroll
          for (int r = 0; r < R; ++r) xo[r] = fmaf(zcur[r * D + d], o, xo[r]);
        }
        const float ph = __ldg(phf + c);
        const float w = __ldg(ws + c);
#pragma unroll
        for (int r = 0; r < R; ++r) acc1[r] = fmaf(cosf(xo[r] + ph), w, acc1[r]);
      }

      // update term: exp(-0.5 scaled sqdist(z, Z_m)) * nus over the k-th
      // inducing block
      for (int m = p * 32 + lane; m < M; m += 32 * P) {
        const long long c = k * (long long)M + m;
        float cr[R], xn[R];
#pragma unroll
        for (int r = 0; r < R; ++r) { cr[r] = 0.f; xn[r] = 0.f; }
        for (int d = 0; d < D; ++d) {
          const float b = __ldg(zb + d * KM + c);
          const float il = __ldg(il2 + d * KM + c);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float zv = zcur[r * D + d];
            cr[r] = fmaf(zv, b, cr[r]);
            xn[r] = fmaf(zv * zv, il, xn[r]);
          }
        }
        const float znc = __ldg(zn + c);
        const float nuc = __ldg(nus + c);
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc2[r] = fmaf(expf(-0.5f * (xn[r] + znc - 2.f * cr[r])), nuc, acc2[r]);
      }

#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float s1 = warp_sum(acc1[r]);
        const float s2 = warp_sum(acc2[r]);
        if (lane == 0) {
          part1[(p * K + k) * R + r] = s1;
          part2[(p * K + k) * R + r] = s2;
        }
      }
    }
    __syncthreads();

    const float dt = __ldg(a.dts + t);
    for (int i = tid; i < R * D; i += blockDim.x) {
      const int r = i / D;
      const int d = i % D;
      float rhs;
      if (a.order == 2 && d < K) {
        rhs = zcur[r * D + K + d];
      } else {
        const int k = a.order == 2 ? d - K : d;
        float f1 = 0.f, f2 = 0.f;
        for (int p = 0; p < P; ++p) {
          f1 += part1[(p * K + k) * R + r];
          f2 += part2[(p * K + k) * R + r];
        }
        rhs = f1 + f2;
      }
      const float v = zcur[i] + dt * rhs;
      znext[i] = v;
      const int n = r0 + r;
      if (n < a.N) zs[((long long)(t + 1) * a.N + n) * D + d] = v;
    }
    __syncthreads();
    float* tmp = zcur;
    zcur = znext;
    znext = tmp;
  }
}

}  // namespace

// Launches the trajectory kernel on `stream` and returns cudaGetLastError().
// Operands are f32 and contiguous; each `*_ls` is the element stride between
// draws (0 for an operand that all draws share). zs is (L, T, N, D).
extern "C" int flow_fused_fwd(
    const float* z0, long long z0_ls, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* ws, long long ws_ls,
    const float* zb, long long zb_ls, const float* zn, long long zn_ls,
    const float* il2, long long il2_ls, const float* nus, long long nus_ls,
    const float* dts, float* zs, int L, int N, int D, int K, int S, int M,
    int T, int order, int device, void* stream) {
  if (L < 1 || N < 1 || K < 1 || S < 1 || M < 1 || T < 1 ||
      (order != 1 && order != 2) || D != K * order || L > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  // split each output dim's columns into `parts` so a block has ~12 warps
  int parts = (12 + K - 1) / K;
  const int nwarps = K * parts < kMaxWarps ? K * parts : kMaxWarps;
  const size_t smem =
      sizeof(float) * (2 * (size_t)kRows * D + 2 * (size_t)parts * K * kRows);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;

  FlowArgs a;
  a.z0 = z0; a.omf = omf; a.phf = phf; a.ws = ws;
  a.zb = zb; a.zn = zn; a.il2 = il2; a.nus = nus;
  a.z0_ls = z0_ls; a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.ws_ls = ws_ls;
  a.zb_ls = zb_ls; a.zn_ls = zn_ls; a.il2_ls = il2_ls; a.nus_ls = nus_ls;
  a.dts = dts; a.zs = zs;
  a.N = N; a.D = D; a.K = K; a.S = S; a.M = M; a.T = T; a.order = order;
  a.parts = parts;

  const dim3 grid((N + kRows - 1) / kRows, L);
  flow_fused_fwd_kernel<kRows><<<grid, 32 * nwarps, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
