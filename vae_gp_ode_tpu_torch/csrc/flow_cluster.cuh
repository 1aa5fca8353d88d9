// The split that the dimwise-RBF euler pair shares: the trajectory
// (flow_fused.cu, #1) and its discrete adjoint (flow_fused_bwd.cu, #2),
// on cluster.cuh's split. One (draw, tile of R batch rows) is a cluster of
// C thread blocks; the block of rank b owns, for the whole walk,
//
//  - feature columns c in [b CB, (b + 1) CB) of the K*S packed columns
//    (output dim k = c / S): x . omf[:, c], one cos (#1) or sincos (#2) a
//    row;
//  - inducing columns m in [b MB, (b + 1) MB) of the K*M packed columns
//    (output dim k = m / M): the scaled distance to Z_m, one exp a row;
//
// each one "item", and keeps its items' operands in its own dynamic shared
// memory, [field][item]: a feature column's omf (D), phf and ws, an
// inducing column's Zb (D), il2 (D), zn and nus (2D + 2 fields). Both
// kernels take one plan (plan_on): cluster.cuh's plan_for with R0 = 4 rows
// per cluster up to D = 8, else 2, and K*S + K*M items, with more blocks
// per cluster where the adjoint's block would not fit the device's opt-in
// shared memory; so a step's f is summed in the same order in both. At the
// main shapes (D = K = 6, S = 256, M = 100) that is 4-block clusters of 2
// rows at L = 5, N = 20 (50 clusters, 534 items a block) and 8-block
// clusters of one row at L = 1, N = 20 (20 clusters, 267 items a block).

#pragma once

#include "cluster.cuh"

namespace fc {

constexpr int kMaxD = 16;   // the widest state dim the pair takes

// One draw's packed operands (ops/flow_fused.py `_pack_operands`).
struct Draw {
  const float* omf;  // (D, K*S)
  const float* phf;  // (K*S,)
  const float* ws;   // (K*S,)
  const float* zb;   // (D, K*M)
  const float* zn;   // (K*M,)
  const float* il2;  // (D, K*M)
  const float* nus;  // (K*M,)
};

// Fields an item keeps in shared memory.
__host__ __device__ inline int fields(int D) { return 2 * D + 2; }

// Floats of the adjoint's block for R rows and IB items: its items'
// operands and cotangents, the rows' buffers (g, z_t, zsbar[t]), the
// warps' partials and the block's sums, double-buffered.
inline long long bwd_smem_floats(int R, int D, int IB) {
  const int RD = R * D, V = RD + 1;
  return 2LL * fields(D) * IB + 3 * RD + cl::kWarps * V + 2 * V;
}

// Floats of the trajectory kernel's block: its items' operands, the
// tile's state, the warps' partials and the block's sums of f,
// double-buffered.
inline long long fwd_smem_floats(int R, int D, int K, int IB) {
  const int RK = R * K;
  return (long long)fields(D) * IB + R * D + cl::kWarps * RK + 2 * RK;
}

// Whether (L, N, D, K, S, M, order) is a shape the pair takes.
inline bool shape_ok(int L, int N, int D, int K, int S, int M, int order) {
  return L >= 1 && N >= 1 && K >= 1 && S >= 1 && M >= 1 &&
         (order == 1 || order == 2) && D == K * order && D <= kMaxD;
}

// The plan of both kernels at these shapes on `device`, in p;
// cudaErrorInvalidValue for shapes they do not take (see shape_ok, a block
// of an 8-block cluster above the opt-in limit, a grid past its limit).
inline int plan_on(int device, int L, int N, int D, int K, int S, int M,
                   int order, cl::Plan& p) {
  if (!shape_ok(L, N, D, K, S, M, order)) return (int)cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const int KS = K * S, KM = K * M;
  p = cl::plan_for(L, N, D <= 8 ? 4 : 2, (long long)KS + KM, KS, KM, sms);
  while (sizeof(float) * bwd_smem_floats(p.R, D, p.CB + p.MB) >
         (size_t)optin) {
    if (p.C == cl::kMaxCluster) return (int)cudaErrorInvalidValue;
    p = cl::split(p, p.C + 1, KS, KM);
  }
  if (p.groups * p.C > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

// opd[f * IB + it] <- field f of the block's item it.
__device__ inline void load_items(float* opd, int IB, const Draw& w,
                                  const cl::Share& sh, int D, int KS,
                                  int KM) {
  for (int it = threadIdx.x; it < sh.items(1); it += blockDim.x) {
    if (it < sh.cn) {
      const int c = sh.c0 + it;
      for (int d = 0; d < D; ++d)
        opd[d * IB + it] = __ldg(w.omf + (long long)d * KS + c);
      opd[D * IB + it] = __ldg(w.phf + c);
      opd[(D + 1) * IB + it] = __ldg(w.ws + c);
    } else {
      const int m = sh.m0 + it - sh.cn;
      for (int d = 0; d < D; ++d) {
        opd[d * IB + it] = __ldg(w.zb + (long long)d * KM + m);
        opd[(D + d) * IB + it] = __ldg(w.il2 + (long long)d * KM + m);
      }
      opd[2 * D * IB + it] = __ldg(w.zn + m);
      opd[(2 * D + 1) * IB + it] = __ldg(w.nus + m);
    }
  }
}

}  // namespace fc
