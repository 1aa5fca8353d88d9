// Device routines that the divergence-free (DF) kernels share: the
// cluster kernels (df_pathwise_fwd.cu, df_pathwise_bwd.cu, df_flow_fused.cu,
// df_flow_fused_bwd.cu, on the split of df_cluster.cuh) and the grid-tiled
// pair (df_pathwise_tiled_*.cu) take the operand layout, the parameter
// loads and the warp sums from here. They replace the value-level bodies
// `_df_eval_body`, `_df_update_body`, `_df_eval_vjp_body` and
// `_df_update_vjp_body` of vae_gp_ode_tpu/ops/df_pathwise.py, which the
// TPU's four DF kernels share in the same way.
//
// What one evaluation computes, per batch row x (D,) and output dim i
// (the operand layout of `df_pathwise_reference`):
//
//   f_i(x) = sum_c cos(u_c) G[c, i] + sin(u_c) G[SD + c, i],
//            u_c = x . omf[:, c] + phf[c]               (c < SD = S*D)
//          + sum_{j, m} (var_i / ls2[j, i]) exp(-r2_m / (2 ls2[j, i]))
//            * (d_j d_i / ls2[j, i] + ((D-1) - r2_m / ls2[j, i]) [i == j])
//            * nur[m, j],
//   d = x - Z[m],  r2_m = |d|^2.
//
// The ORFF prior's x . omf and its contraction with G are computed in the
// kernels, column by column, not by a library product; the VJPs recompute
// the forward intermediates and add the terms of autograd through it.
//
// Accuracy: accurate sincosf/expf, no fast-math (x . omf can be large);
// everything is f32, no TF32.

#pragma once

#include <cuda_runtime.h>

namespace df {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 16;   // the cluster kernels' widest state dim

// One draw's operands.
struct Draw {
  const float* omf;  // (D, SD)
  const float* phf;  // (SD,)
  const float* G;    // (2 SD, D)
  const float* z;    // (M, D)
  const float* nur;  // (M, D)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// par (shared, D*D + D floats) <- [1 / ls2 (row-major [j, i]) | var].
__device__ __forceinline__ void load_par(float* par, const float* ls2,
                                         const float* var, int D) {
  for (int i = threadIdx.x; i < D * D + D; i += blockDim.x)
    par[i] = i < D * D ? 1.f / ls2[i] : var[i - D * D];
}

}  // namespace df
