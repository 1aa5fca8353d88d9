// Device routines of the divergence-free (DF) kernels: the single-block
// per-step VJP (df_pathwise_bwd.cu) and the euler trajectory
// (df_flow_fused.cu) run on the block routines below; the per-step eval
// (df_pathwise_fwd.cu) and the trajectory's discrete adjoint
// (df_flow_fused_bwd.cu), clusters of blocks
// (df_cluster.cuh), and the grid-tiled pair take the operand layout, the
// parameter loads and the warp sums. The block routines replace the
// value-level bodies `_df_eval_body`, `_df_update_body`,
// `_df_eval_vjp_body` and `_df_update_vjp_body` of
// vae_gp_ode_tpu/ops/df_pathwise.py, which the TPU's four DF kernels
// share in the same way.
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
// The ORFF prior's x . omf and its contraction with G are computed here,
// column by column, not by a library product: each thread owns feature
// columns c (c = tid, tid + blockDim.x, ...) and inducing points m, and
// the routines work on R batch rows held in shared memory. Every
// operand-shaped cotangent the VJP produces is written only by the thread
// that owns its column or inducing point, into accumulators that may lie in
// shared or in global memory (generic pointers); sums over the block (the
// rows' dx, the ls2 and var cotangents, <g, f>) go through registers, warp
// shuffles and one pass over the warps' partials. No atomics: a result does
// not depend on the order in which threads or blocks run.
//
// R (rows per block) and DMAX (a bound on D) are compile-time, so the
// per-row and per-pair partials stay in registers: R = 4, DMAX = 8 takes
// D <= 8 with every loop over rows and output-dim pairs unrolled; R = 2,
// DMAX = 16 takes D <= 16 with the pair loops kept as loops (slower; its
// small arrays may live in local memory). Wider D is refused.
//
// Accuracy: accurate sincosf/expf, no fast-math (x . omf can be large);
// everything is f32, no TF32.

#pragma once

#include <cuda_runtime.h>

namespace df {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 16;

// Batch rows per block for state dim D (0 for a D the kernels refuse).
inline int rows_for(int D) { return D < 1 || D > kMaxD ? 0 : (D <= 8 ? 4 : 2); }

// One draw's operands.
struct Draw {
  const float* omf;  // (D, SD)
  const float* phf;  // (SD,)
  const float* G;    // (2 SD, D)
  const float* z;    // (M, D)
  const float* nur;  // (M, D)
};

// Accumulators of the operand-shaped cotangents; each entry is owned by
// one thread of the block.
struct Bars {
  float* omf;  // (D, SD)
  float* phf;  // (SD,)
  float* G;    // (2 SD, D)
  float* z;    // (M, D)
  float* nur;  // (M, D)
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

// This thread's share of f for the R rows xs (shared, R*D): acc[r][i].
template <int R, int DMAX>
__device__ void eval_partials(const Draw& p, const float* xs,
                              const float* par, int D, int SD, int M,
                              float (&acc)[R][DMAX]) {
  const float* inv = par;
  const float* var = par + D * D;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < DMAX; ++i) acc[r][i] = 0.f;

  // ORFF prior over this thread's feature columns
  for (int c = threadIdx.x; c < SD; c += blockDim.x) {
    float u[R];
    const float ph = __ldg(p.phf + c);
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = ph;
    for (int d = 0; d < D; ++d) {
      const float o = __ldg(p.omf + (long long)d * SD + c);
#pragma unroll
      for (int r = 0; r < R; ++r) u[r] = fmaf(xs[r * D + d], o, u[r]);
    }
    float gc[DMAX], gs[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      gc[i] = i < D ? __ldg(p.G + (long long)c * D + i) : 0.f;
      gs[i] = i < D ? __ldg(p.G + ((long long)SD + c) * D + i) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float sn, cs;
      sincosf(u[r], &sn, &cs);
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        acc[r][i] = fmaf(cs, gc[i], fmaf(sn, gs[i], acc[r][i]));
    }
  }

  // matrix-valued pathwise update over this thread's inducing points
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float zm[DMAX], nu[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      zm[k] = k < D ? __ldg(p.z + (long long)m * D + k) : 0.f;
      nu[k] = k < D ? __ldg(p.nur + (long long)m * D + k) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float dk[DMAX];
      float sq = 0.f;
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        dk[k] = k < D ? xs[r * D + k] - zm[k] : 0.f;
        sq = fmaf(dk[k], dk[k], sq);
      }
#pragma unroll (DMAX <= 8 ? DMAX : 1)
      for (int i = 0; i < DMAX; ++i) {
        if (i >= D) continue;
        float s = 0.f;
#pragma unroll (DMAX <= 8 ? DMAX : 1)
        for (int j = 0; j < DMAX; ++j) {
          if (j >= D) continue;
          const float iv = inv[j * D + i];
          const float E = expf(-0.5f * sq * iv);
          float base = dk[j] * dk[i] * iv;
          if (i == j) base += (float)(D - 1) - sq * iv;
          s = fmaf(E * base * (var[i] * iv), nu[j], s);
        }
        acc[r][i] += s;
      }
    }
  }
}

// out[r*D + i] (shared, R*D + 1) <- acc[r][i] summed over the block, and
// out[R*D] <- extra summed over the block. red holds kWarps * (R*D + 1)
// floats. Starts and ends with a barrier.
template <int R, int DMAX>
__device__ void reduce_rows(float (&acc)[R][DMAX], float extra, int D,
                            float* red, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int V = R * D + 1;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < D) {
        const float v = warp_sum(acc[r][i]);
        if (lane == 0) red[warp * V + r * D + i] = v;
      }
  {
    const float v = warp_sum(extra);
    if (lane == 0) red[warp * V + R * D] = v;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < V; t += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[w * V + t];
    out[t] = s;
  }
  __syncthreads();
}

// out (D*D + D) <- [dl[j][i] as row-major (D, D) | dv] summed over the
// block; red holds kWarps * (D*D + D) floats. Starts and ends with a
// barrier.
template <int DMAX>
__device__ void reduce_params(float (&dl)[DMAX * DMAX], float (&dv)[DMAX],
                              int D, float* red, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int V = D * D + D;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < DMAX; ++j)
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (j < D && i < D) {
        const float v = warp_sum(dl[j * DMAX + i]);
        if (lane == 0) red[warp * V + j * D + i] = v;
      }
#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    if (i < D) {
      const float v = warp_sum(dv[i]);
      if (lane == 0) red[warp * V + D * D + i] = v;
    }
  __syncthreads();
  for (int t = threadIdx.x; t < V; t += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += red[w * V + t];
    out[t] = s;
  }
  __syncthreads();
}

// VJP of one evaluation at the R rows xs (shared, R*D) for the cotangent
// scale * gs (gs shared, R*D). Adds the operand-shaped cotangents of this
// thread's columns and inducing points into b, and this thread's share of
// dx (per row), of the ls2 cotangent (dl[j*DMAX + i]), of the var
// cotangent (dv) and of <gs, f(xs)> (fg) into the register partials.
template <int R, int DMAX>
__device__ void vjp_accumulate(const Draw& p, const float* xs,
                               const float* gs, float scale,
                               const float* par, int D, int SD, int M,
                               const Bars& b, float (&dx)[R][DMAX],
                               float (&dl)[DMAX * DMAX], float (&dv)[DMAX],
                               float& fg) {
  const float* inv = par;
  const float* var = par + D * D;

  // ORFF prior: u = x . omf[:, c] + phf[c], f += cos(u) Gc + sin(u) Gs
  for (int c = threadIdx.x; c < SD; c += blockDim.x) {
    float om[DMAX], gc[DMAX], gsn[DMAX], ob[DMAX], gcb[DMAX], gsb[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      om[i] = i < D ? __ldg(p.omf + (long long)i * SD + c) : 0.f;
      gc[i] = i < D ? __ldg(p.G + (long long)c * D + i) : 0.f;
      gsn[i] = i < D ? __ldg(p.G + ((long long)SD + c) * D + i) : 0.f;
      ob[i] = 0.f;
      gcb[i] = 0.f;
      gsb[i] = 0.f;
    }
    const float ph = __ldg(p.phf + c);
    float pb = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float u = ph;
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        if (d < D) u = fmaf(xs[r * D + d], om[d], u);
      float sn, cs;
      sincosf(u, &sn, &cs);
      float dc = 0.f, ds = 0.f;
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < D) {
          const float g = gs[r * D + i];
          const float gg = scale * g;
          fg = fmaf(g, fmaf(cs, gc[i], sn * gsn[i]), fg);
          gcb[i] = fmaf(cs, gg, gcb[i]);
          gsb[i] = fmaf(sn, gg, gsb[i]);
          dc = fmaf(gg, gc[i], dc);
          ds = fmaf(gg, gsn[i], ds);
        }
      const float du = cs * ds - sn * dc;
      pb += du;
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        if (d < D) {
          ob[d] = fmaf(xs[r * D + d], du, ob[d]);
          dx[r][d] = fmaf(du, om[d], dx[r][d]);
        }
    }
    b.phf[c] += pb;
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < D) {
        b.omf[(long long)i * SD + c] += ob[i];
        b.G[(long long)c * D + i] += gcb[i];
        b.G[((long long)SD + c) * D + i] += gsb[i];
      }
  }

  // matrix-valued update, recomputed per (row, inducing point, pair)
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float zm[DMAX], nu[DMAX], dz[DMAX], dnu[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k) {
      zm[k] = k < D ? __ldg(p.z + (long long)m * D + k) : 0.f;
      nu[k] = k < D ? __ldg(p.nur + (long long)m * D + k) : 0.f;
      dz[k] = 0.f;
      dnu[k] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float dk[DMAX], dd[DMAX];
      float sq = 0.f, sqb = 0.f;
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        dk[k] = k < D ? xs[r * D + k] - zm[k] : 0.f;
        sq = fmaf(dk[k], dk[k], sq);
        dd[k] = 0.f;
      }
#pragma unroll (DMAX <= 8 ? DMAX : 1)
      for (int i = 0; i < DMAX; ++i) {
        if (i >= D) continue;
        const float g = gs[r * D + i];
        const float gi = scale * g;
        const float vi = var[i];
#pragma unroll (DMAX <= 8 ? DMAX : 1)
        for (int j = 0; j < DMAX; ++j) {
          if (j >= D) continue;
          const float iv = inv[j * D + i];
          const float E = expf(-0.5f * sq * iv);
          const float dji = dk[j] * dk[i];
          float base = dji * iv;
          if (i == j) base += (float)(D - 1) - sq * iv;
          const float c1 = vi * iv;
          const float contrib = E * base * c1;
          fg = fmaf(g, contrib * nu[j], fg);
          dnu[j] = fmaf(contrib, gi, dnu[j]);
          const float dcon = gi * nu[j];
          const float Eb = dcon * base * c1;
          const float bb = dcon * E * c1;
          const float cb = dcon * E * base;
          sqb = fmaf(Eb * E, -0.5f * iv, sqb);
          float ivb = -0.5f * Eb * E * sq + bb * dji + cb * vi;
          dd[j] = fmaf(bb * dk[i], iv, dd[j]);
          dd[i] = fmaf(bb * dk[j], iv, dd[i]);
          if (i == j) {
            sqb -= bb * iv;
            ivb -= bb * sq;
          }
          dv[i] = fmaf(cb, iv, dv[i]);
          dl[j * DMAX + i] -= ivb * iv * iv;
        }
      }
#pragma unroll
      for (int k = 0; k < DMAX; ++k)
        if (k < D) {
          const float t = fmaf(2.f * dk[k], sqb, dd[k]);
          dx[r][k] += t;
          dz[k] -= t;
        }
    }
#pragma unroll
    for (int k = 0; k < DMAX; ++k)
      if (k < D) {
        b.z[(long long)m * D + k] += dz[k];
        b.nur[(long long)m * D + k] += dnu[k];
      }
  }
}

}  // namespace df
