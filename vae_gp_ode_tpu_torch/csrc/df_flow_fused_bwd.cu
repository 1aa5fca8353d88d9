// Discrete adjoint (reverse mode) of the whole DF euler trajectory of
// df_flow_fused.cu, one launch for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_make_bwd_kernel` of
// vae_gp_ode_tpu/ops/df_flow_fused.py. It computes what autograd through
// `df_euler_flow_reference` computes (`df_flow_vjp_reference`). Per draw l
// and batch row it walks t = T-2 .. 0 and recomputes the step's forward
// intermediates from the trajectory z_t that the forward kernel saved
// (df_flow_fused.cu is unchanged; nothing else is saved):
//
//   g_{T-1}    = zsbar[T-1]
//   g_t        = zsbar[t] + g_{t+1} + (d f / d z_t)^T (dt_t g_{t+1})
//   param_bar += (d f / d param)^T (dt_t g_{t+1})
//   dtsbar[t]  = <g_{t+1}, f(z_t)>
//
// Design (df_cluster.cuh states the split). One cluster of C blocks per
// (draw, tile of R rows); its blocks share out the feature columns and the
// inducing points, each point as D (point, output) items, for the whole
// walk. A block keeps its items' operands and cotangents in its own shared
// memory, [field][item] (3D + 1 floats each: omf, G's cos and sin rows
// and phf of a column; Z and nur of a point, and the dnur, dZ, ls2 column
// and var cotangents of a (point, output) item); no other block or thread
// touches them. Per step every thread adds its items' terms for the R
// rows, the block sums the rows' dx terms and <g, f> with warp shuffles,
// and the cluster adds its blocks' sums in rank order through distributed
// shared memory (double-buffered, so one cluster barrier a step); each
// block then holds the same new state cotangent g. The next step's z_t
// and zsbar rows are loaded into registers before the step's work. At
// the end each block writes its columns' and points' cotangents, and rank
// 0 the cluster's ls2 / var sums, the dts cotangents and z0bar, into the
// (draw, row tile) slab: blocks never write to the same address. A second
// kernel of the same launch sums the slabs over row tiles, and over draws
// for operands (and z0) that all draws share, in a fixed order, into the
// cotangents in their operands' shapes (a thread per entry of a per-draw
// cotangent, a warp per entry of a shared one): no atomics and no PyTorch
// reductions; two launches give the same bits.
//
// Shared memory per block: 2 (3D + 1) floats per item and the rows'
// buffers; at the main shapes (D=6, S=256, M=100, clusters of 8) 270 items,
// 42,664 bytes. The launcher takes more blocks per cluster where a block
// would not fit the device's opt-in limit; df_flow_fused_bwd_smem_bytes
// exports the need at clusters of 8, the most the kernel splits a tile
// into, which decides whether the pair takes a flow (on an H100: S up to
// 1920 at D=6, D up to 14 at S=256).
//
// What bounds it on an H100. Per row and step the recompute and the VJP are
// ~150 kFLOP at the main shapes; a train step has L*N*(T-1) = 300 (L=1) or
// 1500 (L=5) row-steps, 45 / 225 MFLOP, 0.7 / 3.4 us at 67 TFLOP/s f32.
// Bound in practice by its T-1 dependent steps, each a thread's item chain
// (sincosf, or D expf and ~35 FMAs per row) and a block and a cluster sum.
//
// The design it replaced: one 256-thread block per (draw, R rows), 25
// blocks at the main shapes (5 at L=1), each thread walking 6 feature
// columns and one inducing point's R D^2 pairs a step, with a 121 KB slab
// of cotangents read and written in shared memory (650 us a launch).

#include "df_cluster.cuh"

namespace cg = cooperative_groups;

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
  float* z0w;          // (L, N, D) z0bar per draw (workspace)
  float* slab;         // (L, n_tiles, P) (workspace)
  float* out;          // the finished cotangents, end to end (finish)
  int L, N, D, SD, M, T, C, CB, MB, n_tiles, IB;
  long long P;         // floats per slab
  // the finished cotangents: z0bar, omf, phf, G, Z, nur, ls2, var, dts.
  // Output q has n[q] entries per draw, per[q] says whether it is per
  // draw (else summed over the draws), out[q] is where it starts in out,
  // off[q] where it lies in a slab (z0bar: in z0w)
  long long n[cl::kOut], off[cl::kOut], o_out[cl::kOut];
  int per[cl::kOut];
};

// Floats per (draw, row tile) slab: [omf (D, SD) | phf (SD) | G (2SD, D) |
// Z (M, D) | nur (M, D) | ls2 (D, D) | var (D) | dts (T-1)].
long long slab_floats(int D, int SD, int M, int T) {
  return (long long)D * SD + SD + 2LL * SD * D + 2LL * M * D +
         (long long)D * D + D + (T - 1);
}

// Floats of a block's dynamic shared memory for items per block IB.
long long smem_floats(int R, int D, int IB) {
  const int RD = R * D, V = RD + 1;
  return 2LL * (3 * D + 1) * IB + 3 * RD + 2 * (D * D + D) +
         dfc::kWarps * V + 2 * V;
}

int items_per_block(const dfc::Plan& p, int D) { return p.CB + p.MB * D; }

template <int R, int DMAX>
__global__ void __launch_bounds__(dfc::kThreads, DMAX <= 8 ? 2 : 1)
    df_flow_fused_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, N = a.N, SD = a.SD, M = a.M, T = a.T, C = a.C;
  const int RD = R * D, V = RD + 1, IB = a.IB;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rank = (int)(blockIdx.x % C);
  const long long group = blockIdx.x / C;
  const long long l = group / a.n_tiles;
  const int r0 = (int)(group % a.n_tiles) * R;
  const dfc::Share sh = dfc::share_of(rank, a.CB, a.MB, SD, M);
  const int items = sh.items(D);
  float* acc = smem;                     // [3D + 1][IB] cotangents
  float* opd = acc + (3 * D + 1) * IB;   // [3D + 1][IB] operands
  float* g = opd + (3 * D + 1) * IB;     // RD  cotangent of z_{t+1}
  float* zt = g + RD;                    // RD  z_t
  float* zb = zt + RD;                   // RD  zsbar[t]
  float* par = zb + RD;                  // D*D + D  1/ls2 | var
  float* epart = par + D * D + D;        // D*D + D  the block's ls2 | var
  float* red = epart + D * D + D;        // kWarps * V
  float* part = red + dfc::kWarps * V;   // 2 * V  the block's sums
  const float* zs = a.zs + l * T * N * D;
  const float* zsbar = a.zsbar + l * T * N * D;
  const float* omf = a.omf + l * a.omf_ls;
  const float* phf = a.phf + l * a.phf_ls;
  const float* G = a.G + l * a.G_ls;
  const float* zp = a.z + l * a.z_ls;
  const float* nur = a.nur + l * a.nur_ls;

  // the items' operands, cotangents 0; rows past N carry g = 0 and z = 0
  // throughout: every contribution they make is scaled by their g
  for (int it = tid; it < items; it += nt) {
    for (int f = 0; f <= 3 * D; ++f) acc[f * IB + it] = 0.f;
    if (it < sh.cn) {
      const int c = sh.c0 + it;
      for (int k = 0; k < D; ++k) {
        opd[k * IB + it] = __ldg(omf + (long long)k * SD + c);
        opd[(D + k) * IB + it] = __ldg(G + (long long)c * D + k);
        opd[(2 * D + k) * IB + it] = __ldg(G + ((long long)SD + c) * D + k);
      }
      opd[3 * D * IB + it] = __ldg(phf + c);
    } else {
      const int q = it - sh.cn;
      const int m = sh.m0 + q / D;
      for (int k = 0; k < D; ++k) {
        opd[k * IB + it] = __ldg(zp + (long long)m * D + k);
        opd[(D + k) * IB + it] = __ldg(nur + (long long)m * D + k);
      }
    }
  }
  float nz = 0.f, nb = 0.f;   // this thread's entry of the next rows
  for (int i = tid; i < RD; i += nt) {
    const int n = r0 + i / D;
    const bool in = n < N;
    g[i] = in ? zsbar[((long long)(T - 1) * N + n) * D + i % D] : 0.f;
    zt[i] = in ? zs[((long long)(T - 2) * N + n) * D + i % D] : 0.f;
    zb[i] = in ? zsbar[((long long)(T - 2) * N + n) * D + i % D] : 0.f;
  }
  df::load_par(par, a.ls2 + l * a.ls2_ls, a.var + l * a.var_ls, D);
  __syncthreads();
  const float* inv = par;
  const float* var = par + D * D;
  float* slab = a.slab + group * a.P;
  const long long off_G = (long long)D * SD + SD;
  const long long off_Z = off_G + 2LL * SD * D;
  const long long off_ls2 = off_Z + 2LL * M * D;
  const long long off_dts = off_ls2 + D * D + D;

  for (int t = T - 2, k = 0; t >= 0; --t, ++k) {
    const float dt = __ldg(a.dts + t);
    if (t > 0 && tid < RD) {     // the rows of step t - 1, ahead
      const int n = r0 + tid / D;
      nz = n < N ? zs[((long long)(t - 1) * N + n) * D + tid % D] : 0.f;
      nb = n < N ? zsbar[((long long)(t - 1) * N + n) * D + tid % D] : 0.f;
    }
    float dx[R][DMAX];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < DMAX; ++i) dx[r][i] = 0.f;
    float fg = 0.f;

    for (int it = tid; it < items; it += nt) {
      if (it < sh.cn) {
        // ORFF prior: u = z . omf[:, c] + phf[c], f += cos(u) Gc + sin(u) Gs
        float om[DMAX], gc[DMAX], gsn[DMAX], ob[DMAX], gcb[DMAX], gsb[DMAX];
#pragma unroll
        for (int i = 0; i < DMAX; ++i) {
          om[i] = i < D ? opd[i * IB + it] : 0.f;
          gc[i] = i < D ? opd[(D + i) * IB + it] : 0.f;
          gsn[i] = i < D ? opd[(2 * D + i) * IB + it] : 0.f;
          ob[i] = gcb[i] = gsb[i] = 0.f;
        }
        const float ph = opd[3 * D * IB + it];
        float pb = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float u = ph;
#pragma unroll
          for (int d = 0; d < DMAX; ++d)
            if (d < D) u = fmaf(zt[r * D + d], om[d], u);
          float sn, cs;
          sincosf(u, &sn, &cs);
          float dc = 0.f, ds = 0.f;
#pragma unroll
          for (int i = 0; i < DMAX; ++i)
            if (i < D) {
              const float gv = g[r * D + i];
              const float gg = dt * gv;
              fg = fmaf(gv, fmaf(cs, gc[i], sn * gsn[i]), fg);
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
              ob[d] = fmaf(zt[r * D + d], du, ob[d]);
              dx[r][d] = fmaf(du, om[d], dx[r][d]);
            }
        }
        acc[3 * D * IB + it] += pb;
#pragma unroll
        for (int i = 0; i < DMAX; ++i)
          if (i < D) {
            acc[i * IB + it] += ob[i];
            acc[(D + i) * IB + it] += gcb[i];
            acc[(2 * D + i) * IB + it] += gsb[i];
          }
      } else {
        // matrix-valued update: point m's pairs (j, i) for output i
        const int i = (it - sh.cn) % D;
        float zm[DMAX], nu[DMAX], dz[DMAX], dnu[DMAX], dl[DMAX];
#pragma unroll
        for (int k2 = 0; k2 < DMAX; ++k2) {
          zm[k2] = k2 < D ? opd[k2 * IB + it] : 0.f;
          nu[k2] = k2 < D ? opd[(D + k2) * IB + it] : 0.f;
          dz[k2] = dnu[k2] = dl[k2] = 0.f;
        }
        const float zi = opd[i * IB + it];
        const float vi = var[i];
        float dv = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float dk[DMAX], dd[DMAX];
          float sq = 0.f, sqb = 0.f, ddi = 0.f;
#pragma unroll
          for (int k2 = 0; k2 < DMAX; ++k2) {
            dk[k2] = k2 < D ? zt[r * D + k2] - zm[k2] : 0.f;
            sq = fmaf(dk[k2], dk[k2], sq);
            dd[k2] = 0.f;
          }
          const float di = zt[r * D + i] - zi;
          const float gv = g[r * D + i];
          const float gi = dt * gv;
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j >= D) continue;
            const float iv = inv[j * D + i];
            const float E = expf(-0.5f * sq * iv);
            const float dji = dk[j] * di;
            float base = dji * iv;
            if (i == j) base += (float)(D - 1) - sq * iv;
            const float c1 = vi * iv;
            const float contrib = E * base * c1;
            fg = fmaf(gv, contrib * nu[j], fg);
            dnu[j] = fmaf(contrib, gi, dnu[j]);
            const float dcon = gi * nu[j];
            const float Eb = dcon * base * c1;
            const float bb = dcon * E * c1;
            const float cb = dcon * E * base;
            sqb = fmaf(Eb * E, -0.5f * iv, sqb);
            float ivb = -0.5f * Eb * E * sq + bb * dji + cb * vi;
            dd[j] = fmaf(bb * di, iv, dd[j]);
            ddi = fmaf(bb * dk[j], iv, ddi);
            if (i == j) {
              sqb -= bb * iv;
              ivb -= bb * sq;
            }
            dv = fmaf(cb, iv, dv);
            dl[j] -= ivb * iv * iv;
          }
          // this item's dx[r, k] term; dZ[m, k] gets its negative
#pragma unroll
          for (int k2 = 0; k2 < DMAX; ++k2)
            if (k2 < D) {
              float tv = fmaf(2.f * dk[k2], sqb, dd[k2]);
              if (k2 == i) tv += ddi;
              dx[r][k2] += tv;
              dz[k2] -= tv;
            }
        }
        acc[3 * D * IB + it] += dv;
#pragma unroll
        for (int k2 = 0; k2 < DMAX; ++k2)
          if (k2 < D) {
            acc[k2 * IB + it] += dnu[k2];
            acc[(D + k2) * IB + it] += dz[k2];
            acc[(2 * D + k2) * IB + it] += dl[k2];
          }
      }
    }

    // the rows' dx terms and <g, f> over the block, then over the cluster
    float* mine = part + (k & 1) * V;
    dfc::block_sums<R, DMAX>(dx, fg, D, V, red, mine);
    if (C > 1) cg::this_cluster().sync();
    if (tid < V) {
      const float s = cl::cluster_sum(mine, C, tid);
      if (tid < RD) {
        g[tid] = zb[tid] + g[tid] + s;
        zt[tid] = nz;
        zb[tid] = nb;
      } else if (rank == 0) {
        slab[off_dts + t] = s;
      }
    }
    __syncthreads();
  }

  // the block's columns and points, then the cluster's ls2 / var sums
  for (int it = tid; it < sh.cn; it += nt) {
    const int c = sh.c0 + it;
    slab[(long long)D * SD + c] = acc[3 * D * IB + it];
    for (int k2 = 0; k2 < D; ++k2) {
      slab[(long long)k2 * SD + c] = acc[k2 * IB + it];
      slab[off_G + (long long)c * D + k2] = acc[(D + k2) * IB + it];
      slab[off_G + ((long long)SD + c) * D + k2] =
          acc[(2 * D + k2) * IB + it];
    }
  }
  for (int e = tid; e < sh.mn * D; e += nt) {
    const int p = e / D, k2 = e % D;
    const int it0 = sh.cn + p * D;
    float snu = 0.f, sz = 0.f;
    for (int i = 0; i < D; ++i) {
      snu += acc[k2 * IB + it0 + i];
      sz += acc[(D + k2) * IB + it0 + i];
    }
    const long long m = sh.m0 + p;
    slab[off_Z + m * D + k2] = sz;
    slab[off_Z + (long long)M * D + m * D + k2] = snu;
  }
  for (int e = tid; e < D * D + D; e += nt) {
    float s = 0.f;
    if (e < D * D) {
      const int j = e / D, i = e % D;
      for (int p = 0; p < sh.mn; ++p)
        s += acc[(2 * D + j) * IB + sh.cn + p * D + i];
    } else {
      for (int p = 0; p < sh.mn; ++p)
        s += acc[3 * D * IB + sh.cn + p * D + e - D * D];
    }
    epart[e] = s;
  }
  if (rank == 0)
    for (int i = tid; i < RD; i += nt) {
      const int n = r0 + i / D;
      if (n < N) a.z0w[(l * N + n) * D + i % D] = g[i];
    }
  if (C == 1) {
    __syncthreads();
    for (int e = tid; e < D * D + D; e += nt) slab[off_ls2 + e] = epart[e];
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0)
    for (int e = tid; e < D * D + D; e += nt) {
      float s = 0.f;
      for (int q = 0; q < C; ++q) s += cluster.map_shared_rank(epart, q)[e];
      slab[off_ls2 + e] = s;
    }
  cluster.sync();   // no block leaves while rank 0 reads its sums
}

// The finished cotangents from the slabs (cluster.cuh finish_slabs).
__global__ void __launch_bounds__(dfc::kThreads)
    df_flow_fused_bwd_finish(BwdArgs a) {
  cl::finish_slabs(a);
}

// The plan for these shapes on `device` (df_cluster.cuh), with more
// blocks per cluster where a block would not fit the opt-in shared memory,
// in p; cudaErrorInvalidValue for shapes the kernel does not take (D above
// 16, a block of an 8-block cluster above the opt-in limit, a grid past
// its limit).
int plan_checked(int L, int N, int D, int SD, int M, int T, int device,
                 dfc::Plan& p) {
  if (L < 1 || N < 1 || D < 1 || D > df::kMaxD || SD < 1 || M < 1 || T < 2)
    return (int)cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  p = dfc::plan_for(L, N, D, SD, M, sms);
  if (!dfc::plan_ok(D, p.R, p.C)) return (int)cudaErrorInvalidValue;
  while (sizeof(float) * smem_floats(p.R, D, items_per_block(p, D)) >
         (size_t)optin) {
    if (p.C == dfc::kMaxCluster) return (int)cudaErrorInvalidValue;
    p = dfc::split(p, p.C + 1, SD, M);
  }
  if (p.groups * p.C > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

template <int R, int DMAX>
int launch(const BwdArgs& a, const dfc::Plan& p, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(R, a.D, a.IB);
  return (int)dfc::launch_clusters(df_flow_fused_bwd_kernel<R, DMAX>, a,
                                   p.groups * p.C, p.C, smem, s);
}

}  // namespace

// Floats per (draw, row tile) slab of parameter cotangents, for the
// wrapper to size the workspace.
extern "C" long long df_flow_fused_bwd_slab_floats(int D, int SD, int M,
                                                   int T) {
  return slab_floats(D, SD, M, T);
}

// The launch's plan on `device`: out = {rows per cluster, blocks per
// cluster, row tiles per draw}. The workspace is L*N*D + L*tiles*P floats
// (P = df_flow_fused_bwd_slab_floats). Returns cudaErrorInvalidValue for
// shapes the kernel does not take.
extern "C" int df_flow_fused_bwd_plan(int L, int N, int D, int SD, int M,
                                      int T, int device, int* out) {
  dfc::Plan p;
  const int err = plan_checked(L, N, D, SD, M, T, device, p);
  if (err) return err;
  out[0] = p.R;
  out[1] = p.C;
  out[2] = p.n_tiles;
  return 0;
}

// Dynamic shared memory of one block in a cluster of 8 (the most the
// kernel splits a row tile into) at the largest rows per cluster for D:
// the pair takes a flow where this fits the device's opt-in limit, so a
// caller can decide before the forward whether the pair will run.
extern "C" long long df_flow_fused_bwd_smem_bytes(int D, int SD, int M) {
  dfc::Plan p = {};
  p.R = D <= 8 ? 4 : 2;
  p = dfc::split(p, dfc::kMaxCluster, SD, M);
  return (long long)sizeof(float) *
         smem_floats(p.R, D, items_per_block(p, D));
}

// The device's opt-in shared memory per block, or -1 if it cannot be read.
extern "C" int df_flow_fused_bwd_smem_optin(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin;
}

// Launches the adjoint kernel and its summing kernel on `stream` and
// returns the CUDA error, or cudaErrorInvalidValue for shapes or a plan
// (see df_flow_fused_bwd_plan) it does not take. Operands are f32 and
// contiguous; each `*_ls` is the element stride between draws (0 for an
// operand that all draws share). zs and zsbar are (L, T, N, D); work holds
// L*N*D + L*tiles*P floats; out receives, end to end, z0bar ((N, D) summed
// over the draws if z0_shared, else (L, N, D)), the cotangents of omf,
// phf, G, Z, nur, ls2 and var in their operands' shapes (summed over the
// draws for a shared operand) and dts's (T-1); every entry is written.
extern "C" int df_flow_fused_bwd(
    const float* zs, const float* zsbar, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* G, long long G_ls,
    const float* z, long long z_ls, const float* nur, long long nur_ls,
    const float* ls2, long long ls2_ls, const float* var, long long var_ls,
    const float* dts, float* work, float* out, int L, int N, int D, int SD,
    int M, int T, int z0_shared, int device, void* stream) {
  dfc::Plan p;
  const int bad = plan_checked(L, N, D, SD, M, T, device, p);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  BwdArgs a;
  a.zs = zs; a.zsbar = zsbar;
  a.omf = omf; a.phf = phf; a.G = G; a.z = z; a.nur = nur; a.ls2 = ls2;
  a.var = var;
  a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.G_ls = G_ls; a.z_ls = z_ls;
  a.nur_ls = nur_ls; a.ls2_ls = ls2_ls; a.var_ls = var_ls;
  a.dts = dts; a.z0w = work; a.slab = work + (long long)L * N * D;
  a.out = out;
  a.L = L; a.N = N; a.D = D; a.SD = SD; a.M = M; a.T = T;
  a.C = p.C; a.CB = p.CB; a.MB = p.MB; a.n_tiles = p.n_tiles;
  a.IB = items_per_block(p, D);
  a.P = slab_floats(D, SD, M, T);
  const long long sizes[cl::kOut] = {
      (long long)N * D, (long long)D * SD, SD, 2LL * SD * D,
      (long long)M * D, (long long)M * D, (long long)D * D, D, T - 1};
  const int per[cl::kOut] = {!z0_shared, omf_ls != 0, phf_ls != 0,
                             G_ls != 0, z_ls != 0, nur_ls != 0,
                             ls2_ls != 0, var_ls != 0, 0};
  const long long blocks = cl::layout_slabs(a, sizes, per);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (D <= 8)
    rc = p.R == 4   ? launch<4, 8>(a, p, s)
         : p.R == 2 ? launch<2, 8>(a, p, s)
                    : launch<1, 8>(a, p, s);
  else
    rc = p.R == 2 ? launch<2, 16>(a, p, s) : launch<1, 16>(a, p, s);
  if (rc) return rc;
  df_flow_fused_bwd_finish<<<(unsigned)blocks, dfc::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
