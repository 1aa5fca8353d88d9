// Reverse mode (VJP) of the per-step DF pathwise evaluation in
// df_pathwise_fwd.cu, one launch for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_make_bwd_kernel` of
// vae_gp_ode_tpu/ops/df_pathwise.py (`_df_eval_vjp_body`,
// `_df_update_vjp_body`). It computes what autograd through
// `df_pathwise_reference` computes for a cotangent g (L, N, D), recomputing
// the forward intermediates instead of storing them (the item loop below
// states the terms).
//
// Outputs: dx (L, N, D), and the cotangents of omf, phf, G, Z, nur, ls2 and
// var in their operands' shapes, each per draw or, for an operand that all
// draws share (stride 0), summed over the draws. The continuous adjoint
// needs each draw's own cotangent of Z, ls2, var and G, which per-draw
// operands give.
//
// Design (df_cluster.cuh states the split). One cluster of C blocks per
// (draw, tile of RT rows), with walk_plan_for's plan; the block of rank b
// owns its share of the feature columns and (point, output) items and
// walks the tile's rows R at a time, keeping its items' operand cotangents
// (omf, phf, G of a column; nur, Z, the ls2 column and var of a (point,
// output) item) in its shared memory, [field][item], for the whole walk:
// no other block or thread touches them. Per pass every thread adds its
// items' terms for the R rows; the rows' dx terms go through warp shuffles
// into the block's dx partials (shared memory), and at the end of the
// walk one cluster barrier and every entry's sum over the blocks in rank
// order through distributed shared memory gives dx; the ls2 / var sums of
// the blocks' points likewise. The blocks write their columns' and points'
// cotangents once, into the (draw, tile) slab (L, n_tiles, P), rank 0 the
// cluster's ls2 / var sums: blocks never write to the same address. A
// second kernel of the same launch sums the slabs over the row tiles, and
// over the draws for an operand that all draws share, in a fixed order,
// into the cotangents in their operands' shapes (a thread per entry of a
// per-draw cotangent, a warp per entry of a shared one): no atomics and no
// PyTorch reductions after the call; two launches give the same bits.
// Where a block's items would not fit the device's opt-in shared memory
// (wide S at D near 16), it walks the tile once per chunk of its items
// that does. Any N, S and M is taken (a point's D items are never split
// over chunks); D above 16 is refused.
//
// What bounds it on an H100. Recompute and VJP are about SD(6D + 10) +
// 40 M D^2 operations per row: ~150 kFLOP at the main shapes, 90 MFLOP at
// L*N = 600 rows (1.3 us at 67 TFLOP/s f32), against 121.7 KB of operands
// and cotangents per draw and the slabs (30 tiles of 121.7 KB at L=1,
// N=600). In practice the issue rate of a thread's item chain (sincosf, or
// D expf and ~35 FMAs per row) and the latency of the passes' block sums.
//
// The design it replaced: one 256-thread block per (draw, R rows) that
// zeroed and read-modify-wrote its own 121.7 KB slab in global memory,
// each thread with 6 columns and one point's R D^2 pairs, the slabs summed
// over the row tiles in PyTorch (150 blocks and 18.3 MB of slabs at L=1,
// N=600: 127 us a launch on an H100, PERF.md section 6).

#include "df_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kOut = 7;   // omf, phf, G, Z, nur, ls2, var

struct BwdArgs {
  const float* x;    // (N, D) per draw at x_ls
  const float* omf;  // (D, SD)
  const float* phf;  // (1, SD)
  const float* G;    // (2SD, D)
  const float* z;    // (M, D)
  const float* nur;  // (M, D)
  const float* ls2;  // (D, D)
  const float* var;  // (D,)
  long long x_ls, omf_ls, phf_ls, G_ls, z_ls, nur_ls, ls2_ls, var_ls;
  const float* g;    // (L, N, D) cotangent of the output
  float* dx;         // (L, N, D)
  float* slab;       // (L, n_tiles, P) (workspace)
  float* out;        // the finished operand cotangents, end to end
  int L, N, D, SD, M, C, CB, MB, RT, n_tiles, IC;
  long long P;       // floats per slab
  // output q (omf .. var) has n[q] entries per draw at off[q] in a slab
  // and starts at o_out[q] in out; per[q]: one per draw, else summed over
  // the draws
  long long n[kOut], off[kOut], o_out[kOut];
  int per[kOut];
};

// Floats per (draw, row tile) slab: [omf (D, SD) | phf (SD) | G (2SD, D) |
// Z (M, D) | nur (M, D) | ls2 (D, D) | var (D)].
long long slab_floats(int D, int SD, int M) {
  return (long long)D * SD + SD + 2LL * SD * D + 2LL * M * D +
         (long long)D * D + D;
}

// Floats of a block's dynamic shared memory besides its items'
// cotangents: the pass's rows and cotangent, 1/ls2 | var, the warps'
// partials, the pass's sums, the tile's dx partials and the block's ls2 |
// var sums.
long long rest_floats(int R, int D, int RT) {
  const int RD = R * D;
  return 2LL * RD + 2 * (D * D + D) + dfc::kWarps * RD + RD +
         (long long)RT * D;
}

template <int R, int DMAX>
__global__ void __launch_bounds__(dfc::kThreads, DMAX <= 8 ? 2 : 1)
    df_pathwise_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, N = a.N, SD = a.SD, M = a.M, C = a.C, IC = a.IC;
  const int RD = R * D;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rank = (int)(blockIdx.x % C);
  const long long group = blockIdx.x / C;
  const long long l = group / a.n_tiles;
  const int t0 = (int)(group % a.n_tiles) * a.RT;
  const int t1 = t0 + a.RT < N ? t0 + a.RT : N;
  const dfc::Share sh = dfc::share_of(rank, a.CB, a.MB, SD, M);
  float* acc = smem;                          // [3D + 1][IC] cotangents
  float* xs = acc + (3 * D + 1) * IC;         // RD  the pass's rows
  float* gs = xs + RD;                        // RD  and their cotangent
  float* par = gs + RD;                       // D*D + D  1/ls2 | var
  float* epart = par + D * D + D;             // D*D + D  ls2 | var sums
  float* red = epart + D * D + D;             // kWarps * RD
  float* sums = red + dfc::kWarps * RD;       // RD  the pass's dx sums
  float* dxp = sums + RD;                     // RT * D  the tile's dx
  const float* x = a.x + l * a.x_ls;
  const float* g = a.g + l * N * D;
  const float* omf = a.omf + l * a.omf_ls;
  const float* phf = a.phf + l * a.phf_ls;
  const float* G = a.G + l * a.G_ls;
  const float* zp = a.z + l * a.z_ls;
  const float* nur = a.nur + l * a.nur_ls;
  float* slab = a.slab + group * a.P;
  const long long off_G = (long long)D * SD + SD;
  const long long off_Z = off_G + 2LL * SD * D;
  const long long off_ls2 = off_Z + 2LL * M * D;

  df::load_par(par, a.ls2 + l * a.ls2_ls, a.var + l * a.var_ls, D);
  for (int e = tid; e < D * D + D; e += nt) epart[e] = 0.f;
  for (int e = tid; e < a.RT * D; e += nt) dxp[e] = 0.f;
  const float* inv = par;
  const float* var = par + D * D;

  // the block's items [0, cn) columns, then [cn, cn + mn D) (point,
  // output) items, in chunks [i0, i1) of at most IC items, points whole
  const int n_items = sh.items(D);
  for (int i0 = 0; i0 < n_items;) {
    int i1 = i0 + IC < n_items ? i0 + IC : n_items;
    if (i1 > sh.cn) i1 = sh.cn + (i1 - sh.cn) / D * D;
    const int n_it = i1 - i0;
    const int pt0 = i0 > sh.cn ? i0 : sh.cn;   // the chunk's first point item
    const int n_pi = i1 > pt0 ? i1 - pt0 : 0;
    for (int it = tid; it < n_it; it += nt)
      for (int f = 0; f <= 3 * D; ++f) acc[f * IC + it] = 0.f;

    for (int p0 = t0; p0 < t1; p0 += R) {
      __syncthreads();   // the last pass has read xs, gs and sums
      // rows past the tile carry x = 0 and g = 0: every term they add is
      // scaled by their g
      for (int i = tid; i < RD; i += nt) {
        const int n = p0 + i / D;
        xs[i] = n < t1 ? x[(long long)n * D + i % D] : 0.f;
        gs[i] = n < t1 ? g[(long long)n * D + i % D] : 0.f;
      }
      __syncthreads();
      float dx[R][DMAX];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < DMAX; ++i) dx[r][i] = 0.f;

      // the threads take the chunk's (point, output) items first (one
      // costs D expf and ~35 D FMAs a row, a column one sincosf and ~7 D
      // FMAs), so a thread with two items has two columns
      for (int t = tid; t < n_it; t += nt) {
        const int k = t < n_pi ? n_it - n_pi + t : t - n_pi;   // acc index
        const int it = i0 + k;
        if (it < sh.cn) {
          // ORFF prior: u = x . omf[:, c] + phf[c], f += cos(u) Gc +
          // sin(u) Gs
          const int c = sh.c0 + it;
          float om[DMAX], gc[DMAX], gsn[DMAX], ob[DMAX], gcb[DMAX],
              gsb[DMAX];
#pragma unroll
          for (int i = 0; i < DMAX; ++i) {
            om[i] = i < D ? __ldg(omf + (long long)i * SD + c) : 0.f;
            gc[i] = i < D ? __ldg(G + (long long)c * D + i) : 0.f;
            gsn[i] = i < D ? __ldg(G + ((long long)SD + c) * D + i) : 0.f;
            ob[i] = gcb[i] = gsb[i] = 0.f;
          }
          const float ph = __ldg(phf + c);
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
                const float gg = gs[r * D + i];
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
          acc[3 * D * IC + k] += pb;
#pragma unroll
          for (int i = 0; i < DMAX; ++i)
            if (i < D) {
              acc[i * IC + k] += ob[i];
              acc[(D + i) * IC + k] += gcb[i];
              acc[(2 * D + i) * IC + k] += gsb[i];
            }
        } else {
          // matrix-valued update: point m's pairs (j, i) for output i
          const int q = it - sh.cn;
          const int m = sh.m0 + q / D, i = q % D;
          float zm[DMAX], nu[DMAX], dz[DMAX], dnu[DMAX], dl[DMAX];
#pragma unroll
          for (int k2 = 0; k2 < DMAX; ++k2) {
            zm[k2] = k2 < D ? __ldg(zp + (long long)m * D + k2) : 0.f;
            nu[k2] = k2 < D ? __ldg(nur + (long long)m * D + k2) : 0.f;
            dz[k2] = dnu[k2] = dl[k2] = 0.f;
          }
          const float zi = __ldg(zp + (long long)m * D + i);
          const float vi = var[i];
          float dv = 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float dk[DMAX], dd[DMAX];
            float sq = 0.f, sqb = 0.f, ddi = 0.f;
#pragma unroll
            for (int k2 = 0; k2 < DMAX; ++k2) {
              dk[k2] = k2 < D ? xs[r * D + k2] - zm[k2] : 0.f;
              sq = fmaf(dk[k2], dk[k2], sq);
              dd[k2] = 0.f;
            }
            const float di = xs[r * D + i] - zi;
            const float gi = gs[r * D + i];
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
          acc[3 * D * IC + k] += dv;
#pragma unroll
          for (int k2 = 0; k2 < DMAX; ++k2)
            if (k2 < D) {
              acc[k2 * IC + k] += dnu[k2];
              acc[(D + k2) * IC + k] += dz[k2];
              acc[(2 * D + k2) * IC + k] += dl[k2];
            }
        }
      }
      // the pass's dx terms over the block, added to the tile's partials
      // (thread t sums entry t and adds it, so no barrier between)
      dfc::block_sums<R, DMAX>(dx, 0.f, D, RD, red, sums);
      for (int t = tid; t < RD; t += nt) dxp[(p0 - t0) * D + t] += sums[t];
    }

    // the chunk's columns, by their owners; its points' Z and nur (sums
    // over a point's D items) and ls2 / var terms (over the points)
    for (int k = tid; k < n_it && i0 + k < sh.cn; k += nt) {
      const int c = sh.c0 + i0 + k;
      slab[(long long)D * SD + c] = acc[3 * D * IC + k];
      for (int k2 = 0; k2 < D; ++k2) {
        slab[(long long)k2 * SD + c] = acc[k2 * IC + k];
        slab[off_G + (long long)c * D + k2] = acc[(D + k2) * IC + k];
        slab[off_G + ((long long)SD + c) * D + k2] =
            acc[(2 * D + k2) * IC + k];
      }
    }
    if (i1 > pt0) {
      __syncthreads();
      const int np = (i1 - pt0) / D;
      for (int e = tid; e < np * D; e += nt) {
        const int pp = e / D, k2 = e % D;
        const int k0 = pt0 - i0 + pp * D;
        float snu = 0.f, sz = 0.f;
        for (int i = 0; i < D; ++i) {
          snu += acc[k2 * IC + k0 + i];
          sz += acc[(D + k2) * IC + k0 + i];
        }
        const long long m = sh.m0 + (pt0 - sh.cn) / D + pp;
        slab[off_Z + m * D + k2] = sz;
        slab[off_Z + (long long)M * D + m * D + k2] = snu;
      }
      for (int e = tid; e < D * D + D; e += nt) {
        float s = epart[e];
        if (e < D * D) {
          const int j = e / D, i = e % D;
          for (int pp = 0; pp < np; ++pp)
            s += acc[(2 * D + j) * IC + pt0 - i0 + pp * D + i];
        } else {
          for (int pp = 0; pp < np; ++pp)
            s += acc[3 * D * IC + pt0 - i0 + pp * D + e - D * D];
        }
        epart[e] = s;
      }
    }
    i0 = i1;
    __syncthreads();   // acc is zeroed for the next chunk
  }

  // dx over the cluster's blocks, every C-th entry per block, then rank 0
  // the cluster's ls2 / var sums
  float* dxo = a.dx + (l * N + t0) * D;
  const int n_dx = (t1 - t0) * D;
  if (C == 1) {
    __syncthreads();
    for (int e = tid; e < n_dx; e += nt) dxo[e] = dxp[e];
    for (int e = tid; e < D * D + D; e += nt) slab[off_ls2 + e] = epart[e];
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = rank + tid * C; e < n_dx; e += nt * C) {
    float s = 0.f;
    for (int q = 0; q < C; ++q) s += cluster.map_shared_rank(dxp, q)[e];
    dxo[e] = s;
  }
  if (rank == 0)
    for (int e = tid; e < D * D + D; e += nt) {
      float s = 0.f;
      for (int q = 0; q < C; ++q) s += cluster.map_shared_rank(epart, q)[e];
      slab[off_ls2 + e] = s;
    }
  cluster.sync();   // no block leaves while another reads its sums
}

// The finished cotangents from the slabs. Entries of a per-draw output (a
// sum over its draw's row tiles) get a thread each, in the first blocks;
// entries of a shared one (a sum over every draw's row tiles) a warp each,
// whose lanes split the terms and meet in a shuffle tree. Fixed order
// throughout.
__global__ void __launch_bounds__(dfc::kThreads)
    df_pathwise_bwd_finish(BwdArgs a) {
  const int L = a.L, nt = a.n_tiles;
  const long long P = a.P;
  long long n_thread = 0;
  for (int q = 0; q < kOut; ++q)
    if (a.per[q]) n_thread += L * a.n[q];
  const long long thread_blocks = (n_thread + blockDim.x - 1) / blockDim.x;
  if (blockIdx.x < thread_blocks) {
    long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n_thread) return;
    for (int q = 0; q < kOut; ++q) {
      if (!a.per[q]) continue;
      if (e >= L * a.n[q]) {
        e -= L * a.n[q];
        continue;
      }
      const long long l = e / a.n[q], j = e % a.n[q];
      const float* p = a.slab + l * nt * P + a.off[q] + j;
      float s = 0.f;
#pragma unroll 4
      for (int t = 0; t < nt; ++t) s += p[t * P];
      a.out[a.o_out[q] + e] = s;
      return;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  long long w = (blockIdx.x - thread_blocks) * (blockDim.x >> 5) +
                (threadIdx.x >> 5);
  for (int q = 0; q < kOut; ++q) {
    if (a.per[q]) continue;
    if (w >= a.n[q]) {
      w -= a.n[q];
      continue;
    }
    // term k: draw k / nt's row tile k % nt
    const long long terms = (long long)L * nt;
    float s = 0.f;
    for (long long k = lane; k < terms; k += 32)
      s += a.slab[k * P + a.off[q] + w];
    s = df::warp_sum(s);
    if (lane == 0) a.out[a.o_out[q] + w] = s;
    return;
  }
}

// The plan for these shapes on `device` (df_cluster.cuh walk_plan_for) and
// the items per chunk that a block's shared memory holds, in p and ic;
// cudaErrorInvalidValue for shapes the kernel does not take (D above 16,
// a block that cannot hold one point's items, a grid past its limit).
int plan_checked(int L, int N, int D, int SD, int M, int device,
                 dfc::Plan& p, int& ic) {
  if (L < 1 || N < 1 || D < 1 || D > df::kMaxD || SD < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  p = dfc::walk_plan_for(L, N, D, SD, M, sms);
  if (!dfc::plan_ok(D, p.R, p.C) || p.groups * p.C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long items = p.CB + (long long)p.MB * D;
  const long long fit =
      ((long long)optin / (long long)sizeof(float) -
       rest_floats(p.R, D, p.RT)) / (3 * D + 1);
  if (fit < D) return (int)cudaErrorInvalidValue;
  ic = (int)(items < fit ? items : fit);
  return 0;
}

template <int R, int DMAX>
int launch(const BwdArgs& a, const dfc::Plan& p, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((3LL * a.D + 1) * a.IC + rest_floats(R, a.D, a.RT));
  return (int)dfc::launch_clusters(df_pathwise_bwd_kernel<R, DMAX>, a,
                                   p.groups * p.C, p.C, smem, s);
}

}  // namespace

// Floats per (draw, row tile) slab of operand cotangents, for the wrapper
// to size the workspace (L, n_tiles, P).
extern "C" long long df_pathwise_bwd_slab_floats(int D, int SD, int M) {
  return slab_floats(D, SD, M);
}

// The launch's plan on `device`: out = {rows per pass, blocks per cluster,
// rows per tile, row tiles per draw, items per chunk}. Returns
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int df_pathwise_bwd_plan(int L, int N, int D, int SD, int M,
                                    int device, int* out) {
  dfc::Plan p;
  int ic = 0;
  const int err = plan_checked(L, N, D, SD, M, device, p, ic);
  if (err) return err;
  out[0] = p.R;
  out[1] = p.C;
  out[2] = p.RT;
  out[3] = p.n_tiles;
  out[4] = ic;
  return 0;
}

// Launches the VJP kernel and its summing kernel on `stream` and returns
// the CUDA error, or cudaErrorInvalidValue for shapes it does not take
// (see df_pathwise_bwd_plan). Operands as in df_pathwise_fwd; g and dx are
// (L, N, D); work holds L * n_tiles * P floats (P =
// df_pathwise_bwd_slab_floats); out receives, end to end, the cotangents
// of omf, phf, G, Z, nur, ls2 and var in their operands' shapes (summed
// over the draws for a shared operand). Every entry of dx and out is
// written.
extern "C" int df_pathwise_bwd(
    const float* x, long long x_ls, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* G, long long G_ls,
    const float* z, long long z_ls, const float* nur, long long nur_ls,
    const float* ls2, long long ls2_ls, const float* var, long long var_ls,
    const float* g, float* dx, float* work, float* out, int L, int N, int D,
    int SD, int M, int device, void* stream) {
  dfc::Plan p;
  int ic = 0;
  const int bad = plan_checked(L, N, D, SD, M, device, p, ic);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  BwdArgs a;
  a.x = x; a.omf = omf; a.phf = phf; a.G = G; a.z = z; a.nur = nur;
  a.ls2 = ls2; a.var = var;
  a.x_ls = x_ls; a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.G_ls = G_ls;
  a.z_ls = z_ls; a.nur_ls = nur_ls; a.ls2_ls = ls2_ls; a.var_ls = var_ls;
  a.g = g; a.dx = dx; a.slab = work; a.out = out;
  a.L = L; a.N = N; a.D = D; a.SD = SD; a.M = M;
  a.C = p.C; a.CB = p.CB; a.MB = p.MB; a.RT = p.RT; a.n_tiles = p.n_tiles;
  a.IC = ic;
  a.P = slab_floats(D, SD, M);
  const long long sizes[kOut] = {(long long)D * SD, SD, 2LL * SD * D,
                                 (long long)M * D, (long long)M * D,
                                 (long long)D * D, D};
  const long long strides[kOut] = {omf_ls, phf_ls, G_ls, z_ls,
                                   nur_ls, ls2_ls, var_ls};
  long long off = 0, at = 0, n_thread = 0, n_warp = 0;
  for (int q = 0; q < kOut; ++q) {
    a.n[q] = sizes[q];
    a.per[q] = strides[q] != 0;
    a.off[q] = off;
    a.o_out[q] = at;
    off += sizes[q];
    at += (a.per[q] ? L : 1) * sizes[q];
    if (a.per[q])
      n_thread += L * sizes[q];
    else
      n_warp += sizes[q];
  }

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (D <= 8)
    rc = p.R == 4   ? launch<4, 8>(a, p, s)
         : p.R == 2 ? launch<2, 8>(a, p, s)
                    : launch<1, 8>(a, p, s);
  else
    rc = p.R == 2 ? launch<2, 16>(a, p, s) : launch<1, 16>(a, p, s);
  if (rc) return rc;
  // a thread per entry of the per-draw outputs, a warp per entry of the
  // shared ones
  const long long blocks = (n_thread + dfc::kThreads - 1) / dfc::kThreads +
                           (n_warp + dfc::kWarps - 1) / dfc::kWarps;
  df_pathwise_bwd_finish<<<(unsigned)blocks, dfc::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
