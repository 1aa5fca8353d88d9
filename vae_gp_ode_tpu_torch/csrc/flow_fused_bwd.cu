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
//
// Design (flow_cluster.cuh states the split). One cluster of C blocks per
// (draw, tile of R rows); its blocks share out the feature and inducing
// columns for the whole walk, and a block keeps its columns' operands and
// cotangents in its own shared memory, [field][column], where no other
// block or thread touches them. Per step every thread adds its columns'
// terms for the R rows; the block sums the rows' dz terms and <g, f> (for
// order 2 with the chain term's part of the dts cotangent, added by rank
// 0) with warp shuffles, and the cluster adds its blocks' sums in rank
// order through distributed shared memory (double-buffered, so one
// cluster barrier a step); each block then holds the same new state
// cotangent g. The next step's z_t and zsbar rows are loaded into
// registers before the step's work; rows past N carry g = 0. At the end
// each block writes its columns' cotangents, and rank 0 the dts
// cotangents and z0bar, into the (draw, row tile) slab: blocks never write
// to the same address. A second kernel of the same launch sums the slabs
// over row tiles, and over draws for operands (and z0) that all draws
// share, in a fixed order, into the cotangents in their operands' shapes
// (cluster.cuh finish_slabs): no atomics and no PyTorch reductions; two
// launches give the same bits.
//
// Shared memory per block: 2 (2D + 2) floats per column and the rows'
// buffers; at the main shapes (D=K=6, S=256, M=100) in 4-block clusters of
// 2 rows (L=5, N=20) 534 columns, 60,472 bytes. The launcher takes more
// blocks per cluster where a block would not fit the device's opt-in
// limit, and refuses a shape only where a block of an 8-block cluster
// would not. flow_fused_bwd_smem_bytes exports the bound of the pair's
// rule (ops/flow_fused.py `pair_fits`): the shared memory of the design
// this one replaced, kept until a sweep of the pair against the per-step
// kernels moves it, which is never below the need of a block of 8.
//
// What bounds it on an H100. Per row and step the recompute and the VJP are
// about K*S*(6D+12) + K*M*(12D+16) = 126 kFLOP at the main shapes; a train
// step has L*N*(T-1) = 300 (L=1) or 1500 (L=5) row-steps, 38 / 190 MFLOP,
// about 0.6 / 2.8 us at 67 TFLOP/s f32. Bound in practice by its T-1
// dependent steps, each a thread's column chain (D FMAs a row, a sincos or
// exp, the cotangents' read-modify-writes), a block and a cluster sum.
//
// The design it replaced: one 512-thread block per (draw, 4 rows), 25
// blocks at the main shapes (5 at L=1), each thread reloading its columns'
// operands from global memory every step, with an 81 KB slab of
// cotangents in shared memory summed in PyTorch after the launch (~181 us
// a launch on an H100, PERF.md section 6).
//
// Accuracy. Accurate sincosf/expf, no fast-math; everything is f32, no TF32.

#include "flow_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

struct BwdArgs {
  const float* zs;     // (L, T, N, D) forward trajectory
  const float* zsbar;  // (L, T, N, D) its cotangent
  fc::Draw w;          // the packed operands, per draw at their strides
  long long omf_ls, phf_ls, ws_ls, zb_ls, zn_ls, il2_ls, nus_ls;
  const float* dts;    // (T-1,)
  float* z0w;          // (L, N, D) z0bar per draw (workspace)
  float* slab;         // (L, n_tiles, P) (workspace)
  float* out;          // the finished cotangents, end to end (finish)
  int L, N, D, K, S, M, T, order, C, CB, MB, n_tiles, IB;
  long long P;         // floats per slab
  // the finished cotangents (cluster.cuh layout_slabs): z0bar, omf, phf,
  // ws, Zb, zn, il2, nus, dts
  long long n[cl::kOut], off[cl::kOut], o_out[cl::kOut];
  int per[cl::kOut];
};

// Floats per (draw, row tile) slab: [omf (D, KS) | phf (KS) | ws (KS) |
// Zb (D, KM) | zn (KM) | il2 (D, KM) | nus (KM) | dts (T-1)].
long long slab_floats(int D, int K, int S, int M, int T) {
  const long long KS = (long long)K * S, KM = (long long)K * M;
  return D * KS + 2 * KS + 2 * D * KM + 2 * KM + (T - 1);
}

// The bound of the pair's rule: the shared memory one block of the
// design this kernel replaced took (512 threads, 4 rows, the whole slab),
// or a block of an 8-block cluster of this one where that were more.
long long rule_bytes(int D, int K, int S, int M, int T) {
  const long long RD = 4LL * D;
  const long long parent =
      sizeof(float) * (slab_floats(D, K, S, M, T) + 3 * RD + 16 * (RD + 1));
  cl::Plan p = {};
  p = cl::split(p, cl::kMaxCluster, K * S, K * M);
  const long long mine =
      sizeof(float) * fc::bwd_smem_floats(D <= 8 ? 4 : 2, D, p.CB + p.MB);
  return parent > mine ? parent : mine;
}

template <int R, int DMAX>
__global__ void __launch_bounds__(cl::kThreads, DMAX <= 8 ? 2 : 1)
    flow_fused_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, K = a.K, S = a.S, M = a.M, N = a.N, T = a.T, C = a.C;
  const int KS = K * S, KM = K * M;
  const int RD = R * D, V = RD + 1, IB = a.IB, F = fc::fields(D);
  const int off = a.order == 2 ? K : 0;   // the g entries f feeds
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rank = (int)(blockIdx.x % C);
  const long long group = blockIdx.x / C;
  const long long l = group / a.n_tiles;
  const int r0 = (int)(group % a.n_tiles) * R;
  const cl::Share sh = cl::share_of(rank, a.CB, a.MB, KS, KM);
  const int items = sh.items(1);
  float* acc = smem;                    // [2D + 2][IB] cotangents
  float* opd = acc + F * IB;            // [2D + 2][IB] operands
  float* g = opd + F * IB;              // RD  cotangent of z_{t+1}
  float* zt = g + RD;                   // RD  z_t
  float* zb = zt + RD;                  // RD  zsbar[t]
  float* red = zb + RD;                 // kWarps * V
  float* part = red + cl::kWarps * V;   // 2 * V  the block's sums
  const fc::Draw w = {a.w.omf + l * a.omf_ls, a.w.phf + l * a.phf_ls,
                      a.w.ws + l * a.ws_ls,   a.w.zb + l * a.zb_ls,
                      a.w.zn + l * a.zn_ls,   a.w.il2 + l * a.il2_ls,
                      a.w.nus + l * a.nus_ls};
  const float* zs = a.zs + l * T * N * D;
  const float* zsbar = a.zsbar + l * T * N * D;

  for (long long i = tid; i < (long long)F * IB; i += nt) acc[i] = 0.f;
  fc::load_items(opd, IB, w, sh, D, KS, KM);
  // rows past N carry g = 0 and z = 0 throughout: every contribution they
  // make is scaled by their g
  float nz = 0.f, nb = 0.f;   // this thread's entry of the next rows
  for (int i = tid; i < RD; i += nt) {
    const int n = r0 + i / D;
    const bool in = n < N;
    g[i] = in ? zsbar[((long long)(T - 1) * N + n) * D + i % D] : 0.f;
    zt[i] = in ? zs[((long long)(T - 2) * N + n) * D + i % D] : 0.f;
    zb[i] = in ? zsbar[((long long)(T - 2) * N + n) * D + i % D] : 0.f;
  }
  __syncthreads();
  float* slab = a.slab + group * a.P;
  const long long off_zb = (long long)D * KS + 2LL * KS;
  const long long off_il2 = off_zb + (long long)D * KM + KM;
  const long long off_dts = off_il2 + (long long)D * KM + KM;

  float dt = __ldg(a.dts + T - 2);
  for (int t = T - 2, step = 0; t >= 0; --t, ++step) {
    const float dt_next = t > 0 ? __ldg(a.dts + t - 1) : 0.f;
    if (t > 0 && tid < RD) {     // the rows of step t - 1, ahead
      const int n = r0 + tid / D;
      nz = n < N ? zs[((long long)(t - 1) * N + n) * D + tid % D] : 0.f;
      nb = n < N ? zsbar[((long long)(t - 1) * N + n) * D + tid % D] : 0.f;
    }
    // order 2: the chain term's g_{t+1}[:K] entry, read before g changes,
    // and rank 0 adds rhs[:K] = z_t[K:]'s part of the dts cotangent
    float gc = 0.f, fg = 0.f;
    if (off && tid < RD && tid % D >= K) gc = g[tid - K];
    if (off && rank == 0 && tid < R * K) {
      const int r = tid / K, k = tid % K;
      fg = g[r * D + k] * zt[r * D + K + k];
    }
    float dx[R][DMAX];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d < DMAX; ++d) dx[r][d] = 0.f;

    for (int it = tid; it < items; it += nt) {
      if (it < sh.cn) {
        // prior term: phi = cos(z . omf + phf) * ws over feature column c
        const int k = (sh.c0 + it) / S;
        float o[DMAX], ob[DMAX];
#pragma unroll
        for (int d = 0; d < DMAX; ++d) {
          o[d] = d < D ? opd[d * IB + it] : 0.f;
          ob[d] = 0.f;
        }
        const float ph = opd[D * IB + it];
        const float wv = opd[(D + 1) * IB + it];
        float pb = 0.f, wb = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float xo = 0.f;
#pragma unroll
          for (int d = 0; d < DMAX; ++d)
            if (d < D) xo = fmaf(zt[r * D + d], o[d], xo);
          float sn, cs;
          sincosf(xo + ph, &sn, &cs);
          const float gf = g[r * D + off + k];
          fg = fmaf(gf, cs * wv, fg);
          const float fb = dt * gf;
          wb = fmaf(cs, fb, wb);
          const float xb = -sn * wv * fb;
          pb += xb;
#pragma unroll
          for (int d = 0; d < DMAX; ++d)
            if (d < D) {
              ob[d] = fmaf(zt[r * D + d], xb, ob[d]);
              dx[r][d] = fmaf(xb, o[d], dx[r][d]);
            }
        }
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) acc[d * IB + it] += ob[d];
        acc[D * IB + it] += pb;
        acc[(D + 1) * IB + it] += wb;
      } else {
        // update term: exp(-0.5 (xn + zn - 2 cross)) * nus, inducing
        // column m
        const int k = (sh.m0 + it - sh.cn) / M;
        float b[DMAX], il[DMAX], bb[DMAX], ib[DMAX];
#pragma unroll
        for (int d = 0; d < DMAX; ++d) {
          b[d] = d < D ? opd[d * IB + it] : 0.f;
          il[d] = d < D ? opd[(D + d) * IB + it] : 0.f;
          bb[d] = ib[d] = 0.f;
        }
        const float znc = opd[2 * D * IB + it];
        const float nuc = opd[(2 * D + 1) * IB + it];
        float znb = 0.f, nub = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
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
          fg = fmaf(gf, kx * nuc, fg);
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
              dx[r][d] += 2.f * zv * sq * il[d] - 2.f * sq * b[d];
            }
        }
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) {
            acc[d * IB + it] += bb[d];
            acc[(D + d) * IB + it] += ib[d];
          }
        acc[2 * D * IB + it] += znb;
        acc[(2 * D + 1) * IB + it] += nub;
      }
    }

    // the rows' dz terms and <g, f> over the block, then over the cluster
    float* mine = part + (step & 1) * V;
    cl::block_sums<R, DMAX>(dx, fg, D, V, red, mine);
    if (C > 1) cg::this_cluster().sync();
    if (tid < V) {
      const float s = cl::cluster_sum(mine, C, tid);
      if (tid < RD) {
        g[tid] = fmaf(dt, gc, zb[tid] + g[tid] + s);
        zt[tid] = nz;
        zb[tid] = nb;
      } else if (rank == 0) {
        slab[off_dts + t] = s;
      }
    }
    __syncthreads();
    dt = dt_next;
  }

  // the block's columns
  for (int it = tid; it < items; it += nt) {
    if (it < sh.cn) {
      const int c = sh.c0 + it;
      for (int d = 0; d < D; ++d)
        slab[(long long)d * KS + c] = acc[d * IB + it];
      slab[(long long)D * KS + c] = acc[D * IB + it];
      slab[(long long)D * KS + KS + c] = acc[(D + 1) * IB + it];
    } else {
      const int m = sh.m0 + it - sh.cn;
      for (int d = 0; d < D; ++d) {
        slab[off_zb + (long long)d * KM + m] = acc[d * IB + it];
        slab[off_il2 + (long long)d * KM + m] = acc[(D + d) * IB + it];
      }
      slab[off_zb + (long long)D * KM + m] = acc[2 * D * IB + it];
      slab[off_il2 + (long long)D * KM + m] = acc[(2 * D + 1) * IB + it];
    }
  }
  if (rank == 0)
    for (int i = tid; i < RD; i += nt) {
      const int n = r0 + i / D;
      if (n < N) a.z0w[(l * N + n) * D + i % D] = g[i];
    }
  if (C > 1) cg::this_cluster().sync();   // no block leaves while another
                                          // reads its sums
}

// The finished cotangents from the slabs (cluster.cuh finish_slabs).
__global__ void __launch_bounds__(cl::kThreads)
    flow_fused_bwd_finish(BwdArgs a) {
  cl::finish_slabs(a);
}

template <int R, int DMAX>
int launch(const BwdArgs& a, const cl::Plan& p, cudaStream_t s) {
  const size_t smem = sizeof(float) * fc::bwd_smem_floats(R, a.D, a.IB);
  return (int)cl::launch_clusters(flow_fused_bwd_kernel<R, DMAX>, a,
                                  p.groups * p.C, p.C, smem, s);
}

}  // namespace

// Floats per (draw, row tile) slab of parameter cotangents, for the
// wrapper to size the workspace.
extern "C" long long flow_fused_bwd_slab_floats(int D, int K, int S, int M,
                                                int T) {
  return slab_floats(D, K, S, M, T);
}

// The launch's plan on `device` (flow_cluster.cuh): out = {rows per
// cluster, blocks per cluster, row tiles per draw}. The workspace is
// L*N*D + L*tiles*P floats (P = flow_fused_bwd_slab_floats). Returns
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int flow_fused_bwd_plan(int L, int N, int D, int K, int S, int M,
                                   int order, int device, int* out) {
  cl::Plan p;
  const int err = fc::plan_on(device, L, N, D, K, S, M, order, p);
  if (err) return err;
  out[0] = p.R;
  out[1] = p.C;
  out[2] = p.n_tiles;
  return 0;
}

// The bound of the pair's rule at these shapes (rule_bytes): the pair
// takes a flow where it fits the device's opt-in shared memory per block,
// so a caller can decide before the forward whether the pair will run.
extern "C" long long flow_fused_bwd_smem_bytes(int D, int K, int S, int M,
                                               int T) {
  return rule_bytes(D, K, S, M, T);
}

// The device's opt-in shared memory per block, or -1 if it cannot be read.
extern "C" int flow_fused_bwd_smem_optin(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin;
}

// Launches the adjoint kernel and its summing kernel on `stream` and
// returns the CUDA error, or cudaErrorInvalidValue for shapes it does not
// take (flow_fused_bwd_plan). Operands are f32 and contiguous; each `*_ls`
// is the element stride between draws (0 for an operand that all draws
// share). zs and zsbar are (L, T, N, D); work holds L*N*D + L*tiles*P
// floats; out receives, end to end, z0bar ((N, D) summed over the draws if
// z0_shared, else (L, N, D)), the cotangents of omf, phf, ws, Zb, zn, il2
// and nus in their operands' shapes (summed over the draws for a shared
// operand) and dts's (T-1); every entry is written.
extern "C" int flow_fused_bwd(
    const float* zs, const float* zsbar, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* ws, long long ws_ls,
    const float* zb, long long zb_ls, const float* zn, long long zn_ls,
    const float* il2, long long il2_ls, const float* nus, long long nus_ls,
    const float* dts, float* work, float* out, int L, int N, int D, int K,
    int S, int M, int T, int order, int z0_shared, int device,
    void* stream) {
  if (T < 2) return (int)cudaErrorInvalidValue;
  cl::Plan p;
  const int bad = fc::plan_on(device, L, N, D, K, S, M, order, p);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  BwdArgs a;
  a.zs = zs; a.zsbar = zsbar;
  a.w = {omf, phf, ws, zb, zn, il2, nus};
  a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.ws_ls = ws_ls; a.zb_ls = zb_ls;
  a.zn_ls = zn_ls; a.il2_ls = il2_ls; a.nus_ls = nus_ls;
  a.dts = dts; a.z0w = work; a.slab = work + (long long)L * N * D;
  a.out = out;
  a.L = L; a.N = N; a.D = D; a.K = K; a.S = S; a.M = M; a.T = T;
  a.order = order;
  a.C = p.C; a.CB = p.CB; a.MB = p.MB; a.n_tiles = p.n_tiles;
  a.IB = p.CB + p.MB;
  a.P = slab_floats(D, K, S, M, T);
  const long long KS = (long long)K * S, KM = (long long)K * M;
  const long long sizes[cl::kOut] = {(long long)N * D, D * KS, KS, KS,
                                     D * KM, KM, D * KM, KM, T - 1};
  // with one draw, a shared output is a per-draw one: a thread per entry
  // sums its row tiles
  const int one = L == 1;
  const int per[cl::kOut] = {!z0_shared || one, omf_ls != 0 || one,
                             phf_ls != 0 || one, ws_ls != 0 || one,
                             zb_ls != 0 || one,  zn_ls != 0 || one,
                             il2_ls != 0 || one, nus_ls != 0 || one, 0};
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
  flow_fused_bwd_finish<<<(unsigned)blocks, cl::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
