// Whole euler trajectory of the dimwise-RBF pathwise GP sample, one launch
// for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_make_kernel` of vae_gp_ode_tpu/ops/flow_fused.py;
// its discrete adjoint `_make_bwd_kernel` is flow_fused_bwd.cu. It computes
// what `packed_flow_reference` computes on the packed operands of
// `_pack_operands`, per draw l and batch row n:
//
//   f_k(z) = sum_s cos(z . omf[:, kS+s] + phf[kS+s]) ws[kS+s]
//          + sum_m exp(-0.5 ((z*z) . il2[:, kM+m] + zn[kM+m]
//                             - 2 z . Zb[:, kM+m])) nus[kM+m]
//   rhs(z) = f(z)                 (order 1)
//   rhs(z) = [z[K:], f(z)]        (order 2, z = (s, v), D = 2K)
//   z_{t+1} = z_t + dts[t] rhs(z_t),   zs[l, 0] = z0
//
// The TPU kernel does the per-k block sums as matmuls against 0/1 block-
// indicator matrices so that the MXU can do them; here they are sums over
// the threads of a cluster.
//
// Design (flow_cluster.cuh states the split). One cluster of C blocks per
// (draw, tile of R rows), with the adjoint's plan; its blocks own their
// share of the feature and inducing columns and keep the columns'
// operands in shared memory for the whole walk. Per step every thread adds
// its columns' terms of f at the tile's state into its (row, output dim)
// sums, the block sums them with warp shuffles, one cluster barrier, and
// every block adds the cluster's C partial sums in rank order through
// distributed shared memory (double-buffered, so one barrier a step) and
// applies the euler update to its own copy of the tile's state: all blocks
// add the same numbers in the same order, so the copies agree bit for bit.
// Rank 0 writes zs[l, t+1]. No atomics; two launches give the same bits.
// Any N, S and M is taken, D up to 16 where the adjoint's block of an
// 8-block cluster fits the opt-in shared memory (the pair's rule,
// ops/flow_fused.py `pair_fits`, sends other shapes to the solvers).
//
// What bounds it on an H100. Per row and step f is ~43 kFLOP at the main
// shapes (L=5, N=20, D=K=6, S=256, M=100, T=16): 65 MFLOP a launch, about
// a microsecond at 67 TFLOP/s f32, above its ~0.3 MB of bytes. In practice
// it is bound by its T-1 dependent steps, each a thread's column chain
// (D FMAs a row and a cos or exp), a block sum and a cluster barrier.
//
// The design it replaced: one block of 12 warps per (draw, 4 rows), each
// warp an (output dim, column part) item that reloaded its columns'
// operands from global memory every step (25 blocks at L=5, N=20; ~80 us
// a launch at T=16 on an H100, PERF.md section 6).
//
// Accuracy. Accurate cosf/expf, no fast-math: the arguments z . omega can
// be large, where __cosf loses accuracy. Everything is f32, no TF32.

#include "flow_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

struct FlowArgs {
  const float* z0;   // (N, D)         per draw at z0_ls (0 = shared)
  fc::Draw w;        // the packed operands, per draw at their strides
  long long z0_ls, omf_ls, phf_ls, ws_ls, zb_ls, zn_ls, il2_ls, nus_ls;
  const float* dts;  // (T-1,)
  float* zs;         // (L, T, N, D)
  int N, D, K, S, M, T, order, C, CB, MB, n_tiles, IB;
};

template <int R, int DMAX>
__global__ void __launch_bounds__(cl::kThreads, 2)
    flow_fused_fwd_kernel(FlowArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, K = a.K, S = a.S, M = a.M, N = a.N, T = a.T, C = a.C;
  const int RD = R * D, RK = R * K, IB = a.IB;
  const int off = a.order == 2 ? K : 0;   // the state entries f feeds
  const int tid = threadIdx.x;
  const int rank = (int)(blockIdx.x % C);
  const long long group = blockIdx.x / C;
  const long long l = group / a.n_tiles;
  const int r0 = (int)(group % a.n_tiles) * R;
  const cl::Share sh = cl::share_of(rank, a.CB, a.MB, K * S, K * M);
  const int items = sh.items(1);
  float* opd = smem;                       // [2D + 2][IB] operands
  float* zcur = opd + fc::fields(D) * IB;  // R * D  the tile's state
  float* red = zcur + RD;                  // kWarps * R * K
  float* part = red + cl::kWarps * RK;     // 2 * R * K: the block's sums
  const fc::Draw w = {a.w.omf + l * a.omf_ls, a.w.phf + l * a.phf_ls,
                      a.w.ws + l * a.ws_ls,   a.w.zb + l * a.zb_ls,
                      a.w.zn + l * a.zn_ls,   a.w.il2 + l * a.il2_ls,
                      a.w.nus + l * a.nus_ls};
  const float* z0 = a.z0 + l * a.z0_ls;
  float* zs = a.zs + (l * T * N + r0) * D;

  fc::load_items(opd, IB, w, sh, D, K * S, K * M);
  // rows past N integrate zeros and are never written
  for (int i = tid; i < RD; i += blockDim.x) {
    const int n = r0 + i / D;
    const float v = n < N ? z0[(long long)n * D + i % D] : 0.f;
    zcur[i] = v;
    if (rank == 0 && n < N) zs[i] = v;
  }
  __syncthreads();

  cg::cluster_group cluster = cg::this_cluster();
  float dt = T > 1 ? __ldg(a.dts) : 0.f;
  for (int t = 0; t < T - 1; ++t) {
    // the next step's size, ahead; the tile's state in registers
    const float dt_next = t + 2 < T ? __ldg(a.dts + t + 1) : 0.f;
    float zr[R][DMAX], acc[R][DMAX];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d < DMAX; ++d) {
        zr[r][d] = d < D ? zcur[r * D + d] : 0.f;
        acc[r][d] = 0.f;
      }
    for (int it = tid; it < items; it += blockDim.x) {
      float v[R];
      int k;
      if (it < sh.cn) {
        // prior term: cos(z . omf[:, c] + phf[c]) ws[c]
        k = (sh.c0 + it) / S;
        float o[DMAX];
#pragma unroll
        for (int d = 0; d < DMAX; ++d) o[d] = d < D ? opd[d * IB + it] : 0.f;
        const float ph = opd[D * IB + it];
        const float wv = opd[(D + 1) * IB + it];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float xo = 0.f;
#pragma unroll
          for (int d = 0; d < DMAX; ++d)
            if (d < D) xo = fmaf(zr[r][d], o[d], xo);
          v[r] = cosf(xo + ph) * wv;
        }
      } else {
        // update term: exp(-0.5 scaled sqdist(z, Z_m)) nus[m]
        k = (sh.m0 + it - sh.cn) / M;
        float b[DMAX], il[DMAX];
#pragma unroll
        for (int d = 0; d < DMAX; ++d) {
          b[d] = d < D ? opd[d * IB + it] : 0.f;
          il[d] = d < D ? opd[(D + d) * IB + it] : 0.f;
        }
        const float znc = opd[2 * D * IB + it];
        const float nuc = opd[(2 * D + 1) * IB + it];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float cr = 0.f, xn = 0.f;
#pragma unroll
          for (int d = 0; d < DMAX; ++d)
            if (d < D) {
              cr = fmaf(zr[r][d], b[d], cr);
              xn = fmaf(zr[r][d] * zr[r][d], il[d], xn);
            }
          v[r] = expf(-0.5f * (xn + znc - 2.f * cr)) * nuc;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int kk = 0; kk < DMAX; ++kk)
          if (kk == k) acc[r][kk] += v[r];
    }
    float* mine = part + (t & 1) * RK;
    cl::block_sums<R, DMAX>(acc, 0.f, K, RK, red, mine);
    if (C > 1)
      cluster.sync();
    else
      __syncthreads();
    if (tid < RK) {
      const float f = cl::cluster_sum(mine, C, tid);
      const int r = tid / K, k = tid % K;
      const int i = r * D + off + k;
      const bool in = r0 + r < N;
      if (off) {   // order 2: s_{t+1} = s_t + dt v_t
        const float s = fmaf(dt, zcur[i], zcur[r * D + k]);
        zcur[r * D + k] = s;
        if (rank == 0 && in) zs[(long long)(t + 1) * N * D + r * D + k] = s;
      }
      const float vn = fmaf(dt, f, zcur[i]);
      zcur[i] = vn;
      if (rank == 0 && in) zs[(long long)(t + 1) * N * D + i] = vn;
    }
    __syncthreads();
    dt = dt_next;
  }
  if (C > 1) cluster.sync();   // no block leaves while another reads its sums
}

template <int R, int DMAX>
int launch(const FlowArgs& a, const cl::Plan& p, cudaStream_t s) {
  return (int)cl::launch_clusters(
      flow_fused_fwd_kernel<R, DMAX>, a, p.groups * p.C, p.C,
      sizeof(float) * (size_t)fc::fwd_smem_floats(R, a.D, a.K, a.IB), s);
}

}  // namespace

// The launch's plan on `device` (flow_cluster.cuh, the adjoint's):
// out = {rows per cluster, blocks per cluster, row tiles per draw}.
// Returns cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int flow_fused_fwd_plan(int L, int N, int D, int K, int S, int M,
                                   int order, int device, int* out) {
  cl::Plan p;
  const int err = fc::plan_on(device, L, N, D, K, S, M, order, p);
  if (err) return err;
  out[0] = p.R;
  out[1] = p.C;
  out[2] = p.n_tiles;
  return 0;
}

// Launches the trajectory kernel on `stream` and returns its CUDA error, or
// cudaErrorInvalidValue for shapes it does not take (flow_fused_fwd_plan).
// Operands are f32 and contiguous; each `*_ls` is the element stride
// between draws (0 for an operand that all draws share). zs is (L, T, N,
// D); every entry is written.
extern "C" int flow_fused_fwd(
    const float* z0, long long z0_ls, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* ws, long long ws_ls,
    const float* zb, long long zb_ls, const float* zn, long long zn_ls,
    const float* il2, long long il2_ls, const float* nus, long long nus_ls,
    const float* dts, float* zs, int L, int N, int D, int K, int S, int M,
    int T, int order, int device, void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  cl::Plan p;
  const int bad = fc::plan_on(device, L, N, D, K, S, M, order, p);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  FlowArgs a;
  a.z0 = z0;
  a.w = {omf, phf, ws, zb, zn, il2, nus};
  a.z0_ls = z0_ls; a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.ws_ls = ws_ls;
  a.zb_ls = zb_ls; a.zn_ls = zn_ls; a.il2_ls = il2_ls; a.nus_ls = nus_ls;
  a.dts = dts; a.zs = zs;
  a.N = N; a.D = D; a.K = K; a.S = S; a.M = M; a.T = T; a.order = order;
  a.C = p.C; a.CB = p.CB; a.MB = p.MB; a.n_tiles = p.n_tiles;
  a.IB = p.CB + p.MB;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 8) {
    if (p.R == 4) return launch<4, 8>(a, p, s);
    if (p.R == 2) return launch<2, 8>(a, p, s);
    return launch<1, 8>(a, p, s);
  }
  return p.R == 2 ? launch<2, 16>(a, p, s) : launch<1, 16>(a, p, s);
}
