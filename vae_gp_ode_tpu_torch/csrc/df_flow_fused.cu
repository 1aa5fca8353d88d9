// Whole euler trajectory of the divergence-free (DF) pathwise GP sample, one
// launch for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_make_fwd_kernel` of
// vae_gp_ode_tpu/ops/df_flow_fused.py (called through
// `packed_df_euler_flow`). It computes what `df_euler_flow_reference`
// computes, per draw l and batch row:
//
//   z_{t+1} = z_t + dts[t] f(z_t),   zs[l, 0] = z0,
//
// f the DF evaluation of df_pathwise_fwd.cu (df_common.cuh states it), on
// the same operands, each per draw (stride `*_ls`) or shared (stride 0).
// DF flows are first order only (D_in = D_out), as in the JAX package.
//
// Design (df_cluster.cuh states the split). The per-step eval #5, walked
// over the T-1 dependent steps inside one launch: one cluster of C blocks
// per (draw, tile of R rows), with #5's plan, whose blocks own their share
// of the feature columns and (point, output) items for the whole walk
// (their operands stay in the SM's L1 after the first step). Per step every
// thread adds its items' terms of f at the tile's state, the block sums
// them with warp shuffles, one cluster barrier, and every block adds the
// cluster's C partial sums in rank order through distributed shared
// memory (double-buffered, so one barrier a step) and applies the euler
// update to its own copy of the tile's state: all blocks add the same
// numbers in the same order, so the copies agree bit for bit. Rank 0
// writes zs[l, t+1]. No atomics; two launches give the same bits, and a
// step's f has the bits of #5 at the same state (the same plan and
// order). Any N, S and M is taken; D above 16 is refused.
//
// What bounds it on an H100. T-1 evaluations of ~95 kFLOP per row at the
// main shapes (D=6, S=256, M=100): 143 MFLOP at L=5, N=20, T=16, about 2 us
// at 67 TFLOP/s f32, above its bytes: bound by operations on paper. In
// practice by its T-1 dependent steps, each a thread's item chain
// (sincosf, or D expf), a block sum and a cluster barrier.
//
// The design it replaced: one 256-thread block per (draw, R rows) that
// walked all S*D columns and, one thread per inducing point, all R D^2
// pairs of each point, every step (25 blocks at L=5, N=20; 5 at L=1:
// ~220 us a launch at T=16 on an H100, PERF.md section 6).

#include "df_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

struct FlowArgs {
  const float* z0;   // (N, D) per draw at z0_ls (0 = shared)
  const float* omf;  // (D, SD)
  const float* phf;  // (1, SD)
  const float* G;    // (2SD, D)
  const float* z;    // (M, D)
  const float* nur;  // (M, D)
  const float* ls2;  // (D, D)
  const float* var;  // (D,)
  long long z0_ls, omf_ls, phf_ls, G_ls, z_ls, nur_ls, ls2_ls, var_ls;
  const float* dts;  // (T-1,)
  float* zs;         // (L, T, N, D)
  int N, D, SD, M, T, C, CB, MB, n_tiles;
};

// Floats of a block's dynamic shared memory: the tile's state, 1/ls2 |
// var, the warps' partials and the block's sums of f, double-buffered.
int smem_floats(int R, int D) {
  return R * D + D * D + D + dfc::kWarps * R * D + 2 * R * D;
}

template <int R, int DMAX>
__global__ void __launch_bounds__(dfc::kThreads, 2)
    df_flow_fused_fwd_kernel(FlowArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, N = a.N, C = a.C, T = a.T;
  const int RD = R * D;
  const int tid = threadIdx.x;
  const int rank = (int)(blockIdx.x % C);
  const long long group = blockIdx.x / C;
  const long long l = group / a.n_tiles;
  const int r0 = (int)(group % a.n_tiles) * R;
  float* zcur = smem;                    // R * D  the tile's state
  float* par = zcur + RD;                // D * D + D
  float* red = par + D * D + D;          // kWarps * R * D
  float* part = red + dfc::kWarps * RD;  // 2 * R * D: the block's sums
  const float* z0 = a.z0 + l * a.z0_ls;
  const df::Draw p = {a.omf + l * a.omf_ls, a.phf + l * a.phf_ls,
                      a.G + l * a.G_ls, a.z + l * a.z_ls,
                      a.nur + l * a.nur_ls};
  const dfc::Share sh = dfc::share_of(rank, a.CB, a.MB, a.SD, a.M);
  float* zs = a.zs + (l * T * N + r0) * D;

  // rows past N integrate zeros and are never written
  for (int i = tid; i < RD; i += blockDim.x) {
    const int n = r0 + i / D;
    const float v = n < N ? z0[(long long)n * D + i % D] : 0.f;
    zcur[i] = v;
    if (rank == 0 && n < N) zs[i] = v;
  }
  df::load_par(par, a.ls2 + l * a.ls2_ls, a.var + l * a.var_ls, D);
  __syncthreads();

  cg::cluster_group cluster = cg::this_cluster();
  for (int t = 0; t < T - 1; ++t) {
    const float dt = __ldg(a.dts + t);   // issued before the step's work
    float acc[R][DMAX];
    dfc::eval_items<R, DMAX>(p, zcur, par, D, a.SD, sh, C == 1, acc);
    float* mine = part + (t & 1) * RD;
    dfc::block_sums<R, DMAX>(acc, 0.f, D, RD, red, mine);
    if (C > 1)
      cluster.sync();
    else
      __syncthreads();
    if (tid < RD) {
      const float f = cl::cluster_sum(mine, C, tid);
      const float v = fmaf(dt, f, zcur[tid]);
      zcur[tid] = v;
      if (rank == 0 && r0 + tid / D < N)
        zs[(long long)(t + 1) * N * D + tid] = v;
    }
    __syncthreads();
  }
  if (C > 1) cluster.sync();   // no block leaves while another reads its sums
}

template <int R, int DMAX>
int launch(const FlowArgs& a, const dfc::Plan& p, cudaStream_t s) {
  return (int)dfc::launch_clusters(
      df_flow_fused_fwd_kernel<R, DMAX>, a, p.groups * p.C, p.C,
      sizeof(float) * (size_t)smem_floats(R, a.D), s);
}

}  // namespace

// Dynamic shared memory of one block at the largest rows per cluster for
// D: with the adjoint's need (df_flow_fused_bwd_smem_bytes), the pair's
// rule, decided before the forward.
extern "C" long long df_flow_fused_fwd_smem_bytes(int D) {
  return (long long)sizeof(float) * smem_floats(D <= 8 ? 4 : 2, D);
}

// Launches the trajectory kernel on `stream` and returns its CUDA error, or
// cudaErrorInvalidValue for shapes it does not take (D above 16, a grid
// past its limit). Operands are f32 and contiguous; each `*_ls` is the
// element stride between draws (0 for an operand that all draws share). zs
// is (L, T, N, D); every entry is written.
extern "C" int df_flow_fused_fwd(
    const float* z0, long long z0_ls, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* G, long long G_ls,
    const float* z, long long z_ls, const float* nur, long long nur_ls,
    const float* ls2, long long ls2_ls, const float* var, long long var_ls,
    const float* dts, float* zs, int L, int N, int D, int SD, int M, int T,
    int device, void* stream) {
  if (L < 1 || N < 1 || D < 1 || D > df::kMaxD || SD < 1 || M < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const dfc::Plan p = dfc::plan_for(L, N, D, SD, M, sms);
  if (!dfc::plan_ok(D, p.R, p.C) || p.groups * p.C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  FlowArgs a;
  a.z0 = z0; a.omf = omf; a.phf = phf; a.G = G; a.z = z; a.nur = nur;
  a.ls2 = ls2; a.var = var;
  a.z0_ls = z0_ls; a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.G_ls = G_ls;
  a.z_ls = z_ls; a.nur_ls = nur_ls; a.ls2_ls = ls2_ls; a.var_ls = var_ls;
  a.dts = dts; a.zs = zs;
  a.N = N; a.D = D; a.SD = SD; a.M = M; a.T = T;
  a.C = p.C; a.CB = p.CB; a.MB = p.MB; a.n_tiles = p.n_tiles;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 8) {
    if (p.R == 4) return launch<4, 8>(a, p, s);
    if (p.R == 2) return launch<2, 8>(a, p, s);
    return launch<1, 8>(a, p, s);
  }
  return p.R == 2 ? launch<2, 16>(a, p, s) : launch<1, 16>(a, p, s);
}
