// Per-step pathwise evaluation of the divergence-free (DF) GP sample, one
// launch for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_make_fwd_kernel` of
// vae_gp_ode_tpu/ops/df_pathwise.py (`_df_eval_body`, `_df_update_body`),
// called through `fused_df_pathwise_eval`. It computes what
// `df_pathwise_reference` computes (df_common.cuh states the function) on
// x (N, D), omf (D, SD), phf (1, SD), G (2SD, D), Z (M, D), nur (M, D),
// ls2 (D, D) and var (D,), each either per draw (element stride `*_ls`
// between draws) or shared by all draws (stride 0). Output (L, N, D).
//
// What bounds it on an H100. Per row it does about SD(2D + 3) trig-and-FMA
// operations for the prior and M D^2 ~ 12 for the update: at the main
// shapes (D=6, S=256, M=100) ~95 kFLOP, 9.5 MFLOP for L*N = 100 rows
// (0.14 us at 67 TFLOP/s f32), on ~0.55 MB of per-draw omf and G at L=5
// (0.17 us at 3.35 TB/s): bound by bytes on paper, and in practice by
// latency: a launch, a round trip to memory, the chain of sincosf/expf
// and FMAs of a thread's items, and the sums over the block and cluster.
//
// Design (df_cluster.cuh states the split). One cluster of C blocks per
// (draw, tile of R rows); its blocks share out the feature columns and the
// inducing points, each point as D (point, output) items, so at the main
// shapes (L=5, N=20: 50 clusters of 4 blocks) a thread does two or three
// columns or (point, output) items for the tile's 2 rows. Where the row
// tiles alone fill the card (L=1, N=600) a cluster is one block, which
// takes each point whole (`whole_points`): the design it replaced, but
// for the items' order; the (point, output) split there took 21.3-21.4
// us a launch against 20.3-20.4 at (1, 600, 6, 1536) and 21.2-21.3
// against 19.5-19.8 at (5, 160, 6, 1536) on an H100 (PERF.md section
// 6). The rows, 1/ls2 and var are in shared memory; a thread's
// per-(row, output) partials stay in registers, the block sums them with
// warp shuffles, and the cluster adds its blocks' sums in rank order
// through distributed shared memory, each block finishing every C-th
// output: the others store their sums into its shared memory before the
// one cluster barrier. Any N, S and M is taken; D above 16 is refused.
//
// The design it replaced: one 256-thread block per (draw, R rows) that
// walked all S*D columns and, one thread per inducing point, all R D^2
// pairs of each point (25 blocks at the main shapes, 18.6 us a launch).
//
// Accuracy: accurate sincosf/expf, no fast-math; everything is f32.

#include "df_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

struct FwdArgs {
  const float* x;    // (N, D)
  const float* omf;  // (D, SD)
  const float* phf;  // (1, SD)
  const float* G;    // (2SD, D)
  const float* z;    // (M, D)
  const float* nur;  // (M, D)
  const float* ls2;  // (D, D)
  const float* var;  // (D,)
  long long x_ls, omf_ls, phf_ls, G_ls, z_ls, nur_ls, ls2_ls, var_ls;
  float* out;        // (L, N, D)
  int N, D, SD, M, C, CB, MB, n_tiles;
};

// Floats of a block's dynamic shared memory: the rows, 1/ls2 | var, the
// warps' partials, the block's sums and the cluster's sums of the outputs
// it finishes.
int smem_floats(int R, int D) {
  return R * D + D * D + D + dfc::kWarps * R * D + R * D +
         dfc::kMaxCluster * R * D;
}

template <int R, int DMAX>
__global__ void __launch_bounds__(dfc::kThreads, 2)
    df_pathwise_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, N = a.N, C = a.C;
  const int RD = R * D;
  const int rank = (int)(blockIdx.x % C);
  const long long group = blockIdx.x / C;
  const long long l = group / a.n_tiles;
  const int r0 = (int)(group % a.n_tiles) * R;
  float* xs = smem;                      // R * D
  float* par = xs + RD;                  // D * D + D
  float* red = par + D * D + D;          // kWarps * R * D
  float* part = red + dfc::kWarps * RD;  // R * D: the block's sums
  float* gather = part + RD;             // [rank][R * D]: the cluster's
  const float* x = a.x + l * a.x_ls;
  const df::Draw p = {a.omf + l * a.omf_ls, a.phf + l * a.phf_ls,
                      a.G + l * a.G_ls, a.z + l * a.z_ls,
                      a.nur + l * a.nur_ls};
  const dfc::Share sh = dfc::share_of(rank, a.CB, a.MB, a.SD, a.M);

  // rows past N evaluate zeros and are never written
  for (int i = threadIdx.x; i < RD; i += blockDim.x) {
    const int n = r0 + i / D;
    xs[i] = n < N ? x[(long long)n * D + i % D] : 0.f;
  }
  df::load_par(par, a.ls2 + l * a.ls2_ls, a.var + l * a.var_ls, D);
  __syncthreads();

  float acc[R][DMAX];
  dfc::eval_items<R, DMAX>(p, xs, par, D, a.SD, sh, C == 1, acc);
  dfc::block_sums<R, DMAX>(acc, 0.f, D, RD, red, part);
  float* out = a.out + (l * N + r0) * D;
  if (C == 1) {
    for (int t = threadIdx.x; t < RD; t += blockDim.x)
      if (r0 + t / D < N) out[t] = part[t];
    return;
  }
  // block `rank` finishes every C-th output: every block stores its sum
  // of output o into the shared memory of block o % C, one cluster
  // barrier, then the finishing block adds them in rank order (no block
  // touches another's shared memory after the barrier, so none waits for
  // the others to leave)
  cg::cluster_group cluster = cg::this_cluster();
  for (int t = threadIdx.x; t < RD; t += blockDim.x)
    cluster.map_shared_rank(gather, t % C)[rank * RD + t] = part[t];
  cluster.sync();
  for (int o = rank + (int)threadIdx.x * C; o < RD; o += blockDim.x * C) {
    float t = 0.f;
    for (int q = 0; q < C; ++q) t += gather[q * RD + o];
    if (r0 + o / D < N) out[o] = t;
  }
}

template <int R, int DMAX>
int launch(const FwdArgs& a, const dfc::Plan& p, cudaStream_t s) {
  return (int)dfc::launch_clusters(
      df_pathwise_fwd_kernel<R, DMAX>, a, p.groups * p.C, p.C,
      sizeof(float) * (size_t)smem_floats(R, a.D), s);
}

// The plan for these shapes on `device`, in p; cudaErrorInvalidValue for
// shapes the kernel does not take.
int plan_checked(int L, int N, int D, int SD, int M, int device,
                 dfc::Plan& p) {
  if (L < 1 || N < 1 || D < 1 || D > df::kMaxD || SD < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  p = dfc::plan_for(L, N, D, SD, M, sms);
  if (!dfc::plan_ok(D, p.R, p.C) || p.groups * p.C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// The launch's plan for these shapes on `device`: out = {rows per
// cluster, blocks per cluster}. Returns cudaErrorInvalidValue for shapes
// the kernel does not take.
extern "C" int df_pathwise_fwd_plan(int L, int N, int D, int SD, int M,
                                    int device, int* out) {
  dfc::Plan p;
  const int err = plan_checked(L, N, D, SD, M, device, p);
  if (err) return err;
  out[0] = p.R;
  out[1] = p.C;
  return 0;
}

// Launches the per-step eval on `stream` and returns its CUDA error, or
// cudaErrorInvalidValue for shapes it does not take (D above 16, a grid
// past its limit). Operands are f32 and contiguous; each `*_ls` is the
// element stride between draws (0 for an operand that all draws share).
// out is (L, N, D); every entry is written.
extern "C" int df_pathwise_fwd(
    const float* x, long long x_ls, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* G, long long G_ls,
    const float* z, long long z_ls, const float* nur, long long nur_ls,
    const float* ls2, long long ls2_ls, const float* var, long long var_ls,
    float* out, int L, int N, int D, int SD, int M, int device,
    void* stream) {
  dfc::Plan p;
  const int bad = plan_checked(L, N, D, SD, M, device, p);
  if (bad) return bad;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  FwdArgs a;
  a.x = x; a.omf = omf; a.phf = phf; a.G = G; a.z = z; a.nur = nur;
  a.ls2 = ls2; a.var = var;
  a.x_ls = x_ls; a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.G_ls = G_ls;
  a.z_ls = z_ls; a.nur_ls = nur_ls; a.ls2_ls = ls2_ls; a.var_ls = var_ls;
  a.out = out;
  a.N = N; a.D = D; a.SD = SD; a.M = M;
  a.C = p.C; a.CB = p.CB; a.MB = p.MB; a.n_tiles = p.n_tiles;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 8) {
    if (p.R == 4) return launch<4, 8>(a, p, s);
    if (p.R == 2) return launch<2, 8>(a, p, s);
    return launch<1, 8>(a, p, s);
  }
  return p.R == 2 ? launch<2, 16>(a, p, s) : launch<1, 16>(a, p, s);
}
