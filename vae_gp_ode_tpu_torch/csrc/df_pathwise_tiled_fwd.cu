// Grid-tiled per-step pathwise evaluation of the divergence-free (DF) GP
// sample for wide shapes (state dim D up to 16, many features), one launch
// for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_fwd_kernel` of
// vae_gp_ode_tpu/ops/df_pathwise_tiled.py. It computes the same function as
// df_pathwise_fwd.cu (`df_pathwise_reference`; df_common.cuh states it),
// with the DF kernel's quirks kept as df_common.cuh keeps them: unscaled
// squared distances, the full (D, D) ls2 with the 1/(2 ls2[j, i])
// envelope, the ((D - 1) - r2 / ls2) diagonal term and nu points-major.
// Operand layouts and draw strides are those of df_pathwise_fwd.cu.
//
// Design. The grid is (slot, row tile, draw * D): one block per output
// column i, kRows batch rows and slot. Slots 0 .. n_chunks-1 are chunks of
// kChunk ORFF feature columns c: the block sums cos(u_c) G[c, i] +
// sin(u_c) G[SD + c, i] over its chunk, u_c = x . omf[:, c] + phf[c].
// Slot n_chunks is the matrix-valued update of column i: its O(D) j-loop
// over the inducing points, as the TPU kernel's per-i update
// (`df_pathwise_tiled.py:70-90`). On the TPU column i accumulated across
// consecutive grid steps; here each block writes its partial sum to its own
// entry of a slab part (L, n_slots, N, D) and the wrapper sums the slots.
// No atomics. Each thread owns kChunk / kThreads columns (or inducing
// points) with kRows per-row accumulators in registers, reduced over the
// block with warp shuffles. Any N, S and M is taken; D above 16 is refused
// (df_common.cuh kMaxD).
//
// What bounds it on an H100. At the wide shapes (L=5, N=20, D=12, S=1024,
// so SD = 12288, M=100) one launch reads ~9 MB of per-draw omf and G and
// does ~110 MFLOP: ~2.7 us of memory time, bound by bytes. Splitting the
// columns i over blocks recomputes x . omf and sincosf once per i (D times
// the trig of df_pathwise_fwd.cu), which is the TPU kernel's decomposition
// and keeps each block's update at O(D) pairs; the grid has L * D *
// ceil(N / kRows) * (ceil(SD / kChunk) + 1) blocks (2340 there). wgmma,
// TMA and sharing the trig between columns are later work.
//
// Accuracy. Accurate sincosf/expf, no fast-math; everything is f32.

#include "df_common.cuh"

namespace {

constexpr int kRows = 8;        // batch rows per block
constexpr int kChunk = 1024;    // ORFF feature columns per chunk slot
constexpr int kMaxD = df::kMaxD;

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
  float* part;       // (L, n_slots, N, D)
  int N, D, SD, M, n_chunks;
};

__global__ void __launch_bounds__(df::kThreads)
    df_pathwise_tiled_fwd_kernel(FwdArgs a) {
  __shared__ float xs[kRows * kMaxD];
  __shared__ float inv[kMaxD + 1];        // 1 / ls2[j, i] over j, then var_i
  __shared__ float red[df::kWarps][kRows];
  const int D = a.D, N = a.N, SD = a.SD, M = a.M;
  const int slot = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int i = blockIdx.z % D;
  const long long l = blockIdx.z / D;
  const int n_slots = a.n_chunks + 1;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* x = a.x + l * a.x_ls;
  const float* omf = a.omf + l * a.omf_ls;
  const float* phf = a.phf + l * a.phf_ls;
  const float* G = a.G + l * a.G_ls;
  const float* z = a.z + l * a.z_ls;
  const float* nur = a.nur + l * a.nur_ls;
  const float* ls2 = a.ls2 + l * a.ls2_ls;

  // rows past N evaluate zeros and are never written
  for (int t = tid; t < kRows * D; t += nt) {
    const int n = r0 + t / D;
    xs[t] = n < N ? x[(long long)n * D + t % D] : 0.f;
  }
  for (int j = tid; j <= D; j += nt)
    inv[j] = j < D ? 1.f / ls2[j * D + i] : a.var[l * a.var_ls + i];
  __syncthreads();

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  if (slot < a.n_chunks) {
    // ORFF prior of column i over this chunk's feature columns
    const int c1 = min(SD, (slot + 1) * kChunk);
    for (int c = slot * kChunk + tid; c < c1; c += nt) {
      float u[kRows];
      const float ph = __ldg(phf + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) u[r] = ph;
      for (int d = 0; d < D; ++d) {
        const float o = __ldg(omf + (long long)d * SD + c);
#pragma unroll
        for (int r = 0; r < kRows; ++r) u[r] = fmaf(xs[r * D + d], o, u[r]);
      }
      const float gc = __ldg(G + (long long)c * D + i);
      const float gs = __ldg(G + ((long long)SD + c) * D + i);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float sn, cs;
        sincosf(u[r], &sn, &cs);
        acc[r] = fmaf(cs, gc, fmaf(sn, gs, acc[r]));
      }
    }
  } else {
    // matrix-valued update of column i: the j-loop over the inducing points
    const float vi = inv[D];
    for (int m = tid; m < M; m += nt) {
      float zm[kMaxD], nu[kMaxD];
#pragma unroll
      for (int k = 0; k < kMaxD; ++k) {
        zm[k] = k < D ? __ldg(z + (long long)m * D + k) : 0.f;
        nu[k] = k < D ? __ldg(nur + (long long)m * D + k) : 0.f;
      }
      const float zi = __ldg(z + (long long)m * D + i);
#pragma unroll 1
      for (int r = 0; r < kRows; ++r) {
        float dk[kMaxD];
        float sq = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxD; ++k) {
          dk[k] = k < D ? xs[r * D + k] - zm[k] : 0.f;
          sq = fmaf(dk[k], dk[k], sq);
        }
        const float di = xs[r * D + i] - zi;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxD; ++j) {
          if (j >= D) continue;
          const float iv = inv[j];
          const float E = expf(-0.5f * sq * iv);
          float base = dk[j] * di * iv;
          if (i == j) base += (float)(D - 1) - sq * iv;
          s = fmaf(E * base * (vi * iv), nu[j], s);
        }
        acc[r] += s;
      }
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float v = df::warp_sum(acc[r]);
    if (lane == 0) red[warp][r] = v;
  }
  __syncthreads();
  if (tid < kRows) {
    const int n = r0 + tid;
    if (n < N) {
      float f = 0.f;
      for (int v = 0; v < df::kWarps; ++v) f += red[v][tid];
      a.part[((l * n_slots + slot) * N + n) * D + i] = f;
    }
  }
}

}  // namespace

// ORFF columns per chunk slot: the wrapper sizes the slab part
// (L, ceil(SD / chunk) + 1, N, D) from it.
extern "C" int df_pathwise_tiled_fwd_chunk() { return kChunk; }

// Launches the tiled DF eval on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes it does not take (D above 16, a grid
// dimension past its limit). Operands as in df_pathwise_fwd; part is
// (L, ceil(SD / chunk) + 1, N, D) and every entry of it is written; the
// output is its sum over the second dim.
extern "C" int df_pathwise_tiled_fwd(
    const float* x, long long x_ls, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* G, long long G_ls,
    const float* z, long long z_ls, const float* nur, long long nur_ls,
    const float* ls2, long long ls2_ls, const float* var, long long var_ls,
    float* part, int L, int N, int D, int SD, int M, int device,
    void* stream) {
  if (L < 1 || N < 1 || D < 1 || D > kMaxD || SD < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (SD + kChunk - 1) / kChunk;
  const long long n_tiles = (N + kRows - 1) / kRows;
  if (n_tiles > 65535 || (long long)L * D > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  FwdArgs a;
  a.x = x; a.omf = omf; a.phf = phf; a.G = G; a.z = z; a.nur = nur;
  a.ls2 = ls2; a.var = var;
  a.x_ls = x_ls; a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.G_ls = G_ls;
  a.z_ls = z_ls; a.nur_ls = nur_ls; a.ls2_ls = ls2_ls; a.var_ls = var_ls;
  a.part = part;
  a.N = N; a.D = D; a.SD = SD; a.M = M; a.n_chunks = n_chunks;

  const dim3 grid(n_chunks + 1, (unsigned)n_tiles, L * D);
  df_pathwise_tiled_fwd_kernel<<<grid, df::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
