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
// What bounds it on an H100. At the wide shapes (L=5, N=20, D=12, S=1024,
// so SD = 12288, M=100) one launch reads ~9 MB of per-draw omf and G
// (~2.7 us at 3.35 TB/s) and needs one sincosf for each of the 1.2 M (row,
// feature column) pairs, D FMAs before it and 2D after it, plus M D^2 expf
// per row for the update (~110 MFLOP with the trig, ~2 us of f32 issue):
// bound by bytes on paper, in practice by the issue rate of sincosf/expf
// and the FMAs around them.
//
// Design. A 1-D grid of blocks of kThreads threads, each owning one draw,
// one tile of kRows batch rows and ALL D output columns:
//  - update blocks (the lowest block indices, so their expf chains start
//    first): kUpdM inducing points each. Thread (r, i, sub) owns output
//    pair (row r, column i) and every kThreads / (kRows D)-th point of the
//    block; it walks the D columns j of the matrix-valued update for its
//    points, so all D^2 (j, i) pairs of a (row, point) are done in one
//    pass, and the subgroups' sums meet in shared memory.
//  - chunk blocks: kChunk ORFF feature columns each, one per thread. The
//    thread computes u = x . omf[:, c] + phf[c] for the tile's rows and ONE
//    sincosf per (row, column), into shared memory; then thread (i, p) sums
//    cos(u) G[c, i] + sin(u) G[SD + c, i] over every P-th column (P =
//    kThreads / D, interleaved so a warp reads neighbouring rows of G) for
//    all kRows rows in registers, and the P groups meet in shared memory.
// Each block writes its rows of its slot of the slab part (L, n_slots, N,
// D), n_slots = n_mc + n_chunks, and a second kernel of the same launch
// sums the slots in order into the output (one thread per output entry;
// in the launcher, so a call costs the host one library call, as the
// single-block kernel does): no atomics, and two launches on the same
// inputs give the same bits. Any N, S and M is taken; D above 16 is
// refused (df_common.cuh kMaxD).
//
// The design it replaced: one block per output column i, so x . omf and
// sincosf were recomputed D times per (row, column) and the update ran
// once per i.
//
// Accuracy. Accurate sincosf/expf, no fast-math; everything is f32.

#include "df_common.cuh"

namespace {

constexpr int kThreads = df::kThreads;
constexpr int kRows = 8;          // batch rows per block
constexpr int kChunk = kThreads;  // ORFF feature columns per chunk block
constexpr int kUpdM = 16;         // inducing points per update block
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
  float* part;       // (L, n_mc + n_chunks, N, D)
  float* out;        // (L, N, D)
  int L, N, D, SD, M, n_tiles, n_chunks, n_mc;
};

__global__ void __launch_bounds__(kThreads)
    df_pathwise_tiled_fwd_kernel(FwdArgs a) {
  __shared__ float xs[kRows * kMaxD];
  __shared__ __align__(16) float trig[2 * kChunk * kRows];  // [k][r]
  __shared__ float red[kThreads * kRows];
  __shared__ float par[kMaxD * kMaxD + kMaxD];  // 1 / ls2 [j, i] | var
  __shared__ float zs[kUpdM * kMaxD];
  __shared__ float nus[kUpdM * kMaxD];
  const int D = a.D, N = a.N, SD = a.SD, M = a.M;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  // block -> (kind, draw, row tile, slot); update blocks first
  long long b = blockIdx.x;
  const long long n_upd = (long long)a.L * a.n_tiles * a.n_mc;
  const bool upd = b < n_upd;
  if (!upd) b -= n_upd;
  const int per = upd ? a.n_mc : a.n_chunks;
  const int s = (int)(b % per);
  b /= per;
  const int tile = (int)(b % a.n_tiles);
  const long long l = b / a.n_tiles;
  const int n_slots = a.n_mc + a.n_chunks;
  const int slot = upd ? s : a.n_mc + s;
  const int r0 = tile * kRows;
  const int rows = min(kRows, N - r0);
  const int RD = kRows * D;

  const float* x = a.x + l * a.x_ls;
  for (int t = tid; t < RD; t += nt) {
    const int n = r0 + t / D;
    xs[t] = n < N ? x[(long long)n * D + t % D] : 0.f;
  }

  if (upd) {
    // -- matrix-valued update of inducing points m0 .. m0 + cnt - 1
    const int m0 = s * kUpdM;
    const int cnt = min(kUpdM, M - m0);
    df::load_par(par, a.ls2 + l * a.ls2_ls, a.var + l * a.var_ls, D);
    const float* z = a.z + l * a.z_ls + (long long)m0 * D;
    const float* nur = a.nur + l * a.nur_ls + (long long)m0 * D;
    for (int t = tid; t < cnt * D; t += nt) {
      zs[t] = z[t];
      nus[t] = nur[t];
    }
    __syncthreads();
    const int PU = nt / RD;           // subgroups of points (RD <= 128)
    const int pair = tid % RD, sub = tid / RD;
    const int r = pair / D, i = pair % D;
    float acc = 0.f;
    if (sub < PU && r < rows) {
      const float* xr = xs + r * D;
      const float* inv = par;
      const float vi = par[D * D + i];
      for (int mm = sub; mm < cnt; mm += PU) {
        const float* zm = zs + mm * D;
        const float* nu = nus + mm * D;
        float sq = 0.f;
        for (int k = 0; k < D; ++k) {
          const float dk = xr[k] - zm[k];
          sq = fmaf(dk, dk, sq);
        }
        const float di = xr[i] - zm[i];
        float sm = 0.f;
        for (int j = 0; j < D; ++j) {
          const float iv = inv[j * D + i];
          const float E = expf(-0.5f * sq * iv);
          float base = (xr[j] - zm[j]) * di * iv;
          if (i == j) base += (float)(D - 1) - sq * iv;
          sm = fmaf(E * base * (vi * iv), nu[j], sm);
        }
        acc += sm;
      }
    }
    if (sub < PU) red[sub * RD + pair] = acc;
    __syncthreads();
    for (int t = tid; t < rows * D; t += nt) {
      float f = 0.f;
      for (int q = 0; q < PU; ++q) f += red[q * RD + t];
      a.part[((l * n_slots + slot) * N + r0) * D + t] = f;
    }
    return;
  }

  // -- ORFF prior over feature columns c0 .. c0 + cnt - 1
  const int c0 = s * kChunk;
  const int cnt = min(kChunk, SD - c0);
  __syncthreads();
  if (tid < cnt) {
    // one sincosf per (row, column)
    const float* omf = a.omf + l * a.omf_ls + c0 + tid;
    float u[kRows];
    const float ph = __ldg(a.phf + l * a.phf_ls + c0 + tid);
#pragma unroll
    for (int r = 0; r < kRows; ++r) u[r] = ph;
    for (int d = 0; d < D; ++d) {
      const float o = __ldg(omf + (long long)d * SD);
#pragma unroll
      for (int r = 0; r < kRows; ++r) u[r] = fmaf(xs[r * D + d], o, u[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float sn, cs;
      sincosf(u[r], &sn, &cs);
      trig[tid * kRows + r] = cs;
      trig[(kChunk + tid) * kRows + r] = sn;
    }
  }
  __syncthreads();

  // thread (i, p): all rows of output column i over every P-th column
  const int P = nt / D;
  const int i = tid % D, p = tid / D;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  if (p < P) {
    const float* G = a.G + l * a.G_ls + (long long)c0 * D + i;
    const long long sin_off = (long long)SD * D - (long long)cnt * D;
    for (int k = p; k < 2 * cnt; k += P) {
      // k < cnt: cos column k; else sin column k - cnt
      const bool sn = k >= cnt;
      const int row = sn ? kChunk + k - cnt : k;
      const float gv = __ldg(G + (long long)k * D + (sn ? sin_off : 0));
      const float4 t0 = *reinterpret_cast<const float4*>(trig + row * kRows);
      const float4 t1 =
          *reinterpret_cast<const float4*>(trig + row * kRows + 4);
      acc[0] = fmaf(t0.x, gv, acc[0]);
      acc[1] = fmaf(t0.y, gv, acc[1]);
      acc[2] = fmaf(t0.z, gv, acc[2]);
      acc[3] = fmaf(t0.w, gv, acc[3]);
      acc[4] = fmaf(t1.x, gv, acc[4]);
      acc[5] = fmaf(t1.y, gv, acc[5]);
      acc[6] = fmaf(t1.z, gv, acc[6]);
      acc[7] = fmaf(t1.w, gv, acc[7]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) red[(p * kRows + r) * D + i] = acc[r];
  }
  __syncthreads();
  for (int t = tid; t < rows * D; t += nt) {
    float f = 0.f;
    for (int q = 0; q < P; ++q) f += red[q * RD + t];
    a.part[((l * n_slots + slot) * N + r0) * D + t] = f;
  }
}

// out[l, n, i] = sum over the slots of part[l, :, n, i], in slot order.
__global__ void __launch_bounds__(kThreads)
    df_pathwise_tiled_fwd_sum_slots(FwdArgs a) {
  const long long ND = (long long)a.N * a.D;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.L * ND) return;
  const int n_slots = a.n_mc + a.n_chunks;
  const float* p = a.part + (t / ND) * n_slots * ND + t % ND;
  float f = 0.f;
  for (int q = 0; q < n_slots; ++q) f += p[q * ND];
  a.out[t] = f;
}

static_assert(kRows == 8, "chunk blocks read a column's rows as two float4");

}  // namespace

// The slab part's slots, n_mc + n_chunks, for state dim D, S*D = SD
// feature columns and M inducing points; the wrapper sizes part from it.
extern "C" int df_pathwise_tiled_fwd_slots(int SD, int M) {
  return (M + kUpdM - 1) / kUpdM + (SD + kChunk - 1) / kChunk;
}

// Launches the tiled DF eval and its slot sum on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for shapes it does not take
// (D above 16, a part whose slots are not df_pathwise_tiled_fwd_slots, a
// grid past its limit). Operands as in df_pathwise_fwd; part (L, n_slots,
// N, D) is workspace; out (L, N, D) is the evaluation.
extern "C" int df_pathwise_tiled_fwd(
    const float* x, long long x_ls, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* G, long long G_ls,
    const float* z, long long z_ls, const float* nur, long long nur_ls,
    const float* ls2, long long ls2_ls, const float* var, long long var_ls,
    float* part, float* out, int n_slots, int L, int N, int D, int SD, int M,
    int device, void* stream) {
  if (L < 1 || N < 1 || D < 1 || D > kMaxD || SD < 1 || M < 1 ||
      n_slots != df_pathwise_tiled_fwd_slots(SD, M))
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.L = L; a.N = N; a.D = D; a.SD = SD; a.M = M;
  a.n_tiles = (N + kRows - 1) / kRows;
  a.n_chunks = (SD + kChunk - 1) / kChunk;
  a.n_mc = (M + kUpdM - 1) / kUpdM;
  const long long blocks = (long long)L * a.n_tiles * n_slots;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  a.x = x; a.omf = omf; a.phf = phf; a.G = G; a.z = z; a.nur = nur;
  a.ls2 = ls2; a.var = var;
  a.x_ls = x_ls; a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.G_ls = G_ls;
  a.z_ls = z_ls; a.nur_ls = nur_ls; a.ls2_ls = ls2_ls; a.var_ls = var_ls;
  a.part = part;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  df_pathwise_tiled_fwd_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long outs = (long long)L * N * D;
  df_pathwise_tiled_fwd_sum_slots<<<(unsigned)((outs + kThreads - 1) /
                                               kThreads),
                                    kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
