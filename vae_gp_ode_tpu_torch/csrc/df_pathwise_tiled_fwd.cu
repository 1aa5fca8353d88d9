// Grid-tiled per-step pathwise evaluation of the divergence-free (DF) GP
// sample for wide shapes (any state dim D, many features), one launch for
// all L Monte-Carlo draws.
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
// inputs give the same bits. Any N, S and M is taken, and any D: the
// kernel's template parameter DMAX is the widest state dim of an instance,
// 16 for D <= 16, and 0 for the wide kernel that takes every D above,
// with no per-thread array that grows with D and its tables in dynamic
// shared memory sized at launch (read through L2 where they would not
// fit). A shape is refused only where the grid or a block's rows exceed
// the card's limits.
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

// Inducing points per update block: kUpdM for the D <= 16 instance; for
// the wide kernel as many as keep a block's (row, output, point) terms at
// kRows kThreads (one point above D = kThreads), so that wide shapes
// spread their update over more blocks.
__host__ __device__ __forceinline__ int upd_points(int D) {
  return D <= 16 ? kUpdM : D < kThreads ? kThreads / D : 1;
}

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
  int wide_par;      // the wide kernel: 1/ls2 | var in shared memory
};

// DMAX: the widest state dim of the instance, 16 (0: the wide kernel
// below, for any D above 16).
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    df_pathwise_tiled_fwd_kernel(FwdArgs a) {
  __shared__ float xs[kRows * DMAX];
  __shared__ __align__(16) float trig[2 * kChunk * kRows];  // [k][r]
  __shared__ float red[kThreads * kRows];
  __shared__ float par[DMAX * DMAX + DMAX];  // 1 / ls2 [j, i] | var
  __shared__ float zs[kUpdM * DMAX];
  __shared__ float nus[kUpdM * DMAX];
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

// 1 / ls2[j, i] from the block's table, or from ls2 through L2 where the
// table did not fit the shared memory.
__device__ __forceinline__ float inv_ls2(const float* par, const float* ls2,
                                         int D, int j, int i) {
  return par ? par[j * D + i] : 1.f / __ldg(ls2 + j * D + i);
}

// DMAX = 0, the wide kernel: the blocks for any state dim above 16, on
// dynamic shared memory sized at launch: [xs (kRows D) | the kind's
// tables]. An update block takes upd_points(D) points (kThreads / D); its
// thread walks (row, output) pairs, every point of the block and all D
// columns j in loops (no per-thread array grows with D), with the points'
// Z and nur rows and the rows' squared distances to them in shared
// memory, and 1/ls2 | var there too where they fit (a.wide_par), else
// ls2 and var through L2. A chunk
// block computes one sincosf per (row, column) as the narrow instance
// does; thread (i, p) then sums output i over every P-th column, P =
// kThreads / D (one group, every output of a thread's stride, above D =
// 256).
template <>
__global__ void __launch_bounds__(kThreads)
    df_pathwise_tiled_fwd_kernel<0>(FwdArgs a) {
  extern __shared__ float smem[];
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
  float* xs = smem;                          // kRows * D
  float* out = a.part + ((l * n_slots + slot) * N + r0) * D;

  const float* x = a.x + l * a.x_ls;
  for (int t = tid; t < RD; t += nt) {
    const int n = r0 + t / D;
    xs[t] = n < N ? x[(long long)n * D + t % D] : 0.f;
  }

  if (upd) {
    // -- matrix-valued update of inducing points m0 .. m0 + cnt - 1
    const int MU = upd_points(D);
    const int m0 = s * MU;
    const int cnt = min(MU, M - m0);
    const float* ls2 = a.ls2 + l * a.ls2_ls;
    const float* var = a.var + l * a.var_ls;
    float* zs = xs + RD;                           // MU * D
    float* nus = zs + MU * D;                      // MU * D
    float* sqs = nus + MU * D;                     // kRows * MU
    float* par = a.wide_par ? sqs + kRows * MU : nullptr;   // D * D + D
    if (par) df::load_par(par, ls2, var, D);
    const float* z = a.z + l * a.z_ls + (long long)m0 * D;
    const float* nur = a.nur + l * a.nur_ls + (long long)m0 * D;
    for (int t = tid; t < cnt * D; t += nt) {
      zs[t] = z[t];
      nus[t] = nur[t];
    }
    __syncthreads();
    // |x_r - z_m|^2 of the tile's rows and the block's points
    for (int t = tid; t < kRows * cnt; t += nt) {
      const int r = t / cnt, mm = t % cnt;
      float sq = 0.f;
      for (int k = 0; k < D; ++k) {
        const float dk = xs[r * D + k] - zs[mm * D + k];
        sq = fmaf(dk, dk, sq);
      }
      sqs[r * MU + mm] = sq;
    }
    __syncthreads();
    for (int pair = tid; pair < rows * D; pair += nt) {
      const int r = pair / D, i = pair % D;
      const float* xr = xs + r * D;
      const float vi = par ? par[D * D + i] : __ldg(var + i);
      float acc = 0.f;
      for (int mm = 0; mm < cnt; ++mm) {
        const float* zm = zs + mm * D;
        const float* nu = nus + mm * D;
        const float sq = sqs[r * MU + mm];
        const float di = xr[i] - zm[i];
        float sm = 0.f;
        for (int j = 0; j < D; ++j) {
          const float iv = inv_ls2(par, ls2, D, j, i);
          const float E = expf(-0.5f * sq * iv);
          float base = (xr[j] - zm[j]) * di * iv;
          if (i == j) base += (float)(D - 1) - sq * iv;
          sm = fmaf(E * base * (vi * iv), nu[j], sm);
        }
        acc += sm;
      }
      out[pair] = acc;
    }
    return;
  }

  // -- ORFF prior over feature columns c0 .. c0 + cnt - 1
  float* trig = xs + RD;                     // [k][r], 2 kChunk kRows
  float* red = trig + 2 * kChunk * kRows;    // kThreads * kRows
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

  // thread (i, p) = (q % D, q / D): all rows of output i over every P-th
  // column; P = 1 above D = kThreads, where a thread takes every nt-th
  // output
  const int P = D <= nt ? nt / D : 1;
  const float* G = a.G + l * a.G_ls + (long long)c0 * D;
  const long long sin_off = (long long)SD * D - (long long)cnt * D;
  for (int q = tid; q < P * D; q += nt) {
    const int i = q % D, p = q / D;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int k = p; k < 2 * cnt; k += P) {
      // k < cnt: cos column k; else sin column k - cnt
      const bool sn = k >= cnt;
      const int row = sn ? kChunk + k - cnt : k;
      const float gv =
          __ldg(G + (long long)k * D + i + (sn ? sin_off : 0));
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(trig[row * kRows + r], gv, acc[r]);
    }
    if (P == 1) {
      for (int r = 0; r < rows; ++r) out[r * D + i] = acc[r];
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) red[(p * kRows + r) * D + i] = acc[r];
    }
  }
  if (P > 1) {
    __syncthreads();
    for (int t = tid; t < rows * D; t += nt) {
      float f = 0.f;
      for (int q = 0; q < P; ++q) f += red[q * RD + t];
      out[t] = f;
    }
  }
}

// Floats of the wide kernel's dynamic shared memory at state dim D, with
// 1/ls2 | var in it (par) or not.
long long wide_smem_floats(int D, bool par) {
  const long long MU = upd_points(D);
  const long long upd = (2 * D + kRows) * MU + (par ? (long long)D * D + D : 0);
  const long long chunk = 2LL * kChunk * kRows + (long long)kThreads * kRows;
  return (long long)kRows * D + (upd > chunk ? upd : chunk);
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
static_assert(16 * kRows <= kThreads,
              "the D <= 16 update blocks give each (row, output) a thread");

}  // namespace

// The slab part's slots, n_mc + n_chunks, for S*D = SD feature columns,
// M inducing points and state dim D; the wrapper sizes part from it.
extern "C" int df_pathwise_tiled_fwd_slots(int SD, int M, int D) {
  const int mu = upd_points(D < 1 ? 1 : D);
  return (M + mu - 1) / mu + (SD + kChunk - 1) / kChunk;
}

// Launches the tiled DF eval and its slot sum on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for shapes it does not take
// (a part whose slots are not df_pathwise_tiled_fwd_slots, a grid past its
// limit, a state dim whose rows do not fit a block's opt-in shared
// memory). Operands as in df_pathwise_fwd; part (L, n_slots, N, D) is
// workspace; out (L, N, D) is the evaluation.
extern "C" int df_pathwise_tiled_fwd(
    const float* x, long long x_ls, const float* omf, long long omf_ls,
    const float* phf, long long phf_ls, const float* G, long long G_ls,
    const float* z, long long z_ls, const float* nur, long long nur_ls,
    const float* ls2, long long ls2_ls, const float* var, long long var_ls,
    float* part, float* out, int n_slots, int L, int N, int D, int SD, int M,
    int device, void* stream) {
  if (L < 1 || N < 1 || D < 1 || SD < 1 || M < 1 ||
      n_slots != df_pathwise_tiled_fwd_slots(SD, M, D))
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.L = L; a.N = N; a.D = D; a.SD = SD; a.M = M;
  a.n_tiles = (N + kRows - 1) / kRows;
  a.n_chunks = (SD + kChunk - 1) / kChunk;
  a.n_mc = (M + upd_points(D) - 1) / upd_points(D);
  const long long blocks = (long long)L * a.n_tiles * n_slots;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  a.wide_par = 0;
  if (D > 16) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    a.wide_par = sizeof(float) * wide_smem_floats(D, true) <= (size_t)optin;
    smem = sizeof(float) * wide_smem_floats(D, a.wide_par);
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  a.x = x; a.omf = omf; a.phf = phf; a.G = G; a.z = z; a.nur = nur;
  a.ls2 = ls2; a.var = var;
  a.x_ls = x_ls; a.omf_ls = omf_ls; a.phf_ls = phf_ls; a.G_ls = G_ls;
  a.z_ls = z_ls; a.nur_ls = nur_ls; a.ls2_ls = ls2_ls; a.var_ls = var_ls;
  a.part = part;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) {
    df_pathwise_tiled_fwd_kernel<16><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  } else {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(df_pathwise_tiled_fwd_kernel<0>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    df_pathwise_tiled_fwd_kernel<0><<<(unsigned)blocks, kThreads, smem,
                                     s>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long outs = (long long)L * N * D;
  df_pathwise_tiled_fwd_sum_slots<<<(unsigned)((outs + kThreads - 1) /
                                               kThreads),
                                    kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
