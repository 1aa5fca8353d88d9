// Grid-tiled per-step pathwise evaluation of the dimwise-RBF GP sample for
// wide shapes (many rows, output dims K and features S), one library call
// for all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_fwd_kernel` of
// vae_gp_ode_tpu/ops/pathwise_tiled.py. It computes the same function as
// pathwise_fwd.cu (`pathwise_eval_reference`), per draw l, row n, output k:
//
//   f_k(x) = sqrt(var_k / S) sum_s cos(x . omega[:, s, k] + phase[s, k]) w[s, k]
//          + var_k sum_m exp(-0.5 sum_d ((x_d - Z[m, d]) / ls[k, d])^2) nu[k, m]
//
// on the same operand layouts and draw strides as pathwise_fwd.cu.
//
// What bounds it on an H100. At the wide request's shape (L=5, N=400,
// D=K=12, S=1024, M=100) the prior term is 24.6 M (row, feature column)
// pairs of 2D + 4 operations (a cosine counted as one) and the update 2.4 M
// (row, point, output) items of 4D + 4: 0.81 GFLOP, 12.1 us at the f32
// peak, bound by operations (its ~3.5 MB of operands take 1 us). An
// accurate cosf is some twenty instructions, so the prior term alone is
// ~1 G lane-instructions, ~35 us at the card's full instruction rate; the
// kernel reaches ~40% of that, held back by the waits on each column's
// omega values at two blocks an SM (PERF.md section 6).
//
// Design. A 1-D grid of kThreads-thread blocks, each one draw l, one tile
// of kTile = 20 rows, one chunk of up to kKc = 32 output dims and one slot:
// a range of features (prior slots) or of inducing points (update slots,
// after the prior ones). The block's rows sit in shared memory (kTile x D,
// padded to float4s) and each thread holds a kTile-row register tile of
// its output dim k: thread t takes k = chunk start + t % kc (kc output dims
// in the chunk) and the features s = range start + t / kc + p (256 / kc),
// so a warp's loads of omega, phase and w are contiguous columns s K + k of
// their (D, S K) layouts. An update slot's (point, output) items go the
// same way; each pass stages its points' Z and the chunk's 1/ls into
// shared memory in tiles of kDT dims, read [d][point] and [d][k], never
// D floats apart by a thread. At the end the block adds each (row, k) over
// the threads of that k in shared memory in a fixed order, scales it
// (sqrt(var_k / S) or var_k) and writes it to its slot of the partials
// part (L, n_slots, N, K). A second kernel of the same library call
// (pathwise_tiled_fwd_sum) adds the slots of each output in order, so the
// call returns f (L, N, K), costs the host one library call and no
// PyTorch reduction, and two launches on the same inputs give the same
// bits (no atomics). A slot covers kPasses rounds of the chunk's threads
// (the last range fewer), fewer where the grid would otherwise leave the
// card's SMs without two blocks each (a rule of the shapes and the card's
// SM count, so that one card always sums the same shapes in the same
// order). Any N, K, S and M is taken, and D up to kMaxD = 2,048 (the rows
// then take 160 KB of shared memory); pathwise_tiled_fwd_workspace exports
// the size of the partials on a card with a given SM count, which the
// launcher checks against its own card's.
//
// Accuracy. Accurate cosf/expf, no fast-math (x . omega can be large);
// everything is f32, no TF32. x . omega is summed from 0 and the phase
// added last, as the plain version does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 20;       // rows per block
constexpr int kKc = 32;         // output dims per block at most
constexpr int kPasses = 4;      // rounds of the chunk's threads per slot
constexpr int kDT = 32;         // dims per staged tile of Z and 1/ls
constexpr int kRS = kTile + 1;  // row stride of the threads' sums
constexpr int kMaxD = 2048;
constexpr int kSumThreads = 256;
constexpr int kParts = 8;       // threads per output of the sum
constexpr int kLanes = kSumThreads / kParts;   // outputs per sum block

struct FwdArgs {
  const float* x;      // (N, D)
  const float* omega;  // (D, S, K)
  const float* phase;  // (1, S, K)
  const float* w;      // (S, K)
  const float* z;      // (M, D)
  const float* nu;     // (K, M)
  const float* ls;     // (K, D)
  const float* var;    // (K,)
  long long x_ls, om_ls, ph_ls, w_ls, z_ls, nu_ls, ls_ls, var_ls;
  float* part;         // (L, n_slots, N, K) the blocks' partials
  float* out;          // (L, N, K)
  int L, N, D, K, S, M;
  int n_rt, n_kc, n_sr, n_slots, span;  // span: features or points a slot
  int sgp;             // the row stride of the staged Z: the most items
                       // per round of any chunk, plus one
};

// The row stride of the staged rows: D rounded up to whole float4s.
__host__ __device__ inline int pad4(int D) { return (D + 3) & ~3; }

// The layout of a launch's grid: rows tiles, output-dim chunks, slots and
// features or points per slot, from the shapes and the card's SM count:
// a slot takes fewer rounds until the grid gives every SM two blocks.
struct Layout {
  int n_rt, n_kc, n_sr, n_ur, span, sgp;
};

Layout layout_of(int L, int N, int K, int S, int M, int sms) {
  Layout g;
  g.n_rt = (N + kTile - 1) / kTile;
  g.n_kc = (K + kKc - 1) / kKc;
  const int kc = K < kKc ? K : kKc;
  const int rest = K % kKc;
  const int kc_min = K > kKc && rest ? rest : kc;
  g.sgp = kThreads / kc_min + 1;
  const long long tiles = (long long)L * g.n_rt * g.n_kc;
  int passes = kPasses;
  for (; passes > 1; passes /= 2) {
    const long long span = (long long)(kThreads / kc) * passes;
    if (tiles * ((S + span - 1) / span + (M + span - 1) / span) >=
        2LL * sms)
      break;
  }
  g.span = kThreads / kc * passes;
  g.n_sr = (S + g.span - 1) / g.span;
  g.n_ur = (M + g.span - 1) / g.span;
  return g;
}

// Shared floats of a block: the rows, then the staged Z and 1/ls of an
// update round or, at the end, the threads' sums and their parts.
long long smem_floats(int D, int sgp) {
  const long long staged = (long long)kDT * sgp + kDT * kKc;
  const long long sums = (long long)kThreads * kRS + kTile * kKc;
  return (long long)kTile * pad4(D) + (staged > sums ? staged : sums);
}

// The 4 entries of row r of the staged rows from column d4 (a float4).
__device__ __forceinline__ float4 row4(const float* xs, int Dp, int r,
                                       int d4) {
  return *reinterpret_cast<const float4*>(xs + r * Dp + d4);
}

__global__ void __launch_bounds__(kThreads)
    pathwise_tiled_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, K = a.K, S = a.S, M = a.M, N = a.N;
  const int Dp = pad4(D), tid = threadIdx.x;
  int b = blockIdx.x;
  const int slot = b % a.n_slots;
  b /= a.n_slots;
  const int kc0 = b % a.n_kc * kKc;
  b /= a.n_kc;
  const int t0 = b % a.n_rt * kTile;
  const long long l = b / a.n_rt;
  const int kc = min(kKc, K - kc0);      // output dims of this chunk
  const int sg = kThreads / kc;          // items per round
  const bool active = tid < kc * sg;
  const int kl = tid % kc, grp = tid / kc;
  const int k = kc0 + kl;
  const int rows = min(kTile, N - t0);
  const long long SK = (long long)S * K;
  const bool prior = slot < a.n_sr;

  float* xs = smem;                       // kTile * Dp   the block's rows
  float* tab = xs + kTile * Dp;           // staged Z and 1/ls, then sums
  const float* x = a.x + l * a.x_ls + (long long)t0 * D;
  for (int e = tid; e < kTile * Dp; e += kThreads) {
    const int r = e / Dp, d = e - r * Dp;
    xs[e] = r < rows && d < D ? x[(long long)r * D + d] : 0.f;
  }
  __syncthreads();

  float acc[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) acc[r] = 0.f;

  if (prior) {
    // sum_s cos(x . omega[:, s, k] + phase[s, k]) w[s, k] over the range
    const float* omega = a.omega + l * a.om_ls;
    const float* phase = a.phase + l * a.ph_ls;
    const float* w = a.w + l * a.w_ls;
    const int s1 = min(S, (slot + 1) * a.span);
    for (int s = slot * a.span + grp; active && s < s1; s += sg) {
      const long long c = (long long)s * K + k;
      const float ph = __ldg(phase + c);
      const float wv = __ldg(w + c);
      // x . omega from 0, the phase added last (started at the phase, the
      // chain would round each of its D steps at the phase's size)
      float u[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) u[r] = 0.f;
#pragma unroll 2
      for (int d4 = 0; d4 < Dp; d4 += 4) {
        float o[4];
#pragma unroll
        for (int h = 0; h < 4; ++h)
          o[h] = d4 + h < D ? __ldg(omega + (d4 + h) * SK + c) : 0.f;
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          const float4 xv = row4(xs, Dp, r, d4);
          u[r] = fmaf(xv.x, o[0], fmaf(xv.y, o[1], fmaf(xv.z, o[2],
                      fmaf(xv.w, o[3], u[r]))));
        }
      }
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        acc[r] = fmaf(cosf(u[r] + ph), wv, acc[r]);
    }
  } else {
    // sum_m exp(-0.5 |(x - Z_m) / ls_k|^2) nu[k, m] over the range, a round
    // of sg points at a time with their Z staged in tiles of kDT dims
    const int m0 = (slot - a.n_sr) * a.span;
    const int m1 = min(M, m0 + a.span);
    const float* z = a.z + l * a.z_ls;
    const float* ls = a.ls + l * a.ls_ls;
    const float* nu = a.nu + l * a.nu_ls;
    float* zt = tab;                      // kDT * sgp     Z [d][point]
    float* ilt = zt + kDT * a.sgp;        // kDT * kKc     1/ls [d][k]
    for (int mb = m0; mb < m1; mb += sg) {
      const int pc = min(sg, m1 - mb);
      const bool valid = active && grp < pc;
      float q[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) q[r] = 0.f;
      for (int d0 = 0; d0 < D; d0 += kDT) {
        const int nd = min(kDT, D - d0);
        __syncthreads();   // the last tile's reads of zt and ilt are done
        for (int e = tid; e < kDT * sg; e += kThreads) {
          const int j = e / kDT, dd = e % kDT;
          zt[dd * a.sgp + j] =
              j < pc && dd < nd ? z[(long long)(mb + j) * D + d0 + dd] : 0.f;
        }
        for (int e = tid; e < kDT * kKc; e += kThreads) {
          const int kk = e / kDT, dd = e % kDT;
          ilt[dd * kKc + kk] =
              kk < kc && dd < nd ? 1.f / ls[(long long)(kc0 + kk) * D + d0 + dd]
                                 : 0.f;
        }
        __syncthreads();
        for (int q4 = 0; q4 < nd; q4 += 4) {
          float zd[4], il[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            zd[h] = zt[(q4 + h) * a.sgp + grp];
            il[h] = ilt[(q4 + h) * kKc + kl];   // 0 past D
          }
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            const float4 xv = row4(xs, Dp, r, d0 + q4);
            const float e0 = (xv.x - zd[0]) * il[0];
            const float e1 = (xv.y - zd[1]) * il[1];
            const float e2 = (xv.z - zd[2]) * il[2];
            const float e3 = (xv.w - zd[3]) * il[3];
            q[r] = fmaf(e0, e0, fmaf(e1, e1, fmaf(e2, e2, fmaf(e3, e3,
                        q[r]))));
          }
        }
      }
      const float nv = valid ? __ldg(nu + (long long)k * M + mb + grp) : 0.f;
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        acc[r] = fmaf(expf(-0.5f * q[r]), nv, acc[r]);
    }
  }

  // each (row, k) over the threads of k, in a fixed order: P parts of the
  // rounds' threads (every P-th one), then the parts
  __syncthreads();   // the last round's reads of zt and ilt are done
  float* sums = tab;                      // kThreads * kRS
  float* parts = sums + kThreads * kRS;   // kTile * kKc
#pragma unroll
  for (int r = 0; r < kTile; ++r) sums[tid * kRS + r] = acc[r];
  __syncthreads();
  const int O = kTile * kc;
  const int P = O < kThreads ? kThreads / O : 1;
  for (int e = tid; e < O * P; e += kThreads) {
    const int o = e % O, p = e / O;
    const int r = o / kc, kk = o % kc;
    float v = 0.f;
    for (int j = p; j < sg; j += P) v += sums[(j * kc + kk) * kRS + r];
    parts[e] = v;
  }
  __syncthreads();
  for (int o = tid; o < O; o += kThreads) {
    const int r = o / kc, kk = kc0 + o % kc;
    if (r >= rows) continue;
    float v = 0.f;
    for (int p = 0; p < P; ++p) v += parts[p * O + o];
    const float vk = a.var[l * a.var_ls + kk];
    const float scale = prior ? sqrtf(vk / (float)S) : vk;
    a.part[((l * a.n_slots + slot) * N + t0 + r) * K + kk] = scale * v;
  }
}

// f[l, n, k] = the sum of its partials over the slots in a fixed order:
// kParts threads an output take every kParts-th slot (a warp reads kLanes
// outputs' same slot, contiguous), then the parts are added in order.
__global__ void __launch_bounds__(kSumThreads)
    pathwise_tiled_fwd_sum_kernel(FwdArgs a) {
  __shared__ float parts[kParts][kLanes];
  const long long NK = (long long)a.N * a.K;
  const int j = threadIdx.x % kLanes, q = threadIdx.x / kLanes;
  const long long e = (long long)blockIdx.x * kLanes + j;
  float v = 0.f;
  if (e < a.L * NK) {
    const float* p = a.part + e / NK * a.n_slots * NK + e % NK;
#pragma unroll 4
    for (int s = q; s < a.n_slots; s += kParts) v += p[s * NK];
  }
  parts[q][j] = v;
  __syncthreads();
  if (q == 0 && e < a.L * NK) {
    float f = 0.f;
#pragma unroll
    for (int r = 0; r < kParts; ++r) f += parts[r][j];
    a.out[e] = f;
  }
}

}  // namespace

// The widest state dim D the library takes.
extern "C" int pathwise_tiled_fwd_max_dim() { return kMaxD; }

// Floats of the partials for these shapes on a card with `sms` SMs; 0 for
// shapes the launcher refuses (D above pathwise_tiled_fwd_max_dim, S K past
// 2^31 - 1).
extern "C" long long pathwise_tiled_fwd_workspace(int L, int N, int D, int K,
                                                  int S, int M, int sms) {
  if (L < 1 || N < 1 || D < 1 || K < 1 || S < 1 || M < 1 || sms < 1 ||
      D > kMaxD || (long long)S * K > 0x7fffffffLL)
    return 0;
  const Layout g = layout_of(L, N, K, S, M, sms);
  return (long long)L * (g.n_sr + g.n_ur) * N * K;
}

// Launches the tiled eval and its sum on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take (a
// workspace size other than pathwise_tiled_fwd_workspace's for `device`'s
// SM count, shared memory above the opt-in limit, a grid past its limit).
// Operands as in pathwise_fwd; out is (L, N, K) and every entry of it is
// written.
extern "C" int pathwise_tiled_fwd(
    const float* x, long long x_ls, const float* omega, long long om_ls,
    const float* phase, long long ph_ls, const float* w, long long w_ls,
    const float* z, long long z_ls, const float* nu, long long nu_ls,
    const float* ls, long long ls_ls, const float* var, long long var_ls,
    float* workspace, long long ws_floats, float* out, int L, int N, int D,
    int K, int S, int M, int device, void* stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long need = pathwise_tiled_fwd_workspace(L, N, D, K, S, M, sms);
  if (need == 0 || ws_floats != need) return (int)cudaErrorInvalidValue;
  const Layout g = layout_of(L, N, K, S, M, sms);
  const long long blocks =
      (long long)L * g.n_rt * g.n_kc * (g.n_sr + g.n_ur);
  const long long sum_blocks = ((long long)L * N * K + kLanes - 1) / kLanes;
  if (blocks > 0x7fffffffLL || sum_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)smem_floats(D, g.sgp);
  if (smem > 48 * 1024) {
    int optin = 0;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(pathwise_tiled_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }

  FwdArgs a;
  a.x = x; a.omega = omega; a.phase = phase; a.w = w; a.z = z; a.nu = nu;
  a.ls = ls; a.var = var;
  a.x_ls = x_ls; a.om_ls = om_ls; a.ph_ls = ph_ls; a.w_ls = w_ls;
  a.z_ls = z_ls; a.nu_ls = nu_ls; a.ls_ls = ls_ls; a.var_ls = var_ls;
  a.part = workspace; a.out = out;
  a.L = L; a.N = N; a.D = D; a.K = K; a.S = S; a.M = M;
  a.n_rt = g.n_rt; a.n_kc = g.n_kc; a.n_sr = g.n_sr;
  a.n_slots = g.n_sr + g.n_ur; a.span = g.span; a.sgp = g.sgp;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pathwise_tiled_fwd_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pathwise_tiled_fwd_sum_kernel<<<(unsigned)sum_blocks, kSumThreads, 0, s>>>(
      a);
  return (int)cudaGetLastError();
}
