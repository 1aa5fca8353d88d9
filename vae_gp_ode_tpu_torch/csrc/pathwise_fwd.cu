// Per-step pathwise evaluation of the dimwise-RBF GP sample, one launch for
// all L Monte-Carlo draws.
//
// Replaces the Pallas kernel `_pathwise_kernel` of
// vae_gp_ode_tpu/ops/pathwise.py (called through `fused_pathwise_eval`). It
// computes what `pathwise_eval_reference` computes, per draw l, batch row n
// and output dim k:
//
//   f_k(x) = sqrt(var_k / S) sum_s cos(x . omega[:, s, k] + phase[s, k]) w[s, k]
//          + var_k sum_m exp(-0.5 sum_d ((x_d - Z[m, d]) / ls[k, d])^2) nu[k, m]
//
// on the operands' own layouts: x (N, D), omega (D, S, K), phase (1, S, K),
// weights (S, K), Z (M, D), nu (K, M), ls (K, D), var (K,), each either per
// draw (element stride `*_ls` between draws) or shared by all draws (stride
// 0). Output (L, N, K). The squared distance is summed over (x - Z) / ls
// directly rather than expanded into norms and a cross term, which avoids
// the cancellation of the expanded form.
//
// What bounds it on an H100. At the main path's shapes (L=5, N=20, D=K=6,
// S=256, M=100) a launch is ~2.3 MFLOP and 0.15 M cosf on 0.2 MB, at the
// wide ones (D=K=12, S=1024) ~37 MFLOP and 1.2 M cosf on 3.4 MB: about a
// microsecond of the card's f32 issue rate or memory time. A launch is
// bound by latency instead: the device time of an empty kernel
// (`pathwise_fwd_empty`, ~0.9 us), one round trip to memory, a block's
// barriers and its reduction; at the wide shapes also by the SMs'
// issue rate for the cosf of all (row, item, output dim) triples.
//
// Design. Each output (l, n, k) is a sum over S features and M inducing
// points, one list of S + M items. A cluster of C thread blocks takes one
// (draw, tile of rb rows, chunk of Kc <= 12 output dims); its blocks
// share out the items in contiguous ranges and sum their partials
// through distributed shared memory (a cluster barrier, a read of every
// block's sums in rank order, a second barrier). Within a block each
// warp takes one output dim and 32 items, each thread all rows of the
// tile (staged in shared memory, read as float4 broadcasts): one cosf or
// expf per (row, item); then each warp sums its rows by a transpose
// across its lanes (R - 1 + log2(32 / R) shuffles for R rows) and a
// thread per (row, output dim) adds its warps in a fixed order. Two ways
// to feed a block:
//  - staged (a long item list, clusters of 8 at the wide shapes): the
//    block copies its items round by round into shared memory with
//    cp.async, every round the ring holds in flight before the first is
//    computed; omega's, phase's and w's columns of the chunk's output
//    dims go out as consecutive threads on consecutive addresses (omega
//    read once per (draw, row tile), coalesced), nu and the points' Z
//    rows likewise, stored with an odd stride so that the compute threads
//    read them without bank conflicts;
//  - direct (a short list at up to 4 rows per block, the main widths:
//    clusters of one block, which skip the cluster barriers that cost
//    ~1.5 us): one round of items, each thread loading its own item's
//    operands into registers beside the block's staging of the rows, one
//    barrier before it computes.
// The plan (plan_for) is fitted to rbf_pathwise_probe.py's sweep. No
// atomics: two launches on the same inputs give the same bits. Any L, N,
// D, K, S and M is taken; shared memory past 48 KB is asked for up to the
// device's opt-in limit (pathwise_fwd_smem_bytes exports the need).
//
// The design it replaced: a 128-thread block per (draw, output dim k,
// tile of 4 rows) that read omega's column k, K floats apart, once per
// row tile, Z with a stride of D, and summed each row by its own
// five-step shuffle per warp.
//
// Accuracy. Accurate cosf/expf, no fast-math (arguments x . omega can be
// large, where __cosf loses accuracy). Everything is f32, no TF32.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxKc = 12;          // output dims per cluster
constexpr int kThreads = 384;       // threads per block, at most
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kStageFloats = 8192;  // one round's staged items, at most
constexpr int kRingFloats = 32768;  // the rounds staged ahead, at most
constexpr int kMaxD = 16;           // an item's operands in registers

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
  float* out;          // (L, N, K)
  int N, D, K, S, M;
  int rb, n_rt, Kc, Kp, n_kc, SP, C, P, nbuf;
};

int instance_rows(int rb) { return rb <= 4 ? 4 : 8; }

// How a launch splits the work: rows per block rb (also the instance R),
// output dims per cluster Kc (stored Kp apart, Kp odd), items per round SP
// (threads Kc * SP), blocks per cluster C, items per block P.
struct Plan {
  int rb, n_rt, Kc, Kp, n_kc, SP, C, P, nbuf, threads;
  bool direct;
  long long groups;
  long long smem_floats;
};

// Floats of one round's staging: omega's D rows, phase and w (or nu) of
// SP items x Kp output dims, and the Z rows of SP points, [d][slot].
__host__ __device__ inline long long stage_floats(int D, int SP, int Kp) {
  return (long long)(D + 2) * SP * Kp + (long long)D * (SP + 1);
}

// Output dims per cluster Kc = ceil(K / n_kc) and items per round SP
// (threads Kc * SP); staged, fewer of both where a round would not fit
// the staging budget.
void set_chunks(Plan& p, int D, int K, int n_kc, bool staged) {
  for (p.n_kc = n_kc;; ++p.n_kc) {
    p.Kc = (K + p.n_kc - 1) / p.n_kc;
    p.Kp = p.Kc | 1;
    if (!staged || stage_floats(D, 32, p.Kp) <= kStageFloats || p.Kc == 1)
      break;
  }
  p.n_kc = (K + p.Kc - 1) / p.Kc;
  p.SP = 32 * (kThreads / (32 * p.Kc) > 1 ? kThreads / (32 * p.Kc) : 1);
  while (staged && p.SP > 32 && stage_floats(D, p.SP, p.Kp) > kStageFloats)
    p.SP -= 32;
  p.threads = p.Kc * p.SP;
}

// The launch's plan, fitted to the sweep of rbf_pathwise_probe.py on an
// H100 (PERF.md section 6). A cluster costs ~1.5 us of barriers, so a
// short item list (S + M <= 768) takes clusters of one block, 4 rows per
// block (8 past 100 rows in all) and the fewest output-dim chunks that
// put its items in one round (a block that loads its own: `direct`), as
// long as the chunks give at most two blocks per SM (or are two). A long
// list takes clusters of 8, 4 rows per block (8 where that still gives
// more than 1.4 blocks per SM) and the fewest output-dim chunks that give
// 0.9 of the SMs a block.
Plan plan_for(int L, int N, int D, int K, int S, int M, int sms) {
  Plan p;
  const long long items = (long long)S + M;
  const long long tiles4 = (long long)L * ((N + 3) / 4);
  int n_kc = (K + kMaxKc - 1) / kMaxKc, rb = 4, C = 1;
  if (items <= 2 * kThreads) {
    rb = (long long)L * N <= 100 ? 4 : 8;
    const long long tiles = (long long)L * ((N + rb - 1) / rb);
    const long long cap = 2LL * sms / tiles > 2 ? 2LL * sms / tiles : 2;
    for (; n_kc < K && n_kc < cap; ++n_kc) {
      set_chunks(p, D, K, n_kc, false);
      if (items <= p.SP) break;
    }
  } else {
    C = kMaxCluster;
    while (n_kc < K && tiles4 * n_kc * C * 10 < 9LL * sms) ++n_kc;
    if (tiles4 * n_kc * C * 5 > 7LL * sms) rb = 8;
  }
  auto split = [&](bool staged) {
    set_chunks(p, D, K, n_kc, staged);
    p.rb = rb < N ? rb : N;
    p.n_rt = (N + p.rb - 1) / p.rb;
    p.groups = (long long)L * p.n_rt * p.n_kc;
    // no more blocks per cluster than rounds of items
    const long long c_max = (items + p.SP - 1) / p.SP;
    p.C = (int)(C < c_max ? C : c_max);
    p.P = (int)((items + p.C - 1) / p.C);
    return (p.P + p.SP - 1) / p.SP;
  };
  // a block of one round and at most 4 rows loads its own items (the
  // only `direct` instance; with more rows its registers would spill);
  // otherwise the rounds staged ahead are all that the ring holds
  int rounds = split(false);
  p.direct = p.C == 1 && rounds == 1 && p.rb <= 4;
  if (!p.direct) rounds = split(true);
  const long long fit = kRingFloats / stage_floats(D, p.SP, p.Kp);
  p.nbuf = p.direct ? 0 : rounds < fit ? rounds : fit > 1 ? (int)fit : 1;
  const int R = instance_rows(p.rb);
  p.smem_floats = (long long)D * R + (long long)D * p.Kc +
                  (long long)(p.threads / 32) * R + (long long)R * p.Kc +
                  p.nbuf * stage_floats(D, p.SP, p.Kp);
  return p;
}

// The sums over the warp's lanes of v[0] .. v[R - 1]: lane t returns the
// sum of v[t / (32 / R)]. The first steps swap half of the values with the
// partner lane, the last ones add what the lanes of one row hold.
template <int R>
__device__ __forceinline__ float transpose_sum(float (&v)[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = R / 2, off = 16; n >= 1; n >>= 1, off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = upper ? v[i] : v[i + n];
      const float keep = upper ? v[i + n] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (int off = 16 / R; off >= 1; off >>= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  return v[0];
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}

// R rows per block (the tile's rb). Direct: a block of one round of items
// (nbuf = 0) whose threads load their item's operands into registers
// instead of staging them.
template <int R, bool Direct>
__global__ void __launch_bounds__(kThreads) pathwise_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const int C = a.C;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  int grp = (int)blockIdx.x / C;   // the launcher keeps blocks < 2^31
  const int rt = grp % a.n_rt;
  grp /= a.n_rt;
  const int kc = grp % a.n_kc;
  const long long l = grp / a.n_kc;
  const int D = a.D, K = a.K, S = a.S, M = a.M, N = a.N;
  const int Kc = a.Kc, Kp = a.Kp, SP = a.SP;
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  const int r0 = rt * a.rb, rows = min(a.rb, N - r0);
  const int k0 = kc * Kc, nk = min(Kc, K - k0);
  const int items = S + M;
  const int i0 = min(rank * a.P, items), i1 = min(items, i0 + a.P);
  const int rounds = (i1 - i0 + SP - 1) / SP;
  const long long SK = (long long)S * K;
  const long long stage = stage_floats(D, SP, Kp);

  float* xs = smem;                  // D * R       rows, [d][r]
  float* ils = xs + D * R;           // D * Kc      1 / ls, [d][k]
  float* red = ils + D * Kc;         // T / 32 * R  the warps' row sums
  float* part = red + T / 32 * R;    // R * Kc      the block's sums, [r][k]
  float* bufs = part + R * Kc;       // nbuf * stage

  const float* x = a.x + l * a.x_ls + (long long)r0 * D;
  const float* omega = a.omega + l * a.om_ls;
  const float* phase = a.phase + l * a.ph_ls;
  const float* w = a.w + l * a.w_ls;
  const float* z = a.z + l * a.z_ls;
  const float* nu = a.nu + l * a.nu_ls;
  const float* ls = a.ls + l * a.ls_ls;

  // compute role: warp-aligned, output dim kk, item slot sl
  const int kk = tid / SP, sl = tid - kk * SP;
  const int k = k0 + min(kk, nk - 1);
  const float vk = a.var[l * a.var_ls + k];
  const float ck = sqrtf(vk / (float)S);
  // staging role: consecutive threads on consecutive (item, output dim)
  const int ssl = tid / Kc, skq = tid - ssl * Kc;

  // round q's items i0 + q SP ... into buf: omega [d][slot][k], phase and
  // w (nu for a point) [slot][k], Z [d][slot]
  auto stage_round = [&](int q, float* buf) {
    const int base = i0 + q * SP;
    float* om = buf;
    float* ph = om + (long long)D * SP * Kp;
    float* ws = ph + SP * Kp;
    float* zs = ws + SP * Kp;
    const int i = base + ssl, so = ssl * Kp + skq;
    if (i < i1 && skq < nk) {
      if (i < S) {
        const long long col = (long long)i * K + k0 + skq;
        for (int d = 0; d < D; ++d)
          copy4(om + (long long)d * SP * Kp + so, omega + d * SK + col);
        copy4(ph + so, phase + col);
        copy4(ws + so, w + col);
      } else {
        copy4(ws + so, nu + (long long)(k0 + skq) * M + (i - S));
      }
    }
    const int plo = max(S - base, 0), phi = min(i1 - base, SP);
    for (int e = tid; e < (phi - plo) * D; e += T) {
      const int p = e / D, d = e - p * D;
      copy4(zs + d * (SP + 1) + plo + p,
            z + (long long)(base + plo + p - S) * D + d);
    }
  };

  // Direct: the thread's item, omega's column and phase (a feature) or Z's
  // row (a point; dv holds their first kMaxD entries), and its coefficient
  float dv[Direct ? kMaxD : 1], dph = 0.f, dcoef = 0.f;
  const long long col = (long long)(i0 + sl) * K + k;        // a feature's
  const float* zrow = z + (long long)max(i0 + sl - S, 0) * D;  // a point's
  if (Direct && kk < nk && i0 + sl < i1) {
    const int i = i0 + sl;
    if (i < S) {
#pragma unroll
      for (int d = 0; d < (Direct ? kMaxD : 0); ++d)
        if (d < D) dv[d] = __ldg(omega + d * SK + col);
      dph = __ldg(phase + col);
      dcoef = ck * __ldg(w + col);
    } else {
#pragma unroll
      for (int d = 0; d < (Direct ? kMaxD : 0); ++d)
        if (d < D) dv[d] = __ldg(zrow + d);
      dcoef = vk * __ldg(nu + (long long)k * M + (i - S));
    }
  }
  // rounds 0 .. nbuf - 2 in flight before the first is computed
  const int nb = Direct ? 1 : a.nbuf;
  for (int q = 0; q < min(nb - 1, rounds); ++q) {
    stage_round(q, bufs + q * stage);
    __pipeline_commit();
  }
  // rows past N evaluate zeros and are never written
  for (int e = tid; e < D * R; e += T) {
    const int d = e / R, r = e - d * R;
    xs[e] = r < rows ? x[(long long)r * D + d] : 0.f;
  }
  for (int e = tid; e < D * Kc; e += T) {
    const int d = e / Kc, q = e - d * Kc;
    ils[e] = q < nk ? 1.f / ls[(long long)(k0 + q) * D + d] : 0.f;
  }

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int q = 0; q < rounds; ++q) {
    const float* buf = bufs + (q % nb) * stage;
    if (!Direct && q + nb - 1 < rounds)
      stage_round(q + nb - 1, bufs + ((q + nb - 1) % nb) * stage);
    if (!Direct) {
      __pipeline_commit();
      __pipeline_wait_prior(nb - 1);
    }
    __syncthreads();   // the round's items (and the rows) are in place
    const int i = i0 + q * SP + sl;
    const float* om = buf;
    const float* ph = om + (long long)D * SP * Kp;
    const float* ws = ph + SP * Kp;
    const float* zs = ws + SP * Kp;
    // u[r] += x[r, d] o (a feature) or ((x[r, d] - o) il)^2 (a point)
    float u[R];
    auto add_d = [&](int d, float o, float il, bool point) {
#pragma unroll
      for (int h = 0; h < R / 4; ++h) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + d * R + 4 * h);
        if (point) {
          const float e0 = (xv.x - o) * il, e1 = (xv.y - o) * il;
          const float e2 = (xv.z - o) * il, e3 = (xv.w - o) * il;
          u[4 * h] = fmaf(e0, e0, u[4 * h]);
          u[4 * h + 1] = fmaf(e1, e1, u[4 * h + 1]);
          u[4 * h + 2] = fmaf(e2, e2, u[4 * h + 2]);
          u[4 * h + 3] = fmaf(e3, e3, u[4 * h + 3]);
        } else {
          u[4 * h] = fmaf(xv.x, o, u[4 * h]);
          u[4 * h + 1] = fmaf(xv.y, o, u[4 * h + 1]);
          u[4 * h + 2] = fmaf(xv.z, o, u[4 * h + 2]);
          u[4 * h + 3] = fmaf(xv.w, o, u[4 * h + 3]);
        }
      }
    };
    if (kk < nk && i < i1) {
      if (i < S) {
        const float p0 = Direct ? dph : ph[sl * Kp + kk];
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = p0;
        if (Direct) {
#pragma unroll
          for (int d = 0; d < (Direct ? kMaxD : 0); ++d)
            if (d < D) add_d(d, dv[d], 0.f, false);
          for (int d = kMaxD; d < D; ++d)
            add_d(d, __ldg(omega + d * SK + col), 0.f, false);
        } else {
          for (int d = 0; d < D; ++d)
            add_d(d, om[((long long)d * SP + sl) * Kp + kk], 0.f, false);
        }
        const float coef = Direct ? dcoef : ck * ws[sl * Kp + kk];
        // every row (rows past the tile's are zeros, never written), so
        // that the R cosf chains interleave
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(coef, cosf(u[r]), acc[r]);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = 0.f;
        if (Direct) {
#pragma unroll
          for (int d = 0; d < (Direct ? kMaxD : 0); ++d)
            if (d < D) add_d(d, dv[d], ils[d * Kc + kk], true);
          for (int d = kMaxD; d < D; ++d)
            add_d(d, __ldg(zrow + d), ils[d * Kc + kk], true);
        } else {
          for (int d = 0; d < D; ++d)
            add_d(d, zs[d * (SP + 1) + sl], ils[d * Kc + kk], true);
        }
        const float coef = Direct ? dcoef : vk * ws[sl * Kp + kk];
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = fmaf(coef, expf(-0.5f * u[r]), acc[r]);
      }
    }
    // the buffer is refilled in the next round if the ring is short
    if (q + nb < rounds) __syncthreads();
  }

  // the warp's row sums, then the block's per (row, output dim): a warp
  // holds one output dim, SP / 32 warps each
  const float v = transpose_sum<R>(acc);
  if ((lane & (32 / R - 1)) == 0) red[(tid >> 5) * R + lane / (32 / R)] = v;
  __syncthreads();
  const int wpk = SP / 32;
  float s = 0.f;
  if (tid < R * Kc)
    for (int j = 0; j < wpk; ++j)
      s += red[((tid % Kc) * wpk + j) * R + tid / Kc];
  if (C == 1) {   // a cluster of one block: its sums are the outputs
    const int r = tid / Kc, q = tid - r * Kc;
    if (tid < R * Kc && r < rows && q < nk)
      a.out[(l * N + r0 + r) * K + k0 + q] = s;
    return;
  }
  // each block sums every C-th output over the cluster's blocks, in rank
  // order, from their shared memory
  if (tid < R * Kc) part[tid] = s;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int o = rank + tid * C;
  if (o < R * Kc) {
    const int r = o / Kc, q = o - r * Kc;
    if (r < rows && q < nk) {
      float t = 0.f;   // the loads of all ranks go out together
#pragma unroll
      for (int p = 0; p < kMaxCluster; ++p)
        if (p < C) t += cluster.map_shared_rank(part, p)[o];
      a.out[(l * N + r0 + r) * K + k0 + q] = t;
    }
  }
  cluster.sync();   // no block leaves while another reads its sums
}

// An empty kernel: its device time per launch is the floor under every
// kernel's time on the card.
__global__ void empty_kernel() {}

}  // namespace

// Bytes of dynamic shared memory a block needs for these shapes on a card
// with `sms` SMs.
extern "C" long long pathwise_fwd_smem_bytes(int L, int N, int D, int K,
                                             int S, int M, int sms) {
  if (L < 1 || N < 1 || D < 1 || K < 1 || S < 1 || M < 1 || sms < 1)
    return 0;
  return (long long)sizeof(float) * plan_for(L, N, D, K, S, M, sms)
                                        .smem_floats;
}

// Launches the empty kernel, one warp, on `stream`.
extern "C" int pathwise_fwd_empty(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// Launches the per-step eval on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes it does not take (a grid past its limit,
// or shared memory above the device's opt-in limit). Operands are f32 and
// contiguous; each `*_ls` is the element stride between draws (0 for an
// operand that all draws share). out is (L, N, K); every entry is written.
extern "C" int pathwise_fwd(
    const float* x, long long x_ls, const float* omega, long long om_ls,
    const float* phase, long long ph_ls, const float* w, long long w_ls,
    const float* z, long long z_ls, const float* nu, long long nu_ls,
    const float* ls, long long ls_ls, const float* var, long long var_ls,
    float* out, int L, int N, int D, int K, int S, int M, int device,
    void* stream) {
  if (L < 1 || N < 1 || D < 1 || K < 1 || S < 1 || M < 1 ||
      (long long)S * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan_for(L, N, D, K, S, M, sms);
  const long long blocks = p.groups * p.C;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int R = instance_rows(p.rb);
  void (*kernel)(FwdArgs) = p.direct ? pathwise_fwd_kernel<4, true>
                            : R == 4 ? pathwise_fwd_kernel<4, false>
                                     : pathwise_fwd_kernel<8, false>;
  const size_t smem = sizeof(float) * (size_t)p.smem_floats;
  if (smem > 48 * 1024) {
    int optin = 0;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }

  FwdArgs a;
  a.x = x; a.omega = omega; a.phase = phase; a.w = w; a.z = z; a.nu = nu;
  a.ls = ls; a.var = var;
  a.x_ls = x_ls; a.om_ls = om_ls; a.ph_ls = ph_ls; a.w_ls = w_ls;
  a.z_ls = z_ls; a.nu_ls = nu_ls; a.ls_ls = ls_ls; a.var_ls = var_ls;
  a.out = out;
  a.N = N; a.D = D; a.K = K; a.S = S; a.M = M;
  a.rb = p.rb; a.n_rt = p.n_rt; a.Kc = p.Kc; a.Kp = p.Kp; a.n_kc = p.n_kc;
  a.SP = p.SP; a.C = p.C; a.P = p.P; a.nbuf = p.nbuf;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)p.threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
