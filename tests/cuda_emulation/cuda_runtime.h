// CPU emulation of the CUDA features that the port's grid-tiled DF
// kernels (vae_gp_ode_tpu_torch/csrc/df_pathwise_tiled_*.cu), its RBF
// per-step kernels (pathwise_fwd.cu, pathwise_tiled_bwd.cu) and its DF
// cluster kernels (df_pathwise_fwd.cu, df_flow_fused_bwd.cu) use, so that
// their source runs on the CPU under g++ (tests/test_torch_cuda_emulated.py,
// ..._rbf.py, ..._df*.py, ..._flow.py): one std::thread per CUDA thread,
// __syncthreads a std::barrier of the block, warp shuffles an exchange
// through memory and one barrier of the warp (two exchange buffers, taken
// in turns, so a lane cannot overwrite a value another lane has yet to
// read: writing a buffer again takes the next shuffle's barrier, which
// every lane passes only after its read). __shared__ variables are
// function statics, shared by the block's threads, so a launch written
// `kernel<<<blocks, threads, smem, stream>>>(args)` (rewritten by the tests
// to emu_launch_smem(kernel, blocks, threads, smem, args)) runs its blocks
// one after another, on one set of threads that the launch starts once
// (emu_run; starting threads for every block took most of the tests'
// time). The dynamic shared memory of a block (`extern
// __shared__ float smem[]`, rewritten by the tests to a pointer to
// emu_dyn_smem) is a fresh buffer filled with NaN, so a read of an entry no
// thread wrote shows in the results. A launch through cudaLaunchKernelEx
// with a cluster dimension runs the blocks of each cluster together, with a
// barrier of all their threads for the cluster's sync and each block's
// dynamic shared memory readable by the others (cooperative_groups.h of
// this directory); the asynchronous copies of cuda_pipeline.h are plain
// copies. Only 1-D grids, 1-D clusters and blocks of whole warps are
// emulated.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <limits>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

struct emu_idx {
  unsigned x, y, z;
};
inline thread_local emu_idx threadIdx;
inline thread_local emu_idx blockIdx;
inline emu_idx blockDim;

struct alignas(8) float2 {
  float x, y;
};

struct alignas(16) float4 {
  float x, y, z, w;
};

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// An H100's SM count and opt-in limit of shared memory per block; a test
// may lower the limit (emu_set_optin) to reach a kernel's path for blocks
// that do not fit it at a small shape.
enum {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97
};
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int emu_optin = 232448;
extern "C" void emu_set_optin(int bytes) { emu_optin = bytes; }
inline cudaError_t cudaDeviceGetAttribute(int* value, int attr, int) {
  *value = attr == cudaDevAttrMultiProcessorCount ? 132 : emu_optin;
  return cudaSuccess;
}
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }

using std::max;
using std::min;

template <class T>
inline T __ldg(const T* p) { return *p; }

// What the threads of one block share.
struct emu_block_state {
  std::barrier<> barrier;
  std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
  float exchange[2][64][32];
  std::vector<float> dyn;
  emu_block_state(unsigned threads, size_t smem)
      : barrier(threads),
        dyn(smem / sizeof(float) + 1,
            std::numeric_limits<float>::quiet_NaN()) {
    for (unsigned w = 0; w < threads / 32; ++w)
      warp_barriers.emplace_back(new std::barrier<>(32));
  }
};

inline thread_local emu_block_state* emu_block;
#define emu_dyn_smem (emu_block->dyn.data())

inline void __syncthreads() { emu_block->barrier.arrive_and_wait(); }

// This thread's shuffles so far: the lanes of a warp make the same
// number, so they agree on the exchange buffer of each.
inline thread_local unsigned emu_shuffles;

// The value of lane `src` of this thread's warp (its own for src out of
// range); every lane of the warp must call it.
inline float emu_shfl(float v, int src) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* x = emu_block->exchange[emu_shuffles++ & 1][warp];
  x[lane] = v;
  emu_block->warp_barriers[warp]->arrive_and_wait();
  return src >= 0 && src < 32 ? x[src] : v;
}

inline float __shfl_down_sync(unsigned, float v, int off) {
  const int lane = threadIdx.x & 31;
  return emu_shfl(v, lane + off < 32 ? lane + off : lane);
}

inline float __shfl_xor_sync(unsigned, float v, int off) {
  return emu_shfl(v, (int)(threadIdx.x & 31) ^ off);
}

// Runs body(t, g) on `threads` threads t for each group g in order, the
// threads started once: setup(g) on thread 0 before group g, a barrier of
// all the threads around each group.
template <class Setup, class Body>
void emu_run(unsigned threads, unsigned groups, Setup setup, Body body) {
  std::barrier<> gate(threads);
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      for (unsigned g = 0; g < groups; ++g) {
        if (t == 0) setup(g);
        gate.arrive_and_wait();
        body(t, g);
        gate.arrive_and_wait();
      }
    });
  for (auto& th : pool) th.join();
}

template <class K, class... A>
void emu_launch_smem(K kernel, unsigned blocks, unsigned threads,
                     size_t smem, A... args) {
  blockDim = {threads, 1, 1};
  std::unique_ptr<emu_block_state> block;
  emu_run(
      threads, blocks,
      [&](unsigned) { block.reset(new emu_block_state(threads, smem)); },
      [&](unsigned t, unsigned b) {
        emu_block = block.get();
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        kernel(args...);
      });
}

// -- cluster launches -----------------------------------------------------

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};

enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

// What the threads of one cluster share: a barrier of all of them and
// its blocks' states, by rank.
struct emu_cluster_state {
  std::barrier<> barrier;
  std::vector<emu_block_state*> blocks;
  explicit emu_cluster_state(unsigned threads) : barrier(threads) {}
};
inline thread_local emu_cluster_state* emu_cluster;
inline thread_local unsigned emu_cluster_rank;

template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(Exp...), Act&&... args) {
  unsigned C = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      C = cfg->attrs[i].val.clusterDim.x;
  const unsigned threads = cfg->blockDim.x, blocks = cfg->gridDim.x;
  if (C < 1 || blocks % C) return cudaErrorInvalidValue;
  blockDim = {threads, 1, 1};
  std::vector<std::unique_ptr<emu_block_state>> owned;
  std::unique_ptr<emu_cluster_state> cluster;
  emu_run(
      C * threads, blocks / C,
      [&](unsigned) {
        owned.clear();
        cluster.reset(new emu_cluster_state(C * threads));
        for (unsigned r = 0; r < C; ++r) {
          owned.emplace_back(
              new emu_block_state(threads, cfg->dynamicSmemBytes));
          cluster->blocks.push_back(owned.back().get());
        }
      },
      [&](unsigned i, unsigned c) {
        const unsigned r = i / threads;
        emu_block = cluster->blocks[r];
        emu_cluster = cluster.get();
        emu_cluster_rank = r;
        threadIdx = {i % threads, 0, 0};
        blockIdx = {c * C + r, 0, 0};
        kernel(args...);
      });
  return cudaSuccess;
}
