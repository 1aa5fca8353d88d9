// CPU emulation of the CUDA features that the port's grid-tiled DF
// kernels (vae_gp_ode_tpu_torch/csrc/df_pathwise_tiled_*.cu) use, so that
// their source runs on the CPU under g++ (tests/test_torch_cuda_emulated.py):
// one std::thread per CUDA thread, the blocks of a launch one after another,
// __syncthreads a std::barrier of the block, warp shuffles an exchange
// through memory between two barriers of the warp. __shared__ variables are
// function statics, shared by the block's threads. Launches written
// `kernel<<<blocks, threads, smem, stream>>>(args)` are rewritten to
// emu_launch(kernel, blocks, threads, args) by the test. Only 1-D grids and
// blocks of whole warps are emulated.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
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

struct alignas(16) float4 {
  float x, y, z, w;
};

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

using std::max;
using std::min;

template <class T>
inline T __ldg(const T* p) { return *p; }

inline std::barrier<>* emu_block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline float emu_exchange[64][32];

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

// The value of lane `src` of this thread's warp (its own for src out of
// range); every lane of the warp must call it.
inline float emu_shfl(float v, int src) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  emu_exchange[warp][lane] = v;
  emu_warp_barriers[warp]->arrive_and_wait();
  const float r = src >= 0 && src < 32 ? emu_exchange[warp][src] : v;
  emu_warp_barriers[warp]->arrive_and_wait();
  return r;
}

inline float __shfl_down_sync(unsigned, float v, int off) {
  const int lane = threadIdx.x & 31;
  return emu_shfl(v, lane + off < 32 ? lane + off : lane);
}

inline float __shfl_xor_sync(unsigned, float v, int off) {
  return emu_shfl(v, (int)(threadIdx.x & 31) ^ off);
}

template <class K, class A>
void emu_launch(K kernel, unsigned blocks, unsigned threads, A args) {
  blockDim = {threads, 1, 1};
  for (unsigned b = 0; b < blocks; ++b) {
    std::barrier<> block_barrier(threads);
    emu_block_barrier = &block_barrier;
    emu_warp_barriers.clear();
    for (unsigned w = 0; w < threads / 32; ++w)
      emu_warp_barriers.emplace_back(new std::barrier<>(32));
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < threads; ++t)
      pool.emplace_back([=] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        kernel(args);
      });
    for (auto& th : pool) th.join();
  }
}
