// CPU emulation of the asynchronous copies of cuda_pipeline.h that the
// port's kernels use (see cuda_runtime.h of this directory): each copy is
// done when it is issued, so committing and waiting do nothing.
#pragma once

#include <cstring>

#include "cuda_runtime.h"

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
