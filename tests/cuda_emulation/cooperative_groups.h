// CPU emulation of the thread-block cluster of cooperative_groups that the
// port's kernels use (see cuda_runtime.h of this directory): the rank of
// the block, the cluster's barrier and a pointer into another block's
// dynamic shared memory.
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  unsigned block_rank() const { return emu_cluster_rank; }
  void sync() const { emu_cluster->barrier.arrive_and_wait(); }
  // p lies in this block's dynamic shared memory; the same entry of block
  // `rank`'s
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    const std::ptrdiff_t off = reinterpret_cast<float*>(p) - emu_dyn_smem;
    return reinterpret_cast<T*>(emu_cluster->blocks[rank]->dyn.data() + off);
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
