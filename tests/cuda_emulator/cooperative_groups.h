// CPU stand-in for the cluster group of cooperative_groups (see cuda_runtime.h).
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  void sync() { emu_block->cluster->bar->arrive_and_wait(); }
  template <typename T>
  T* map_shared_rank(T* p, int r) {
    const ptrdiff_t off = reinterpret_cast<unsigned char*>(p) - emu_block->smem.data();
    return reinterpret_cast<T*>(emu_block->cluster->blocks[r]->smem.data() + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
