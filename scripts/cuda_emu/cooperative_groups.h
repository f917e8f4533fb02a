// The cooperative-groups grid barrier and thread-block clusters of the CPU
// stand-in (cuda_runtime.h).
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {
struct grid_group {
  void sync() { emu_grid_bar->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }

struct cluster_group {
  unsigned block_rank() const { return blockIdx.x % emu_cluster; }
  unsigned num_blocks() const { return emu_cluster; }
  void sync() const { emu_cluster_bar->arrive_and_wait(); }
  // the same shared-memory offset in block `rank` of the cluster
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    const char* base = reinterpret_cast<const char*>(emu_block->smem.data());
    const size_t off = reinterpret_cast<const char*>(p) - base;
    if (rank >= emu_cluster || off >= emu_block->smem.size() * sizeof(float)) {
      std::fprintf(stderr, "map_shared_rank: rank %u of %u, offset %zu "
                   "outside the block's shared memory\n", rank, emu_cluster,
                   off);
      std::abort();
    }
    EmuBlock& peer = emu_blocks[blockIdx.x - blockIdx.x % emu_cluster + rank];
    return reinterpret_cast<T*>(
        reinterpret_cast<char*>(peer.smem.data()) + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
