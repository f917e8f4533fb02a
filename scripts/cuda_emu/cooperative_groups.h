// The cooperative-groups grid barrier of the CPU stand-in (cuda_runtime.h).
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {
struct grid_group {
  void sync() { emu_grid_bar->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
