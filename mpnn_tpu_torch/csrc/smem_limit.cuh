// A kernel's dynamic shared-memory limit, raised once for every host
// thread (the edge-MLP chain and SDDMM kernels' launchers).
//
// cudaFuncAttributeMaxDynamicSharedMemorySize belongs to the kernel, not
// to the host thread that sets it: autograd launches a backward from its
// own thread while the main thread launches forwards (and measurements
// launch backwards too). A cache of the set sizes per host thread lets
// one thread lower the limit below the size another thread's cache says
// is set, and that thread's next launch fails with "invalid argument".
// Here the limit only ever grows, to the largest size any launch has
// asked for, under one lock, so no launch lowers it below a size another
// relies on; the runtime call runs only when the limit grows (it costs
// more than the launch).

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace mpnn_smem {

// Raise `kernel`'s dynamic shared-memory limit on the current device to at
// least `bytes`. One table per kernel signature (a function template's
// statics), at most 64 (kernel, device) pairs each; past that the
// attribute is set on every call.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  static std::mutex mu;
  static const void* fns[64];
  static int devs[64], sizes[64], n = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < n && !(fns[i] == (const void*)kernel && devs[i] == dev)) ++i;
  if (i < n && sizes[i] >= int(bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess || i == 64) return err;
  fns[i] = (const void*)kernel;
  devs[i] = dev;
  sizes[i] = int(bytes);
  n += i == n;
  return err;
}

}  // namespace mpnn_smem
