// A CPU stand-in for the CUDA runtime pieces the port's kernels use, so a
// kernel's logic can be run on a machine without nvcc or a card: one
// std::thread per CUDA thread, std::barrier for __syncthreads, __syncwarp
// and the cooperative grid.sync(), a per-warp exchange array for
// __shfl_xor_sync, and the launch's dynamic shared memory filled with NaN
// (an uninitialised read shows in the result). A cooperative launch runs
// the whole grid at once, every block resident, as the card's co-residency
// limit guarantees. Nothing here models timing, caches or memory ordering
// beyond the barriers. scripts/cuda_emu/emu.py compiles a kernel source
// against it; scripts/cuda_emu/check_att_steps.py runs two kernels with it.
// Hopper's asynchronous copies are modelled too (the set2vec kernels'
// MPNN_CUDA_EMU branch): a cp.async lands at the thread's wait, a TMA bulk
// copy at the first wait on its mbarrier — never earlier — and a bulk
// copy off the 16-byte rule aborts with a message. So are thread-block
// clusters (cudaLaunchKernelEx with a cluster dimension, the edge-MLP
// kernels' panel route): cooperative_groups::this_cluster() gives the
// block's rank, a std::barrier per cluster for cluster.sync(), and
// map_shared_rank() the same offset in a peer block's shared memory.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <type_traits>
#include <utility>
#include <vector>

#define MPNN_CUDA_EMU 1

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
using std::max;
using std::min;

struct uint3 { unsigned x, y, z; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9,
       cudaErrorCooperativeLaunchTooLarge = 720 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

struct EmuBlock {
  std::vector<float> smem;
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  float shfl[32][32];
  std::atomic<int> any{0};             // __syncthreads_or
  std::mutex named_mu;                 // named barriers (bar.sync id, n)
  std::map<int, std::unique_ptr<std::barrier<>>> named;
};
inline thread_local EmuBlock* emu_block = nullptr;
// the launch's clusters: size, the calling block's cluster barrier, and
// the grid's blocks (a peer's shared memory)
inline thread_local unsigned emu_cluster = 1;
inline thread_local std::barrier<>* emu_cluster_bar = nullptr;
inline thread_local EmuBlock* emu_blocks = nullptr;
inline std::barrier<>* emu_grid_bar = nullptr;
// the "SMs" of the emulated card, one block each: a grid of a few blocks
// exercises the kernels' block-strided loops and cross-block reductions
inline int emu_sms = 3;

// the dynamic shared memory of the calling thread's block; emu.py turns
// `extern __shared__ float x[];` into `float* x = (float*)emu_smem();`
inline void* emu_smem() { return emu_block->smem.data(); }
inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline void __syncwarp() {
  emu_block->warp_bar[threadIdx.x / 32]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_block->shfl[w][l] = v;
  __syncwarp();
  const float r = emu_block->shfl[w][l ^ off];
  __syncwarp();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu_block->shfl[w][l] = v;
  __syncwarp();
  const float r = emu_block->shfl[w][src & 31];
  __syncwarp();
  return r;
}
inline int __shfl_sync(unsigned, int v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  float f;
  std::memcpy(&f, &v, 4);
  emu_block->shfl[w][l] = f;
  __syncwarp();
  std::memcpy(&v, &emu_block->shfl[w][src & 31], 4);
  __syncwarp();
  return v;
}
inline int __shfl_up_sync(unsigned, int v, unsigned d) {
  const int l = threadIdx.x % 32;
  return __shfl_sync(0u, v, l >= int(d) ? l - int(d) : l);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(int(x)); }
// bar.sync id, n: a named barrier of n threads of the block (made at its
// first use)
inline void emu_named_sync(int id, int n) {
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> g(emu_block->named_mu);
    auto& b = emu_block->named[id];
    if (!b) b.reset(new std::barrier<>(n));
    bar = b.get();
  }
  bar->arrive_and_wait();
}
inline int __syncthreads_or(int pred) {
  if (pred) emu_block->any.store(1);
  emu_block->bar->arrive_and_wait();
  const int r = emu_block->any.load();
  emu_block->bar->arrive_and_wait();
  if (threadIdx.x == 0) emu_block->any.store(0);
  emu_block->bar->arrive_and_wait();
  return r;
}
inline int __syncthreads_count(int pred) {
  if (pred) emu_block->any.fetch_add(1);
  emu_block->bar->arrive_and_wait();
  const int r = emu_block->any.load();
  emu_block->bar->arrive_and_wait();
  if (threadIdx.x == 0) emu_block->any.store(0);
  emu_block->bar->arrive_and_wait();
  return r;
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __ldcg(const float* p) { return *p; }
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  std::memcpy(&x, &u, 4);
  return x;
}
inline float __expf(float x) { return std::exp(x); }
inline float __fdividef(float a, float b) { return a / b; }
inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}

// cp.async: the copies a thread issued land at its cp_async_wait_all
inline thread_local std::vector<std::pair<float*, const float*>> emu_cp_q;
inline void emu_cp_async4(float* d, const float* s) {
  emu_cp_q.emplace_back(d, s);
}
inline void emu_cp_async_wait_all() {
  for (auto& c : emu_cp_q) *c.first = *c.second;
  emu_cp_q.clear();
}

// mbarriers (keyed by their shared-memory address) and the TMA bulk copies
// that complete their transactions: a phase completes when every expected
// arrival has come and every expected byte has landed; the copies of a
// phase land at the first try_wait on its barrier.
struct EmuMbar {
  unsigned expected = 0, pending = 0, phase = 0;
  long long tx = 0;
  std::vector<std::pair<void*, std::vector<char>>> copies;
};
inline std::mutex emu_mbar_mu;
inline std::map<const void*, EmuMbar> emu_mbars;
inline void emu_mbar_complete(EmuMbar& m) {
  if (m.pending == 0 && m.tx == 0) {
    ++m.phase;
    m.pending = m.expected;
  }
}
inline void emu_mbar_init(void* bar, unsigned count) {
  std::lock_guard<std::mutex> g(emu_mbar_mu);
  EmuMbar& m = emu_mbars[bar];
  m = EmuMbar();
  m.expected = m.pending = count;
}
inline void emu_mbar_arrive_tx(void* bar, unsigned bytes) {
  std::lock_guard<std::mutex> g(emu_mbar_mu);
  EmuMbar& m = emu_mbars.at(bar);
  m.tx += bytes;
  --m.pending;
  emu_mbar_complete(m);
}
inline void emu_bulk_g2s(void* dst, const void* src, unsigned bytes,
                         void* bar) {
  if (reinterpret_cast<uintptr_t>(dst) % 16 ||
      reinterpret_cast<uintptr_t>(src) % 16 || bytes % 16 || !bytes) {
    std::fprintf(stderr, "cp.async.bulk: dst %p src %p bytes %u break the "
                 "16-byte rule\n", dst, src, bytes);
    std::abort();
  }
  std::lock_guard<std::mutex> g(emu_mbar_mu);
  const char* s = static_cast<const char*>(src);
  emu_mbars.at(bar).copies.emplace_back(dst,
                                        std::vector<char>(s, s + bytes));
}
inline bool emu_mbar_try_wait(void* bar, unsigned parity) {
  std::lock_guard<std::mutex> g(emu_mbar_mu);
  EmuMbar& m = emu_mbars.at(bar);
  for (auto& c : m.copies) {
    std::memcpy(c.first, c.second.data(), c.second.size());
    m.tx -= (long long)c.second.size();
    emu_mbar_complete(m);
  }
  m.copies.clear();
  return (m.phase & 1u) != parity;
}

// the cross-block words: relaxed 64-bit atomics
inline unsigned long long emu_ld_relaxed(const unsigned long long* p) {
  return __atomic_load_n(p, __ATOMIC_RELAXED);
}
inline void emu_st_relaxed(unsigned long long* p, unsigned long long v) {
  __atomic_store_n(p, v, __ATOMIC_RELAXED);
}
inline void emu_spin_pause() { std::this_thread::yield(); }

inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = emu_sms;
  return cudaSuccess;
}
template <class T>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T,
                                                                 int,
                                                                 size_t) {
  *n = 1;
  return cudaSuccess;
}
// The most dynamic shared memory a block of the card may take (H100:
// 227 KB); an attribute above it fails, as on the card. A launch fails
// above its kernel's limit: 48 KB until cudaFuncSetAttribute sets it,
// and then what was set last, lower or higher.
constexpr size_t kEmuMaxSmem = 232448;
constexpr size_t kEmuDefaultSmem = 49152;
inline cudaError_t emu_last_error = cudaSuccess;
inline std::map<const void*, size_t> emu_smem_limit;
inline size_t emu_limit_of(const void* kernel) {
  const auto it = emu_smem_limit.find(kernel);
  return it == emu_smem_limit.end() ? kEmuDefaultSmem : it->second;
}
template <class T>
inline cudaError_t cudaFuncSetAttribute(T kernel, cudaFuncAttribute,
                                        int bytes) {
  if (size_t(bytes) > kEmuMaxSmem) return cudaErrorInvalidValue;
  emu_smem_limit[(const void*)kernel] = size_t(bytes);
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_last_error;
  emu_last_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

// Run `kernel` (a __global__ function taking one argument struct by value)
// over grid × block threads, in clusters of `cluster` consecutive blocks.
template <class Args>
void emu_run(const void* kernel, void* arg, unsigned grid, unsigned block,
             size_t smem, unsigned cluster = 1) {
  auto fn = (void (*)(Args))kernel;
  Args args = *(Args*)arg;
  std::barrier<> grid_bar(grid * block);
  emu_grid_bar = &grid_bar;
  std::vector<EmuBlock> blocks(grid);
  std::vector<std::unique_ptr<std::barrier<>>> cluster_bars;
  for (unsigned c = 0; c < grid / cluster; ++c)
    cluster_bars.emplace_back(new std::barrier<>(cluster * block));
  for (auto& b : blocks) {
    b.smem.assign(smem / sizeof(float) + 1,
                  std::numeric_limits<float>::quiet_NaN());
    b.bar.reset(new std::barrier<>(block));
    for (unsigned w = 0; w < block / 32; ++w)
      b.warp_bar.emplace_back(new std::barrier<>(32));
  }
  std::vector<std::thread> threads;
  for (unsigned b = 0; b < grid; ++b)
    for (unsigned t = 0; t < block; ++t)
      threads.emplace_back([&, b, t] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        blockDim = dim3(block);
        gridDim = dim3(grid);
        emu_block = &blocks[b];
        emu_blocks = blocks.data();
        emu_cluster = cluster;
        emu_cluster_bar = cluster_bars[b / cluster].get();
        fn(args);
      });
  for (auto& t : threads) t.join();
}

// Set by the translation unit emu.py writes for each kernel source, which
// knows the kernel's argument type; static, so every library keeps its own.
static void (*emu_runner)(const void*, void*, unsigned, unsigned, size_t,
                          unsigned) = nullptr;

inline cudaError_t cudaLaunchCooperativeKernel(const void* kernel, dim3 grid,
                                               dim3 block, void** args,
                                               size_t smem, cudaStream_t) {
  if (smem > emu_limit_of(kernel)) return cudaErrorInvalidValue;
  emu_runner(kernel, args[0], grid.x, block.x, smem, 1);
  return cudaSuccess;
}

// A `kernel<<<grid, block, smem, stream>>>(args)` launch, as emu.py
// rewrites it: runs the grid, or records the error a refused launch gives.
template <class T> inline unsigned emu_x(T v) {
  if constexpr (std::is_same_v<T, dim3>) return v.x;
  else return unsigned(v);
}
template <class Args, class G, class B>
inline void emu_launch(void (*kernel)(Args), G grid, B block, size_t smem,
                       cudaStream_t, Args a) {
  if (smem > emu_limit_of((const void*)kernel)) {
    emu_last_error = cudaErrorInvalidValue;
    return;
  }
  emu_run<Args>((const void*)kernel, &a, emu_x(grid), emu_x(block), smem);
}

// cudaLaunchKernelEx with a cluster dimension (the only attribute the
// kernels set): a cluster of 1-8 blocks that divides the grid, as on the
// card without the non-portable size attribute.
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};
template <class Args>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                                      void (*kernel)(Args), Args a) {
  if (cfg->dynamicSmemBytes > emu_limit_of((const void*)kernel))
    return cudaErrorInvalidValue;
  unsigned cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      const auto& d = cfg->attrs[i].val.clusterDim;
      if (d.y != 1 || d.z != 1) return cudaErrorInvalidValue;
      cluster = d.x;
    }
  if (cluster < 1 || cluster > 8 || cfg->gridDim.x % cluster)
    return cudaErrorInvalidConfiguration;
  emu_run<Args>((const void*)kernel, &a, cfg->gridDim.x, cfg->blockDim.x,
                cfg->dynamicSmemBytes, cluster);
  return cudaSuccess;
}
