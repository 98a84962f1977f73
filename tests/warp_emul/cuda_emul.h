// Host emulation of the CUDA constructs the port's kernels use, so that
// their bodies compile with g++ and run on a CPU.
//
// A block is one warp of 32 std::threads unless the launcher asks for
// more (whole warps); blocks run one after another.  Warp intrinsics
// (__shfl_*_sync, __ballot_sync, __any_sync, __reduce_{min,or}_sync)
// exchange values through a shared slot array between two waits on the
// warp's barrier, so every thread of the warp must reach them together,
// as in the port's kernels; __syncwarp waits on the warp's barrier and
// __syncthreads on the block's, so a missing sync between a write and
// another thread's read shows up as a real race.  emu_warpgroup_sync
// waits for the caller's 128 threads only (the warpgroup products of
// hopper.cuh), and a named barrier (emu_named, hopper.cuh's bar_sync and
// bar_arrive) for the count its first use names; named barriers start
// afresh with each block.  Warps of a warp-specialised block may leave
// early or wait on an mbarrier while the others go on.  Blocks run in
// blockIdx order, so a kernel that chains its
// blocks through global flags finds each flag it waits on already set.
// Dynamic shared memory is a global array that the including file
// defines under the kernel's own extern name.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <memory>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__
#define __restrict__
#define __grid_constant__

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0 };

struct dim3e {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3e threadIdx, blockIdx;
inline dim3e blockDim, gridDim;

using std::fmax;
using std::fmin;
using std::max;
using std::min;

struct WarpCtx {
  std::barrier<>* bar;
  std::barrier<>* wg_bar[8];     // one per warpgroup of a block of >= 128
  std::barrier<>* warp_bar[32];  // one per warp
  std::unique_ptr<std::barrier<>> named[16];  // named barriers, by id
  std::mutex named_mu;
  uint64_t slots[1024];
};

struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
inline WarpCtx* g_warp;
inline std::mutex g_atomic;

inline void emu_warp_sync() {
  g_warp->warp_bar[threadIdx.x / 32]->arrive_and_wait();
}
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_sync(); }
inline void __syncthreads() { g_warp->bar->arrive_and_wait(); }
inline void emu_warpgroup_sync() {
  if (blockDim.x <= 128)
    g_warp->bar->arrive_and_wait();
  else
    g_warp->wg_bar[threadIdx.x / 128]->arrive_and_wait();
}
// named barrier `id` of `n` threads (made at its first use in a block)
inline std::barrier<>& emu_named(int id, int n) {
  std::lock_guard<std::mutex> g(g_warp->named_mu);
  auto& b = g_warp->named[id];
  if (!b) b = std::make_unique<std::barrier<>>(n);
  return *b;
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
template <class T>
T __ldcg(const T* p) {
  return *p;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

template <class T>
T emu_exchange(T v, int src) {
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  g_warp->slots[threadIdx.x] = b;
  emu_warp_sync();
  const uint64_t got = g_warp->slots[(threadIdx.x & ~31u) | (src & 31)];
  emu_warp_sync();
  T r;
  std::memcpy(&r, &got, sizeof(T));
  return r;
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int off) {
  return emu_exchange(v, static_cast<int>(threadIdx.x) ^ off);
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return emu_exchange(v, src);
}
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned delta) {
  const unsigned lane = threadIdx.x & 31u;
  return emu_exchange(v, static_cast<int>(lane >= delta ? lane - delta
                                                        : lane));
}
inline unsigned __ballot_sync(unsigned, int pred) {
  g_warp->slots[threadIdx.x] = pred ? 1 : 0;
  emu_warp_sync();
  unsigned m = 0;
  const unsigned base = threadIdx.x & ~31u;
  for (int i = 0; i < 32; ++i)
    if (g_warp->slots[base + i]) m |= 1u << i;
  emu_warp_sync();
  return m;
}
inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0;
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  g_warp->slots[threadIdx.x] = v;
  emu_warp_sync();
  const unsigned base = threadIdx.x & ~31u;
  unsigned m = v;
  for (int i = 0; i < 32; ++i)
    m = std::min(m, static_cast<unsigned>(g_warp->slots[base + i]));
  emu_warp_sync();
  return m;
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  g_warp->slots[threadIdx.x] = v;
  emu_warp_sync();
  const unsigned base = threadIdx.x & ~31u;
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= static_cast<unsigned>(g_warp->slots[base + i]);
  emu_warp_sync();
  return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline long long __double_as_longlong(double d) {
  long long r;
  std::memcpy(&r, &d, sizeof r);
  return r;
}
inline double __longlong_as_double(long long v) {
  double r;
  std::memcpy(&r, &v, sizeof r);
  return r;
}
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int atomicAdd(int* p, int v) {
  std::lock_guard<std::mutex> g(g_atomic);
  const int o = *p;
  *p = o + v;
  return o;
}
template <class T>
T atomicMax(T* p, T v) {
  std::lock_guard<std::mutex> g(g_atomic);
  const T o = *p;
  if (v > o) *p = v;
  return o;
}

// Run `body` as `blocks` blocks of `threads` threads each (a multiple
// of 32, at most 1024).
template <class F>
void emu_run(int blocks, F&& body, int threads = 32) {
  std::barrier<> bar(threads);
  static WarpCtx w;
  w.bar = &bar;
  std::vector<std::unique_ptr<std::barrier<>>> wg_bars, warp_bars;
  for (int i = 0; i < threads / 128; ++i) {
    wg_bars.push_back(std::make_unique<std::barrier<>>(128));
    w.wg_bar[i] = wg_bars.back().get();
  }
  for (int i = 0; i < threads / 32; ++i) {
    warp_bars.push_back(std::make_unique<std::barrier<>>(32));
    w.warp_bar[i] = warp_bars.back().get();
  }
  g_warp = &w;
  blockDim.x = threads;
  gridDim.x = blocks;
  for (int b = 0; b < blocks; ++b) {
    for (auto& n : w.named) n.reset();
    std::vector<std::thread> lanes;
    for (int l = 0; l < threads; ++l)
      lanes.emplace_back([&body, l, b] {
        threadIdx.x = l;
        blockIdx.x = b;
        body();
      });
    for (auto& t : lanes) t.join();
  }
}
