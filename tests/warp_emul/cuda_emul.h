// Host emulation of the CUDA constructs the port's kernels use, so that
// their bodies compile with g++ and run on a CPU.
//
// A block is one warp of 32 std::threads; blocks run one after another.
// Warp intrinsics (__shfl_*_sync, __ballot_sync, __any_sync) exchange
// values through a shared slot array between two barrier waits, and
// __syncwarp/__syncthreads are a barrier wait, so a missing __syncwarp
// between a write and another lane's read shows up as a real race.
// Dynamic shared memory is a global array that the including file
// defines under the kernel's own extern name.
#pragma once
#include <algorithm>
#include <barrier>
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
#define __launch_bounds__(x)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__
#define __restrict__

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
  uint64_t slots[32];
};
inline WarpCtx* g_warp;
inline std::mutex g_atomic;

inline void __syncwarp(unsigned = 0xffffffffu) {
  g_warp->bar->arrive_and_wait();
}
inline void __syncthreads() { g_warp->bar->arrive_and_wait(); }

template <class T>
T emu_exchange(T v, int src) {
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  g_warp->slots[threadIdx.x] = b;
  g_warp->bar->arrive_and_wait();
  const uint64_t got = g_warp->slots[src & 31];
  g_warp->bar->arrive_and_wait();
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
inline unsigned __ballot_sync(unsigned, int pred) {
  g_warp->slots[threadIdx.x] = pred ? 1 : 0;
  g_warp->bar->arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    if (g_warp->slots[i]) m |= 1u << i;
  g_warp->bar->arrive_and_wait();
  return m;
}
inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int atomicMax(int* p, int v) {
  std::lock_guard<std::mutex> g(g_atomic);
  const int o = *p;
  if (v > o) *p = v;
  return o;
}

// Run `body` as `blocks` blocks of one 32-lane warp each.
template <class F>
void emu_run(int blocks, F&& body) {
  std::barrier<> bar(32);
  static WarpCtx w;
  w.bar = &bar;
  g_warp = &w;
  blockDim.x = 32;
  gridDim.x = blocks;
  for (int b = 0; b < blocks; ++b) {
    std::vector<std::thread> lanes;
    for (int l = 0; l < 32; ++l)
      lanes.emplace_back([&body, l, b] {
        threadIdx.x = l;
        blockIdx.x = b;
        body();
      });
    for (auto& t : lanes) t.join();
  }
}
