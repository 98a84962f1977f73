// Host emulation of the CUDA constructs the port's kernels use, so that
// their bodies compile with g++ and run on a CPU.
//
// A block is one warp of 32 std::threads unless the launcher asks for
// more (whole warps); blocks run one after another.  Warp intrinsics
// (__shfl_*_sync, __ballot_sync, __any_sync, __reduce_{min,or}_sync)
// exchange values through two shared slot sets, in turn, with one wait
// on the warp's barrier, so every thread of the warp must reach them together,
// as in the port's kernels; __syncwarp waits on the warp's barrier and
// __syncthreads on the block's, so a missing sync between a write and
// another thread's read shows up as a real race.  emu_warpgroup_sync
// waits for the caller's 128 threads only (the warpgroup products of
// hopper.cuh), and a named barrier (emu_named, hopper.cuh's bar_sync and
// bar_arrive) for the count its first use names; named barriers start
// afresh with each block.  Every barrier is an EmuBarrier: a futex of
// its own, so that a completed phase wakes its own waiters alone, and a
// deadline: a wait that outlasts EMU_DEADLINE (a deadlock: a wrong
// count, a thread that left early) aborts with a message naming the
// barrier, its count and its arrivals.  Warps of a warp-specialised block may leave
// early or wait on an mbarrier while the others go on.  Blocks run in
// blockIdx order, so a kernel that chains its
// blocks through global flags finds each flag it waits on already set.
// Dynamic shared memory is a global array that the including file
// defines under the kernel's own extern name.
#pragma once
#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <memory>
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

// How long a thread may wait on one barrier phase before the emulation
// calls it a deadlock (seconds; a test of the deadline builds with less).
#ifndef EMU_DEADLINE_S
#define EMU_DEADLINE_S 120
#endif
inline constexpr auto EMU_DEADLINE = std::chrono::seconds(EMU_DEADLINE_S);

// A barrier of `count` threads: arrive() returns the phase it arrived
// in, wait(p) returns once phase p has completed.  One atomic word holds
// the completed phases (high half) and this phase's arrivals (low half);
// the thread that completes a phase bumps `wakes` and wakes the futex on
// it, which only this barrier's waiters sleep on.  Not std::barrier:
// libstdc++ waits on its one-byte phase through waiter pools that all
// barriers share, so each phase woke the waiters of other barriers too,
// and it yields before it sleeps, which on a loaded CPU hands the core
// to another process for a whole time slice.  Not a mutex and condition
// variable either: every woken waiter then queues for the mutex.
struct EmuBarrier {
  EmuBarrier(int n, const char* what, int which)
      : count(n), kind(what), id(which) {}
  unsigned arrive() {
    const uint64_t old = word.fetch_add(1, std::memory_order_acq_rel);
    if (static_cast<uint32_t>(old) + 1 == static_cast<uint32_t>(count)) {
      // the next phase, with no arrival (or those that came early)
      word.fetch_add((uint64_t{1} << 32) - static_cast<uint64_t>(count),
                     std::memory_order_acq_rel);
      wakes.fetch_add(1, std::memory_order_release);
      syscall(SYS_futex, &wakes, FUTEX_WAKE_PRIVATE, INT_MAX, nullptr,
              nullptr, 0);
    }
    // an arrival after the completing one and before the phase moved on
    // counts toward the next phase, and waits for that one
    return static_cast<unsigned>(old >> 32) +
           (static_cast<uint32_t>(old) >= static_cast<uint32_t>(count) ? 1u
                                                                       : 0u);
  }
  // Sleeps at once: polling first is cheaper on an idle CPU and many
  // times dearer on a loaded one, where the pollers take the cores from
  // the threads they wait for.
  void wait(unsigned p) {
    const auto deadline = std::chrono::steady_clock::now() + EMU_DEADLINE;
    for (;;) {
      const uint32_t w = wakes.load(std::memory_order_acquire);
      const uint64_t now = word.load(std::memory_order_acquire);
      // phase p has completed once the count of completed phases is
      // past it (an early arrival waits on a phase not yet begun)
      if (static_cast<int32_t>(static_cast<uint32_t>(now >> 32) - p) > 0)
        return;
      if (std::chrono::steady_clock::now() > deadline) {
        std::fprintf(stderr,
                     "%s barrier %d of %d threads: phase %u never completed "
                     "(%u arrived)\n",
                     kind, id, count, p, static_cast<uint32_t>(now));
        std::abort();
      }
      // returns at a wake, at once if `wakes` moved since it was read,
      // or after a second, to look at the deadline again
      timespec second{1, 0};
      syscall(SYS_futex, &wakes, FUTEX_WAIT_PRIVATE, w, &second, nullptr,
              0);
    }
  }
  void arrive_and_wait() { wait(arrive()); }

  std::atomic<uint64_t> word{0};
  std::atomic<uint32_t> wakes{0};
  const int count;
  const char* const kind;
  const int id;
};

struct WarpCtx {
  EmuBarrier* bar;
  EmuBarrier* wg_bar[8];     // one per warpgroup of a block of >= 128
  EmuBarrier* warp_bar[32];  // one per warp
  std::unique_ptr<EmuBarrier> named[16];  // named barriers, by id
  std::mutex named_mu;
  uint64_t slots[2][1024];  // two sets, used in turn (emu_publish)
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
inline EmuBarrier& emu_named(int id, int n) {
  std::lock_guard<std::mutex> g(g_warp->named_mu);
  auto& b = g_warp->named[id];
  if (!b) b = std::make_unique<EmuBarrier>(n, "named", id);
  if (b->count != n) {
    std::fprintf(stderr, "named barrier %d: %d threads, first used with %d\n",
                 id, n, b->count);
    std::abort();
  }
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

// The warp's values for one exchange: this lane's `v` is written to its
// slot of the lane's next slot set, the warp's barrier passed, and the
// warp's 32 slots of that set returned.  The two sets take turns, so an
// exchange needs one barrier: a lane writes a set again only after the
// next exchange's barrier, which each lane reaches after its read here.
inline thread_local unsigned emu_turn;
inline const uint64_t* emu_publish(uint64_t v) {
  uint64_t* set = g_warp->slots[emu_turn++ & 1u];
  set[threadIdx.x] = v;
  emu_warp_sync();
  return set + (threadIdx.x & ~31u);
}
template <class T>
T emu_exchange(T v, int src) {
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  const uint64_t got = emu_publish(b)[src & 31];
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
  const uint64_t* warp = emu_publish(pred ? 1 : 0);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i)
    if (warp[i]) m |= 1u << i;
  return m;
}
inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0;
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  const uint64_t* warp = emu_publish(v);
  unsigned m = v;
  for (int i = 0; i < 32; ++i) m = std::min(m, static_cast<unsigned>(warp[i]));
  return m;
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  const uint64_t* warp = emu_publish(v);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= static_cast<unsigned>(warp[i]);
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
  EmuBarrier bar(threads, "block", 0);
  static WarpCtx w;
  w.bar = &bar;
  std::vector<std::unique_ptr<EmuBarrier>> wg_bars, warp_bars;
  for (int i = 0; i < threads / 128; ++i) {
    wg_bars.push_back(std::make_unique<EmuBarrier>(128, "warpgroup", i));
    w.wg_bar[i] = wg_bars.back().get();
  }
  for (int i = 0; i < threads / 32; ++i) {
    warp_bars.push_back(std::make_unique<EmuBarrier>(32, "warp", i));
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
