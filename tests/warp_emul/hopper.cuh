// Host twin of src/repro_torch/kernels/csrc/hopper.cuh for g++ and the
// warp emulation (cuda_emul.h): the same calls, done in scalar C++.
//
// The asynchronous copies are synchronous here: a TMA load has written
// its box and completed its bytes on the mbarrier when it returns, and
// a cp.async when it returns, so a missing wait or fence shows only on
// the card.  An mbarrier is kept beside shared memory, by address, with
// its count, pending arrivals, transaction count and phase, under its
// own lock; a wait blocks on its own condition variable until its phase
// has completed (and aborts after EMU_DEADLINE, a deadlock).  Named
// barriers are cuda_emul.h's EmuBarrier, with the same deadline.
// setmaxnreg does nothing and elect.sync elects lane 0.
//
// Shared memory is the kernel's dynamic array, whose start the launcher
// stores in emu_smem_base; a "shared address" is a byte offset from it
// (the array is 1024-byte aligned, as the card's window is in effect).
// The products do what the PTX ISA documents for
// wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 (and m64n32k16,
// whose accumulator is the first 16 registers' layout), independently
// of how the kernel lays out its tiles:
//   * a descriptor holds (start >> 4) in bits 0-13, the leading byte
//     offset >> 4 in 16-29, the stride byte offset >> 4 in 32-45 and the
//     layout type in 62-63 (1 = 128-byte swizzle, the only one taken);
//   * 128-byte swizzle: the byte at address x is stored at
//     x ^ (((x >> 7) & 7) << 4);
//   * K-major operand element (row m, k) lies at
//     start + (m / 8)·SBO + (m % 8)·128 + 2k;
//   * MN-major operand element (k, n) lies at
//     start + (k / 8)·SBO + (n / 64)·LBO + (k % 8)·128 + 2(n % 64);
//   * accumulator register i of thread t (warp w = t / 32, lane l):
//     row 16w + l/4 + 8·((i % 4) / 2), column 8·(i / 4) + 2·(l % 4) + i % 2;
//   * register-A fragment a[r] of thread t: row 16w + l/4 + 8·(r % 2),
//     columns 2·(l % 4) + 8·(r / 2) + {0, 1} (low half first).
// Each thread computes its own accumulator entries; a register-A
// product gathers the warpgroup's fragments through a slot array between
// two waits on the warpgroup's barrier, so all 128 threads of the
// warpgroup must reach it together.  The chain flags are atomics with
// the same release and acquire orders.
#pragma once
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>

#include "cuda.h"
#include "cuda_bf16.h"

namespace wg {

inline unsigned char* emu_smem_base;

inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(static_cast<const unsigned char*>(p) -
                               emu_smem_base);
}

inline void cp_async_16(uint32_t dst, const void* src, bool ok) {
  if (ok)
    std::memcpy(emu_smem_base + dst, src, 16);
  else
    std::memset(emu_smem_base + dst, 0, 16);
}
inline void cp_async_4(uint32_t dst, const void* src) {
  std::memcpy(emu_smem_base + dst, src, 4);
}
inline void st_release(int* p, int v) {
  std::atomic_ref<int>(*p).store(v, std::memory_order_release);
}
inline int ld_acquire(const int* p) {
  return std::atomic_ref<int>(*const_cast<int*>(p))
      .load(std::memory_order_acquire);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
inline void fence_proxy_async() {}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N>
inline void wgmma_wait() {}
template <int N>
inline void fence_acc(float (&)[N]) {}

inline uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__float2bfloat16(lo).x) |
         (static_cast<uint32_t>(__float2bfloat16(hi).x) << 16);
}

inline float bf16_at(uint32_t addr) {
  const uint32_t x = addr ^ (((addr >> 7) & 7u) << 4);
  __nv_bfloat16 v;
  std::memcpy(&v, emu_smem_base + x, 2);
  return __bfloat162float(v);
}

struct Desc {
  uint32_t start, lbo, sbo;
};
inline Desc decode(uint64_t d) {
  if ((d >> 62) != 1) std::abort();  // only the 128-byte swizzle
  return {static_cast<uint32_t>(d & 0x3FFF) << 4,
          static_cast<uint32_t>((d >> 16) & 0x3FFF) << 4,
          static_cast<uint32_t>((d >> 32) & 0x3FFF) << 4};
}
inline float kmajor(const Desc& d, int m, int k) {
  return bf16_at(d.start + (m / 8) * d.sbo + (m % 8) * 128 + 2 * k);
}
inline float mnmajor(const Desc& d, int k, int n) {
  return bf16_at(d.start + (k / 8) * d.sbo + (n / 64) * d.lbo +
                 (k % 8) * 128 + 2 * (n % 64));
}

template <int N, class A, class B>
inline void emu_mma(float (&d)[N], A a_at, B b_at, int scale_d) {
  const int t = static_cast<int>(threadIdx.x) % 128, w = t / 32, l = t % 32;
  for (int i = 0; i < N; ++i) {
    const int row = 16 * w + l / 4 + 8 * ((i % 4) / 2);
    const int col = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    float acc = 0.f;
    for (int k = 0; k < 16; ++k) acc += a_at(row, k) * b_at(k, col);
    d[i] = scale_d ? d[i] + acc : acc;
  }
}

template <int TB>
inline float b_elem(const Desc& db, int k, int n) {
  return TB ? mnmajor(db, k, n) : kmajor(db, n, k);
}

template <int TB>
inline void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  const Desc a = decode(da), b = decode(db);
  emu_mma(
      d, [&](int m, int k) { return kmajor(a, m, k); },
      [&](int k, int n) { return b_elem<TB>(b, k, n); }, scale_d);
}

// m64n128k16, both from shared memory: 64 registers
template <int TB>
inline void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  const Desc a = decode(da), b = decode(db);
  emu_mma(
      d, [&](int m, int k) { return kmajor(a, m, k); },
      [&](int k, int n) { return b_elem<TB>(b, k, n); }, scale_d);
}

// m64n32k16, both operands from shared memory (B K-major): 16 registers
inline void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                         int scale_d) {
  const Desc a = decode(da), b = decode(db);
  emu_mma(
      d, [&](int m, int k) { return kmajor(a, m, k); },
      [&](int k, int n) { return kmajor(b, n, k); }, scale_d);
}

inline uint32_t emu_afrag[1024][4];

template <int TB>
inline void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                     int scale_d) {
  const int t = static_cast<int>(threadIdx.x), g0 = t - t % 128;
  for (int r = 0; r < 4; ++r) emu_afrag[t][r] = a[r];
  emu_warpgroup_sync();
  const Desc b = decode(db);
  auto a_at = [g0](int m, int k) {
    // the thread holding (m, k): warp m / 16, lane 4·(m % 8) + (k % 8) / 2
    const int w = m / 16, lane = 4 * (m % 8) + (k % 8) / 2;
    const int r = (m % 16) / 8 + 2 * (k / 8);
    const uint32_t bits = emu_afrag[g0 + 32 * w + lane][r];
    __nv_bfloat16 v{static_cast<uint16_t>(k % 2 ? bits >> 16 : bits)};
    return __bfloat162float(v);
  };
  emu_mma(
      d, a_at, [&](int k, int n) { return b_elem<TB>(b, k, n); }, scale_d);
  emu_warpgroup_sync();
}

template <int N>
inline void fence_regs(uint32_t (&)[N]) {}

// ---- mbarriers, TMA, named barriers, register reallocation ----------
struct EmuMbar {
  std::mutex mu;
  std::condition_variable cv;
  int count = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;  // phases completed
};
inline std::mutex emu_mbars_mu;  // guards the map, not its entries
inline std::map<uint32_t, EmuMbar> emu_mbars;

inline EmuMbar& emu_mbar(uint32_t bar) {
  std::lock_guard<std::mutex> g(emu_mbars_mu);
  return emu_mbars.at(bar);
}
inline void emu_mbar_update(uint32_t bar, int arrivals, long long tx) {
  EmuMbar& m = emu_mbar(bar);
  {
    std::lock_guard<std::mutex> g(m.mu);
    m.pending -= arrivals;
    m.tx += tx;
    if (m.pending < 0) {
      std::fprintf(stderr, "mbarrier at %u: more arrivals than its %d\n",
                   bar, m.count);
      std::abort();
    }
    if (m.pending == 0 && m.tx == 0) {
      ++m.phase;
      m.pending = m.count;
    }
  }
  m.cv.notify_all();
}
inline void mbar_init(uint32_t bar, int count) {
  EmuMbar* m;
  {
    std::lock_guard<std::mutex> g(emu_mbars_mu);
    m = &emu_mbars[bar];
  }
  std::lock_guard<std::mutex> g(m->mu);
  m->count = m->pending = count;
  m->tx = 0;
  m->phase = 0;
}
inline void fence_mbar_init() {}
inline void mbar_arrive(uint32_t bar) { emu_mbar_update(bar, 1, 0); }
inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  emu_mbar_update(bar, 1, bytes);
}
inline void mbar_wait(uint32_t bar, int parity) {
  EmuMbar& m = emu_mbar(bar);
  std::unique_lock<std::mutex> g(m.mu);
  if (!m.cv.wait_for(g, EMU_DEADLINE, [&] {
        return static_cast<int>(m.phase & 1u) != parity;
      })) {
    std::fprintf(stderr,
                 "mbarrier at %u: phase %d never completed (%d of %d "
                 "arrivals pending, %lld tx bytes)\n",
                 bar, parity, m.pending, m.count, m.tx);
    std::abort();
  }
}

// the box at (c0, c1, c2, c3) of the 4-d map, bf16, elements outside the
// tensor as zeros, laid out box row by box row (dim 0 innermost) from
// dst; in the 128-byte swizzle the byte at x lands at
// x ^ (((x >> 7) & 7) << 4), as wgmma's descriptors read it
inline void tma_load_4d(uint32_t dst, const void* map, uint32_t bar, int c0,
                        int c1, int c2, int c3) {
  const CUtensorMap& m = *static_cast<const CUtensorMap*>(map);
  if (m.rank != 4 || (m.swizzle && (m.box[0] * m.elem != 128 || dst % 1024)))
    std::abort();
  const int c[4] = {c0, c1, c2, c3};
  const uint32_t row = m.box[0] * m.elem;
  uint32_t off = 0;
  for (uint32_t i3 = 0; i3 < m.box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < m.box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < m.box[1]; ++i1, off += row)
        for (uint32_t i0 = 0; i0 < m.box[0]; ++i0) {
          const long long x[4] = {c[0] + static_cast<long long>(i0),
                                  c[1] + static_cast<long long>(i1),
                                  c[2] + static_cast<long long>(i2),
                                  c[3] + static_cast<long long>(i3)};
          bool in = true;
          long long at = x[0] * m.elem;
          for (int d = 0; d < 4; ++d) {
            in = in && x[d] >= 0 && x[d] < static_cast<long long>(m.dims[d]);
            if (d > 0) at += x[d] * static_cast<long long>(m.strides[d - 1]);
          }
          uint32_t a = dst + off + i0 * m.elem;
          if (m.swizzle) a ^= ((a >> 7) & 7u) << 4;
          if (in)
            std::memcpy(emu_smem_base + a, m.base + at, m.elem);
          else
            std::memset(emu_smem_base + a, 0, m.elem);
        }
  emu_mbar_update(bar, 0, -static_cast<long long>(off));
}

inline void bar_sync(int id, int n) { emu_named(id, n).arrive_and_wait(); }
inline void bar_arrive(int id, int n) {
  auto token = emu_named(id, n).arrive();
  (void)token;
}
template <int N>
inline void setmaxnreg_dec() {}
template <int N>
inline void setmaxnreg_inc() {}
inline bool elect_one() { return threadIdx.x % 32 == 0; }

}  // namespace wg
