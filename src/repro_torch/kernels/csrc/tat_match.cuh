// The PB tag match shared by the tat_lookup kernel and the cell-scan
// kernel's PB lookups (port of the match in
// repro/kernels/tat_lookup.py::_kernel).
#pragma once

// First slot s in [0, n) with tag[s] == addr and live(s), or -1.
//
// Called by all 32 lanes of a warp together and returns the same value
// on every lane: the table is swept in 32-entry tiles, lane j tests
// slot base + j, and __ballot_sync + __ffs take the lowest matching
// slot of the first tile that has one — the lowest index wins, as in
// the Pallas kernel's argmax.
template <typename Live>
__device__ __forceinline__ int tat_match(int addr, const int* tag, Live live,
                                         int n) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += 32) {
    const int s = base + lane;
    const bool hit = s < n && tag[s] == addr && live(s);
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (m) return base + __ffs(m) - 1;
  }
  return -1;
}

// The same match over hit bits that the caller has evaluated: lane l's
// hit[j] says whether slot 32·j + l (j < tiles) matches — its tag equals
// the request and it is live.  Returns the lowest such slot, or -1; a
// kernel that keeps each lane's slots in registers calls this instead
// of re-reading the table.
template <int NT_>
__device__ __forceinline__ int tat_first(const bool (&hit)[NT_], int tiles) {
#pragma unroll
  for (int j = 0; j < NT_; ++j) {
    if (j >= tiles) break;
    const unsigned m = __ballot_sync(0xffffffffu, hit[j]);
    if (m) return 32 * j + __ffs(m) - 1;
  }
  return -1;
}

// Many requests at once: lane l asks for `req`, and the table is held as
// for tat_first (lane l's tag[j] and live[j]: slot 32·j + l).  Returns,
// on each lane, the lowest live slot whose tag equals the lane's
// request, or -1 — tat_first's answer for that request.  The live slots
// go by ballot, lowest first, each one's tag broadcast by shuffle.
template <int NT_>
__device__ __forceinline__ int tat_first_each(int req, const int (&tag)[NT_],
                                              const bool (&live)[NT_],
                                              int tiles) {
  int found = -1;
#pragma unroll
  for (int j = 0; j < NT_; ++j) {
    if (j >= tiles) break;
    for (unsigned m = __ballot_sync(0xffffffffu, live[j]); m; m &= m - 1) {
      const int l = __ffs(m) - 1;
      const int t = __shfl_sync(0xffffffffu, tag[j], l);
      if (found < 0 && t == req) found = 32 * j + l;
    }
  }
  return found;
}

// Several tables at once, where a hit is either preferred or plain: the
// first table (in order) with a hit, its first preferred slot, else its
// first plain one.  Each lane folds its candidates into one key
// (tat_key; TAT_NO_KEY for none) and the warp's least key is the
// answer, so one reduction searches every table (slots < 128, tables
// < 2^23).
constexpr int TAT_NO_KEY = 0x7fffffff;
__device__ __forceinline__ int tat_key(int table, bool plain, int slot) {
  return (table << 8) | (plain ? 128 : 0) | slot;
}
__device__ __forceinline__ int tat_key_table(int key) { return key >> 8; }
__device__ __forceinline__ int tat_key_slot(int key) { return key & 127; }
__device__ __forceinline__ int tat_first_key(int key) {
  return static_cast<int>(
      __reduce_min_sync(0xffffffffu, static_cast<unsigned>(key)));
}
