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
