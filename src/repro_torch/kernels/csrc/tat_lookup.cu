// tat_lookup: batched fully-associative PB tag match on Hopper.
//
// Replaces the Pallas kernel repro/kernels/tat_lookup.py::tat_lookup_pallas
// (body _kernel): per request tag, the first table entry with an equal
// tag and a non-Empty state -> (index or -1, state or 0).
//
// Design: the (N,) tag and state table is staged once per block in
// shared memory; each warp takes 32 requests at a time (one coalesced
// load), broadcasts them one by one with __shfl_sync, and matches each
// with tat_match (tat_match.cuh): a ballot over 32-entry tiles whose
// lowest set bit is the first match.  Lane k keeps request k's result
// and the warp stores all 32 at once.  The work is a few integer
// compares per (request, entry) pair on a table in shared memory, so
// the kernel is bound by the bytes it moves: R request tags in, 2R
// results out.
#include <cuda_runtime.h>

#include "tat_match.cuh"

__global__ void tat_lookup_kernel(const int* __restrict__ req,
                                  const int* __restrict__ tat,
                                  const int* __restrict__ states,
                                  int* __restrict__ out_idx,
                                  int* __restrict__ out_state, int r, int n) {
  extern __shared__ int table[];
  int* tag_s = table;
  int* st_s = table + n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    tag_s[i] = tat[i];
    st_s[i] = states[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int warp = blockIdx.x * warps + (threadIdx.x >> 5);
  const int stride = gridDim.x * warps * 32;
  for (int base = warp * 32; base < r; base += stride) {
    const int mine = base + lane < r ? req[base + lane] : 0;
    const int cnt = min(32, r - base);
    int my_idx = -1, my_state = 0;
    for (int k = 0; k < cnt; ++k) {
      const int a = __shfl_sync(0xffffffffu, mine, k);
      const int idx = tat_match(
          a, tag_s, [&](int s) { return st_s[s] != 0; }, n);
      if (lane == k) {
        my_idx = idx;
        my_state = idx >= 0 ? st_s[idx] : 0;
      }
    }
    if (base + lane < r) {
      out_idx[base + lane] = my_idx;
      out_state[base + lane] = my_state;
    }
  }
}

// ---- host entry point -------------------------------------------------
extern "C" int tat_lookup_launch(const int* req, const int* tat,
                                 const int* states, int* out_idx,
                                 int* out_state, int r, int n,
                                 int warps_per_block, cudaStream_t stream) {
  const int chunks = (r + 31) / 32;
  int blocks = (chunks + warps_per_block - 1) / warps_per_block;
  if (blocks > 1024) blocks = 1024;  // the loop strides over the rest
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(int);
  tat_lookup_kernel<<<blocks, 32 * warps_per_block, smem, stream>>>(
      req, tat, states, out_idx, out_state, r, n);
  return static_cast<int>(cudaGetLastError());
}
