// smem_probe: the latency of one dependent shared-memory round trip.
//
// Not a port of any kernel: a measurement that chip_smoke.py uses for
// the cell-scan kernel's latency bound (longest cell's steps x one
// dependent shared-memory round trip).  One warp fills a shared array
// with a stride-walk permutation, then lane 0 follows it for `iters`
// loads, each load's address being the previous load's value; the
// caller times the launch and divides by `iters`.
#include <cuda_runtime.h>

constexpr int N = 1024;

__global__ void smem_chase_kernel(int iters, int* out) {
  __shared__ int next[N];
  for (int i = threadIdx.x; i < N; i += blockDim.x) next[i] = (i + 97) % N;
  __syncwarp();
  if (threadIdx.x == 0) {
    volatile int* chain = next;  // keep every load a real load
    int j = 0;
    for (int k = 0; k < iters; ++k) j = chain[j];
    out[0] = j;
  }
}

// ---- host entry point -------------------------------------------------
extern "C" int smem_chase_launch(int iters, int* out, cudaStream_t stream) {
  smem_chase_kernel<<<1, 32, 0, stream>>>(iters, out);
  return static_cast<int>(cudaGetLastError());
}
