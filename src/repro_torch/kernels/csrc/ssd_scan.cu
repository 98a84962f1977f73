// ssd_scan: Mamba2 SSD chunked scan (dual form) on Hopper, f32.
//
// Replaces the Pallas kernel repro/kernels/ssd_scan.py::ssd_scan_pallas
// (body _kernel), with the initial state of the function it stands for,
// repro/models/ssm.py::ssd_chunked, for f32 inputs outside the
// tensor-core kernel's limits (ssd_scan_tc.cu takes bf16, and f32 at
// chunk 64 or 128 with P <= 64 and N <= 128; this kernel takes any
// chunk whose tiles fit shared memory).  Per (batch, head), chunks of Q
// steps in order, with the (P, N) state carried:
//   da_cum = cumsum(dt · A)
//   y      = ((C Bᵀ) ∘ L ∘ dt) x + exp(da_cum) · (C stateᵀ),
//            L[i, j] = exp(da_cum[i] - da_cum[j]) for j <= i, else 0
//   state  = state · exp(da_cum[-1]) + (x · dt · exp(da_cum[-1] - da_cum))ᵀ B
// Steps past the sequence end load dt = 0 and x = B = C = 0, the
// reference's own padding identity (decay 1, no input), and their y is
// not stored, so any S runs without a padded copy.
//
// Design: one block of 256 threads per (batch, head), looping over the
// chunks with the f32 state resident in shared memory.  x and B of the
// chunk are staged in f32; the Q x Q product is built 64 rows at a time
// (C rows staged per row tile), so at Q = N = 128, P = 64 the block
// holds x 32 KiB, B 64 KiB, state 32 KiB, C rows 32 KiB and the masked
// product 32 KiB (~195 KiB with padding; one block per SM).  The
// exponent of L is taken only on and below the diagonal (above it the
// segment sum is positive and could overflow), and row tiles skip the
// key columns above their last row.  Every product runs on a 16 x 16
// thread grid with 4 x 4 values a thread (rows ty + 16i, columns
// tx + 16j; padded rows keep shared-memory reads broadcast or
// conflict-free).  B and C are shared by all heads (g = 1), so the
// blocks of one batch read the same B and C, from L2 after the first.
// The work is bound by its operations on this card; this first
// version runs them on the f32 FMA units, not the tensor cores.
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace ssd {

constexpr int NT = 256;  // threads per block, a 16 x 16 grid
constexpr int RT = 64;   // rows of the Q x Q product built at a time

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* init;  // (B, H, P, N) or null for a zero state
  void* y;            // (B, S, H, P), contiguous
  float* fin;         // (B, H, P, N), contiguous
  long long x_sb, x_ss, x_sh;  // element strides; P is unit
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;        // N is unit
  long long c_sb, c_ss;
  int S, H, P, N, Q;
};

__host__ __device__ constexpr long long smem_floats(int q, int p, int n) {
  return 1LL * q * p + 1LL * q * (n + 1) + 1LL * p * (n + 1) +
         1LL * RT * (n + 1) + 1LL * RT * (q + 1) + 2LL * q;
}

template <class T>
__global__ void __launch_bounds__(NT) ssd_kernel(Args a) {
  extern __shared__ float ssd_smem[];
  const int P = a.P, N = a.N, Q = a.Q, S = a.S;
  const int NP = N + 1, QP = Q + 1;
  float* xs = ssd_smem;        // Q x P   x of the chunk, later x·dt·decay
  float* bs = xs + Q * P;      // Q x NP  B of the chunk
  float* st = bs + Q * NP;     // P x NP  state
  float* cs = st + P * NP;     // RT x NP C rows of the row tile
  float* ms = cs + RT * NP;    // RT x QP (C Bᵀ) ∘ L ∘ dt rows
  float* dts = ms + RT * QP;   // Q dt
  float* dc = dts + Q;         // Q da_cum

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = static_cast<int>(blockIdx.x) / a.H;
  const int h = static_cast<int>(blockIdx.x) % a.H;
  const float A = a.A[h];
  const T* xp = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const float* dtp = a.dt + b * a.dt_sb + h * a.dt_sh;
  const T* bp = static_cast<const T*>(a.Bm) + b * a.b_sb;
  const T* cp = static_cast<const T*>(a.Cm) + b * a.c_sb;
  const long long head = (1LL * b * a.H + h) * P * N;
  T* yp = static_cast<T*>(a.y) + (1LL * b * S * a.H + h) * P;
  const long long y_ss = 1LL * a.H * P;

  for (int i = tid; i < P * N; i += NT)
    st[(i / N) * NP + i % N] = a.init ? a.init[head + i] : 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    for (int i = tid; i < Q; i += NT)
      dts[i] = s0 + i < S ? dtp[(s0 + i) * a.dt_ss] : 0.f;
    for (int i = tid; i < Q * P; i += NT) {
      const int t = s0 + i / P;
      xs[i] = t < S ? to_f32(xp[t * a.x_ss + i % P]) : 0.f;
    }
    for (int i = tid; i < Q * N; i += NT) {
      const int j = i / N, n = i % N, t = s0 + j;
      bs[j * NP + n] = t < S ? to_f32(bp[t * a.b_ss + n]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // da_cum, in order
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += dts[i] * A;
        dc[i] = run;
      }
    }
    __syncthreads();
    const float dlast = dc[Q - 1];

    for (int r0 = 0; r0 < Q; r0 += RT) {
      const int rows = min(RT, Q - r0);
      const int jmax = r0 + rows;  // keys after the tile's last row: 0
      for (int i = tid; i < RT * N; i += NT) {
        const int rr = i / N, n = i % N, t = s0 + r0 + rr;
        cs[rr * NP + n] = rr < rows && t < S ? to_f32(cp[t * a.c_ss + n])
                                             : 0.f;
      }
      __syncthreads();

      for (int j0 = 0; j0 < jmax; j0 += 64) {  // ms = (C Bᵀ) ∘ L ∘ dt
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float ca[4], bb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ca[i] = cs[(ty + 16 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bb[j] = bs[min(j0 + tx + 16 * j, Q - 1) * NP + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += ca[i] * bb[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = ty + 16 * i, r = r0 + rr;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = j0 + tx + 16 * j;
            if (c >= Q) continue;
            ms[rr * QP + c] = rr < rows && c <= r
                                  ? acc[i][j] * expf(dc[r] - dc[c]) * dts[c]
                                  : 0.f;
          }
        }
      }
      __syncthreads();

      for (int p0 = 0; p0 < P; p0 += 64) {  // y rows of the tile
        float acc[4][4], acc2[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = acc2[i][j] = 0.f;
        for (int c = 0; c < jmax; ++c) {
          float ma[4], xb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ma[i] = ms[(ty + 16 * i) * QP + c];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            xb[j] = xs[c * P + min(p0 + tx + 16 * j, P - 1)];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += ma[i] * xb[j];
        }
        for (int n = 0; n < N; ++n) {
          float ca[4], sb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ca[i] = cs[(ty + 16 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sb[j] = st[min(p0 + tx + 16 * j, P - 1) * NP + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc2[i][j] += ca[i] * sb[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = ty + 16 * i, t = s0 + r0 + rr;
          if (rr >= rows || t >= S) continue;
          const float decay = expf(dc[r0 + rr]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = p0 + tx + 16 * j;
            if (p < P)
              yp[t * y_ss + p] = from_f32<T>(acc[i][j] + decay * acc2[i][j]);
          }
        }
      }
      __syncthreads();
    }

    // state <- state · exp(da_cum[-1]) + (x · dt · decay_to_end)ᵀ B
    for (int i = tid; i < Q * P; i += NT) {
      const int j = i / P;
      xs[i] *= dts[j] * expf(dlast - dc[j]);
    }
    __syncthreads();
    const float chunk_decay = expf(dlast);
    for (int p0 = 0; p0 < P; p0 += 64) {
      for (int n0 = 0; n0 < N; n0 += 64) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int c = 0; c < Q; ++c) {
          float xa[4], bb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            xa[i] = xs[c * P + min(p0 + ty + 16 * i, P - 1)];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bb[j] = bs[c * NP + min(n0 + tx + 16 * j, N - 1)];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += xa[i] * bb[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = p0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + 16 * j;
            if (p < P && n < N)
              st[p * NP + n] = st[p * NP + n] * chunk_decay + acc[i][j];
          }
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < P * N; i += NT)
    a.fin[head + i] = st[(i / N) * NP + i % N];
}

}  // namespace ssd

// ---- host entry point -------------------------------------------------
template <class T>
static int ssd_launch_t(const ssd::Args& a, int blocks, cudaStream_t stream) {
  const long long smem = ssd::smem_floats(a.Q, a.P, a.N) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd::ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd::ssd_kernel<T><<<blocks, ssd::NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssd_scan_launch(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* init, void* y, float* fin,
    const long long* strides,  // x (sb, ss, sh), dt (sb, ss, sh),
                               // B (sb, ss), C (sb, ss)
    int batch, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  ssd::Args a{x, dt, A, Bm, Cm, init, y, fin,
              strides[0], strides[1], strides[2],
              strides[3], strides[4], strides[5],
              strides[6], strides[7], strides[8], strides[9],
              S, H, P, N, Q};
  return ssd_launch_t<float>(a, batch * H, stream);
}
