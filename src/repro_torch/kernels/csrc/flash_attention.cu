// flash_attention: forward online-softmax attention on Hopper, f32.
//
// Replaces the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body
// _kernel) for f32 inputs of head dim 256 (bf16 inputs, and f32 up to
// head dim 128, take flash_attention_tc.cu on the tensor cores, whose
// three bf16 parts of K and V do not fit shared memory at 256):
// out = softmax(q kᵀ · D^-0.5, masked) v per (batch, head), with a
// causal mask (k <= q) and an optional window (k > q - window),
// f32 running max, normalizer and accumulator, and max(l, 1e-30) at the
// end.  Beyond the Pallas kernel it takes grouped KV heads (query head
// h reads KV head h / g) and any sequence length (the tail tile is
// masked), and reads q, k, v and writes out through strides, so the
// model's (B, S, H, D) projections need no transposed copy.
//
// Design: one block of 256 threads per (batch·head, 64-query tile),
// heaviest causal tiles first.  The scaled Q tile stays in shared
// memory; each 64-key tile of K and V is staged there in f32.  A 16 x 16
// thread grid computes the 64 x 64 score tile (4 x 4 values a thread,
// rows ty + 16i, columns tx + 16j, so shared-memory reads are
// broadcasts or conflict-free); four threads per row then update the
// row's running max and normalizer and turn scores into probabilities
// (masked keys get probability 0, so a row with no key yet keeps l = 0
// and acc = 0, and nothing becomes NaN); the same grid then rescales
// and accumulates P·V into 4 x D/16 registers a thread.  Key tiles
// wholly outside the causal or window range are skipped, which changes
// nothing.  On this card the work is bound by its operations (4·S²·D/2
// flops per head against 2·S·D·4 bytes), which this kernel runs on the
// f32 FMA units: f32 precision is what the route is for.
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace flash {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block, a 16 x 16 grid
constexpr float NEG = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;  // element strides of (B, H, S); D is unit
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, S, g, causal, window;  // window <= 0: none
  float scale;
};

__host__ __device__ constexpr int smem_floats(int d) {
  return 2 * BQ * (d + 1) + BK * d + BQ * (BK + 1) + 3 * BQ;
}

template <class T, int D>
__global__ void __launch_bounds__(NT) flash_kernel(Args a) {
  extern __shared__ float flash_smem[];
  constexpr int DP = D + 1;   // padded rows: column reads hit 16 banks
  constexpr int PP = BK + 1;
  constexpr int DJ = D / 16;  // accumulator columns a thread holds
  float* qs = flash_smem;     // BQ x DP, pre-scaled
  float* ks = qs + BQ * DP;   // BK x DP
  float* vs = ks + BK * DP;   // BK x D
  float* ps = vs + BK * D;    // BQ x PP scores, then probabilities
  float* m_s = ps + BQ * PP;  // BQ running max
  float* l_s = m_s + BQ;      // BQ running normalizer
  float* c_s = l_s + BQ;      // BQ this tile's rescale factor

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int S = a.S;
  const int n_qt = (S + BQ - 1) / BQ;
  const int BH = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / a.H, h = bh % a.H, hk = h / a.g;
  const int q0 = qt * BQ;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, qi = q0 + r;
    qs[r * DP + c] = qi < S ? to_f32(qp[qi * a.q_ss + c]) * a.scale : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = NEG;
    l_s[r] = 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // keys any row of this tile can see: [k_lo, k_hi)
  int k_lo = 0, k_hi = S;
  if (a.causal) k_hi = min(S, q0 + BQ);
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  __syncthreads();

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, kj = k0 + r;
      const bool ok = kj < S;
      ks[r * DP + c] = ok ? to_f32(kp[kj * a.k_ss + c]) : 0.f;
      vs[r * D + c] = ok ? to_f32(vp[kj * a.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * kb[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kj = k0 + c;
        bool ok = kj < S;
        if (a.causal) ok = ok && kj <= qi;
        if (a.window > 0) ok = ok && kj > qi - a.window;
        ps[r * PP + c] = ok ? s[i][j] : NEG;
      }
    }
    __syncthreads();

    {  // four neighbouring lanes per row: running max, probabilities, sum
      const int r = tid / 4, part = tid % 4;
      float* row = ps + r * PP;
      float mx = NEG;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float sc = row[c];
        const float pv = sc > 0.5f * NEG ? expf(sc - m_new) : 0.f;
        row[c] = pv;
        sum += pv;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        // m_old = NEG = m_new: rescale by 1 an l and acc that are 0
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4], vb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vb[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += pa[i] * vb[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= S) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      op[qi * a.o_ss + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

}  // namespace flash

// ---- host entry point -------------------------------------------------
template <class T, int D>
static int flash_launch_t(const flash::Args& a, int blocks,
                          cudaStream_t stream) {
  const int smem = flash::smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      flash::flash_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash::flash_kernel<T, D><<<blocks, flash::NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
static int flash_launch_d(const flash::Args& a, int d, int blocks,
                          cudaStream_t stream) {
  switch (d) {
    case 16: return flash_launch_t<T, 16>(a, blocks, stream);
    case 32: return flash_launch_t<T, 32>(a, blocks, stream);
    case 64: return flash_launch_t<T, 64>(a, blocks, stream);
    case 128: return flash_launch_t<T, 128>(a, blocks, stream);
    case 256: return flash_launch_t<T, 256>(a, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides,  // q, k, v, o: (sb, sh, ss) each
    int B, int H, int S, int D, int g, int causal, int window, float scale,
    cudaStream_t stream) {
  flash::Args a{q, k, v, o,
                strides[0], strides[1], strides[2],
                strides[3], strides[4], strides[5],
                strides[6], strides[7], strides[8],
                strides[9], strides[10], strides[11],
                H, S, g, causal, window, scale};
  const int blocks = B * H * ((S + flash::BQ - 1) / flash::BQ);
  return flash_launch_d<float>(a, D, blocks, stream);
}
