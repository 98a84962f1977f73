// flash_attention_tc: forward online-softmax attention for bf16 on
// Hopper's tensor cores.
//
// Replaces the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body
// _kernel) for bf16 inputs; f32 inputs keep the FMA kernel
// (flash_attention.cu), because wgmma reads f32 operands as TF32.  The
// contract is flash_attention.cu's: out = softmax(q kᵀ · D^-0.5,
// masked) v per (batch, head), causal mask (k <= q), optional window
// (k > q - window), f32 running max, normalizer and accumulator,
// max(l, 1e-30) at the end, query head h reading KV head h / g, q, k, v
// and out read and written through strides (D unit-stride, every stride
// a multiple of 8 elements, pointers 16-byte aligned), any S (the tail
// is masked; rows past S load as zeros).
//
// What bounds it: at smollm-135m's prefill shape the work is bound by
// its operations (4·S²·D/2 flops per head against 2·S·D·4 bytes);
// only wgmma reaches the card's bf16 tensor-core rate.
//
// Design: one warpgroup (128 threads) per (batch·head, 64-query tile),
// heaviest causal tiles first.  Q (64 x D) and a two-stage ring of K
// and V tiles (64 keys x D) sit in shared memory in the 128-byte swizzle
// that the wgmma descriptors name: D/64 column blocks of 64 rows x
// 128 B, the 16-byte chunk c of row r stored at chunk c ^ (r % 8), each
// block 1024-byte aligned (D < 64 is zero-padded to 64 columns).  The
// tiles arrive by cp.async 16-byte copies (zero fill past S), tile i + 1
// in flight while tile i is multiplied.  S = Q·Kᵀ is D/16 wgmma
// m64n64k16 with both operands K-major in shared memory; the f32
// fragment stays in registers, where each thread owns rows
// 16·warp + lane/4 and +8 and two columns of every 8, so the row max
// and sum need only the 4 lanes of a quad.  Scores are scaled by
// D^-0.5·log2(e) and exponentiated with exp2f; masked keys get
// probability 0, so a row with no key yet keeps l = acc = 0 without
// NaN.  P is rounded to bf16 in registers, where its fragment is the A
// operand of O += P·V (the accumulator layout of one product is the
// A-fragment layout of the next), and V is read as an MN-major operand
// (transposed through the descriptor), 64 output columns per wgmma.
// Key tiles wholly outside the causal or window range are skipped.
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "wgmma_tile.cuh"

namespace fatc {

constexpr int BQ = 64;   // query rows per block: one wgmma M
constexpr int BK = 64;   // keys per tile: one wgmma N
constexpr int NT = 128;  // one warpgroup
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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

__host__ __device__ constexpr int padded(int d) { return d < 64 ? 64 : d; }
// one 64-row tile of DP bf16 columns
__host__ __device__ constexpr int tile_bytes(int d) {
  return 64 * padded(d) * 2;
}
// Q, two K stages, two V stages, and room to align the base to 1024
__host__ __device__ constexpr int smem_bytes(int d) {
  return 5 * tile_bytes(d) + 1024;
}

using wg::desc_sw128;
using wg::sw128;

// Issue the copies of rows row0..row0+63 of one (S, D) slice into a tile.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int row0, int S,
                                          int tid) {
  constexpr int CPR = padded(D) / 8;  // 16-byte chunks per row
#pragma unroll
  for (int j = 0; j < 64 * CPR / NT; ++j) {
    const int i = tid + j * NT, r = i / CPR, cc = i % CPR, row = row0 + r;
    const bool ok = row < S && cc < D / 8;
    const __nv_bfloat16* p = ok ? src + row * ss + cc * 8 : src;
    wg::cp_async_16(dst + sw128(r, cc), p, ok);
  }
}

__device__ __forceinline__ bool visible(int kj, int qi, const Args& a) {
  bool ok = kj < a.S;
  if (a.causal) ok = ok && kj <= qi;
  if (a.window > 0) ok = ok && kj > qi - a.window;
  return ok;
}

template <int D>
__global__ void __launch_bounds__(NT) flash_tc_kernel(Args a) {
  extern __shared__ unsigned char fatc_smem[];
  constexpr int NB = padded(D) / 64;  // 64-column blocks
  constexpr int KS = padded(D) / 16;  // k-steps of Q·Kᵀ
  constexpr uint32_t TB = tile_bytes(D);
  const uint32_t base = (wg::smem_u32(fatc_smem) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + TB, sV = base + 3 * TB;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int S = a.S;
  const int n_qt = (S + BQ - 1) / BQ;
  const int BH = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / a.H, h = bh % a.H, hk = h / a.g;
  const int q0 = qt * BQ;
  const auto* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb +
                   h * a.q_sh;
  const auto* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb +
                   hk * a.k_sh;
  const auto* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb +
                   hk * a.v_sh;
  auto* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;

  // keys any row of this tile can see: [k_lo, k_hi)
  int k_lo = 0, k_hi = S;
  if (a.causal) k_hi = min(S, q0 + BQ);
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  const int kt0 = (k_lo / BK) * BK;
  const int n_tiles = (k_hi - kt0 + BK - 1) / BK;

  load_tile<D>(sQ, qp, a.q_ss, q0, S, tid);
  load_tile<D>(sK, kp, a.k_ss, kt0, S, tid);
  load_tile<D>(sV, vp, a.v_ss, kt0, S, tid);
  wg::cp_async_commit();

  // this thread's rows of the tile and its running statistics
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const int qi0 = q0 + r0, qi1 = q0 + r1;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  float o[NB][32];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  const float sl2 = a.scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kt0 + it * BK;
    const uint32_t kst = sK + (it & 1) * TB, vst = sV + (it & 1) * TB;
    if (it + 1 < n_tiles) {  // the next tile's copies overlap this one
      load_tile<D>(sK + ((it + 1) & 1) * TB, kp, a.k_ss, k0 + BK, S, tid);
      load_tile<D>(sV + ((it + 1) & 1) * TB, vp, a.v_ss, k0 + BK, S, tid);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    wg::fence_proxy_async();
    __syncthreads();

    // S = Q·Kᵀ: k-step kk reads bytes 32·(kk % 4) of column block kk / 4
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg::fence_acc(s);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      wg::wgmma_ss<0>(s, desc_sw128(sQ + off, 16, 1024),
                      desc_sw128(kst + off, 16, 1024), kk > 0);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(s);

    // mask and scale; register 4j + e holds row r0 (e < 2) or r1,
    // key column 8j + 2·quad + e % 2.  Only tiles on the diagonal, at
    // the window's edge or past S mask anything.
    const bool edge = (a.causal && k0 + BK - 1 > q0) ||
                      (a.window > 0 && k0 <= q0 + BQ - 1 - a.window) ||
                      k0 + BK > S;
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + 2 * quad + e;
        float& x0 = s[4 * j + e];
        float& x1 = s[4 * j + 2 + e];
        x0 = !edge || visible(kj, qi0, a) ? x0 * sl2 : NEG;
        x1 = !edge || visible(kj, qi1, a) ? x1 * sl2 : NEG;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    // m = NEG = m_new: rescale by 1 an l and acc that are 0
    const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x0 = s[4 * j + e];
        float& x1 = s[4 * j + 2 + e];
        x0 = x0 > 0.5f * NEG ? exp2f(x0 - n0) : 0.f;
        x1 = x1 > 0.5f * NEG ? exp2f(x1 - n1) : 0.f;
        sum0 += x0;
        sum1 += x1;
      }
    // the quad's partial sums share the row's max: reduced at the end
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[n][4 * j] *= c0;
        o[n][4 * j + 1] *= c0;
        o[n][4 * j + 2] *= c1;
        o[n][4 * j + 3] *= c1;
      }
    // P as the A operand: k-step kk (keys 16kk..16kk+15) is
    // registers 8kk..8kk+7 of the score fragment
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = wg::pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    // O += P·V: V MN-major, k-step kk at key row 16kk (2048 bytes)
#pragma unroll
    for (int n = 0; n < NB; ++n) wg::fence_acc(o[n]);
    wg::wgmma_fence();
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::wgmma_rs<1>(o[n], pa[kk],
                        desc_sw128(vst + n * 8192 + kk * 2048, 1024, 1024),
                        1);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NB; ++n) wg::fence_acc(o[n]);
    __syncthreads();  // this stage is free for the copies of tile it + 2
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * n + 8 * j + 2 * quad;
      if (col >= D) continue;
      if (qi0 < S)
        *reinterpret_cast<uint32_t*>(op + qi0 * a.o_ss + col) =
            wg::pack_bf16x2(o[n][4 * j] / d0, o[n][4 * j + 1] / d0);
      if (qi1 < S)
        *reinterpret_cast<uint32_t*>(op + qi1 * a.o_ss + col) =
            wg::pack_bf16x2(o[n][4 * j + 2] / d1, o[n][4 * j + 3] / d1);
    }
}

}  // namespace fatc

// ---- host entry point -------------------------------------------------
template <int D>
static int flash_tc_launch_d(const fatc::Args& a, int blocks,
                             cudaStream_t stream) {
  const int smem = fatc::smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(
      fatc::flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fatc::flash_tc_kernel<D><<<blocks, fatc::NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides,  // q, k, v, o: (sb, sh, ss) each
    int B, int H, int S, int D, int g, int causal, int window, float scale,
    cudaStream_t stream) {
  fatc::Args a{q, k, v, o,
               strides[0], strides[1], strides[2],
               strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8],
               strides[9], strides[10], strides[11],
               H, S, g, causal, window, scale};
  const int blocks = B * H * ((S + fatc::BQ - 1) / fatc::BQ);
  switch (D) {
    case 16: return flash_tc_launch_d<16>(a, blocks, stream);
    case 32: return flash_tc_launch_d<32>(a, blocks, stream);
    case 64: return flash_tc_launch_d<64>(a, blocks, stream);
    case 128: return flash_tc_launch_d<128>(a, blocks, stream);
    case 256: return flash_tc_launch_d<256>(a, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
