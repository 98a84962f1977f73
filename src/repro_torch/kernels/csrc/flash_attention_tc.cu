// flash_attention_tc: forward online-softmax attention on Hopper's tensor
// cores, for bf16 inputs and for f32 inputs (head dim <= 128, and 256 on
// a kernel of its own, flash_tc_f32_wide_kernel).
//
// Replaces the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body
// _kernel).  The contract is
// flash_attention.cu's: out = softmax(q kᵀ · D^-0.5, masked) v per
// (batch, head), causal mask (k <= q), optional window (k > q - window),
// f32 running max, normalizer and accumulator, max(l, 1e-30) at the end,
// query head h reading KV head h / g, q, k, v and out read and written
// through strides (D unit-stride, every stride a multiple of 16 bytes,
// pointers 16-byte aligned), any S (the tail is masked; rows past S load
// as zeros).
//
// What bounds it: at smollm-135m's prefill shape the work is bound by
// its operations (4·S²·D/2 flops per head against 2·S·D bytes an
// element); only wgmma reaches the card's tensor-core rate.
//
// Precision.  wgmma multiplies bf16 operands exactly and accumulates in
// f32.  bf16 inputs are exact operands, and P (f32, in [0, 1]) enters
// P·V as one bf16 part: the bf16 limit of 3e-2 holds with it (chip_smoke
// phase 5 counts the outputs past it over 8 seeds at smollm's prefill
// shape: none).  An f32 input enters each product as three bf16 parts
// a = a0 + a1 + a2 (wg::split_parts; exact for a normal f32), and so
// does P.  Of the nine cross products the six with i + j <= 2 are kept
// (wg::for_parts): each dropped term is below 2^-27 |a b|, so a product
// keeps ~2^-25 relative, f32's own order.  The three with i + j <= 1
// (two parts) would leave up to ~3·2^-18 ≈ 1.1e-5 of each product, and
// outputs reach |o| ~ 4 at the serving shape, against an f32 limit of
// 2e-5.  3xTF32 (wgmma .tf32, k 8) would keep ~2^-21 with three products
// at half the bf16 rate, the same tensor-core time as six bf16 ones, but
// .tf32 operands cannot be transposed, so V would have to be staged
// K-major, and P's accumulator fragment is not the tf32 A-fragment
// layout; bf16 parts reuse the bf16 tiles, products and MN-major V.
// The low products are issued first, and for f32 P·V takes a fresh
// accumulator per key tile that is added to O on the CUDA cores
// (rounded to nearest), because the tensor cores' f32 accumulator loses
// low-order bits as it grows (kernels/ssd_tc_probe.py measures the same
// effect in ssd_scan_tc): a run of 16 key tiles into one accumulator
// would add ~400 such losses at |o|.  Expected error of the f32 route:
// ~1e-6 against the plain version at the JAX sweep and serving shapes,
// under the 2e-5 limit (measured on the H100: 1.9e-6).
//
// Shared memory, in tiles of 64 rows x DP = max(D, 64) columns of bf16
// (8 KB at D = 64): bf16 holds Q and two stages of K and V, one part
// each (5 tiles: 40 KB at D = 64, 160 KB at D = 256); f32 holds Q, K and
// V in three parts each and one stage (9 tiles: 72 KB at D = 64, 144 KB
// at D = 128).  A stage of K and V in three parts is 48 KB at D = 64 and
// 192 KB at D = 256: f32 at D = 256 would need 288 KB with one stage,
// over the 227 KB a block may have, so it takes its own kernel, with
// 32-key tiles (192 KB; see flash_tc_f32_wide_kernel), and a second f32
// stage (120 KB at D = 64) would halve the blocks per SM.  In its place,
// at D <= 64 the next tile's f32 K and V wait in registers (32 floats a
// thread each) while the current tile is multiplied; at D >= 128 they
// are loaded after the tile's products.
//
// Design: one warpgroup (128 threads) per (batch·head, 64-query tile),
// heaviest causal tiles first.  Tiles sit in shared memory in the
// 128-byte swizzle that the wgmma descriptors name: D/64 column blocks
// of 64 rows x 128 B, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), each block 1024-byte aligned (D < 64 is zero-padded to 64
// columns).  bf16 tiles arrive by cp.async 16-byte copies (zero fill
// past S), tile i + 1 in flight while tile i is multiplied; f32 tiles
// are read 32 bytes a chunk into registers, split into their parts there
// and stored.  S = Q·Kᵀ is D/16 wgmma m64n64k16 per kept pair of parts
// with both operands K-major in shared memory; the f32 fragment stays in
// registers, where each thread owns rows 16·warp + lane/4 and +8 and two
// columns of every 8, so the row max and sum need only the 4 lanes of a
// quad.  Scores are scaled by D^-0.5·log2(e) and exponentiated with
// exp2f; masked keys get probability 0, so a row with no key yet keeps
// l = acc = 0 without NaN.  P's parts are packed in registers, where
// their fragment is the A operand of P·V (the accumulator layout of one
// product is the A-fragment layout of the next), and V is read as an
// MN-major operand (transposed through the descriptor), 64 output
// columns per wgmma.  Key tiles wholly outside the causal or window
// range are skipped.
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"
#include "wgmma_tile.cuh"

namespace fatc {

constexpr int BQ = 64;   // query rows per block: one wgmma M
constexpr int BK = 64;   // keys per tile: one wgmma N
constexpr int NT = 128;  // one warpgroup
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int F32_MAX_D = 128;  // f32 head dims this kernel takes

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
// bf16 parts of each of Q, K and V, stages of K and V
__host__ __device__ constexpr int parts(bool f32) { return f32 ? 3 : 1; }
__host__ __device__ constexpr int stages(bool f32) { return f32 ? 1 : 2; }
// Q, the stages of K and V, and room to align the base to 1024
__host__ __device__ constexpr int smem_bytes(int d, bool f32) {
  return parts(f32) * (1 + 2 * stages(f32)) * tile_bytes(d) + 1024;
}

using wg::desc_sw128;
using wg::sw128;

// Issue the copies of rows row0..row0+63 of one bf16 (S, D) slice into a
// tile.
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

// An f32 tile of ROWS rows in registers: the 8 floats of each 16-byte
// bf16 chunk this thread stores (chunk i = tid + j·NT of the tile, row
// i / CPR).
template <int D, int ROWS = 64>
struct F32Tile {
  static constexpr int CPR = padded(D) / 8;
  static constexpr int N = ROWS * CPR / NT;
  float4 v[N][2];
};

template <int D, int ROWS = 64>
__device__ __forceinline__ void load_f32(F32Tile<D, ROWS>& t,
                                         const float* src, long long ss,
                                         int row0, int S, int tid) {
  constexpr int CPR = F32Tile<D, ROWS>::CPR;
#pragma unroll
  for (int j = 0; j < F32Tile<D, ROWS>::N; ++j) {
    const int i = tid + j * NT, r = i / CPR, cc = i % CPR, row = row0 + r;
    if (row < S && cc < D / 8) {
      const float4* p = reinterpret_cast<const float4*>(src + row * ss +
                                                        cc * 8);
      t.v[j][0] = p[0];
      t.v[j][1] = p[1];
    } else {
      t.v[j][0] = t.v[j][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Store an f32 tile as PARTS bf16 tiles of TROWS rows, part s at
// dst + s·TB, its rows from row r0 of them on.
template <int D, int PARTS, int ROWS = 64, int TROWS = 64>
__device__ __forceinline__ void store_parts(unsigned char* dst,
                                            const F32Tile<D, ROWS>& t,
                                            int tid, int r0 = 0) {
  constexpr int CPR = F32Tile<D, ROWS>::CPR;
  constexpr uint32_t TB = TROWS * padded(D) * 2;
#pragma unroll
  for (int j = 0; j < F32Tile<D, ROWS>::N; ++j) {
    const int i = tid + j * NT;
    uint32_t p[4][PARTS];
    wg::split_parts(t.v[j][0].x, t.v[j][0].y, p[0]);
    wg::split_parts(t.v[j][0].z, t.v[j][0].w, p[1]);
    wg::split_parts(t.v[j][1].x, t.v[j][1].y, p[2]);
    wg::split_parts(t.v[j][1].z, t.v[j][1].w, p[3]);
#pragma unroll
    for (int s = 0; s < PARTS; ++s)
      *reinterpret_cast<uint4*>(dst + s * TB +
                                sw128(r0 + i / CPR, i % CPR, TROWS)) =
          make_uint4(p[0][s], p[1][s], p[2][s], p[3][s]);
  }
}

__device__ __forceinline__ bool visible(int kj, int qi, const Args& a) {
  bool ok = kj < a.S;
  if (a.causal) ok = ok && kj <= qi;
  if (a.window > 0) ok = ok && kj > qi - a.window;
  return ok;
}

template <class T, int D>
__global__ void __launch_bounds__(NT) flash_tc_kernel(Args a) {
  extern __shared__ unsigned char fatc_smem[];
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int IN = parts(F32);       // parts of Q, K and V
  constexpr int PP = F32 ? 3 : 1;      // parts of P
  constexpr int ST = stages(F32);
  constexpr bool PREFETCH = F32 && D <= 64;
  constexpr int NB = padded(D) / 64;   // 64-column blocks
  constexpr int KS = padded(D) / 16;   // k-steps of Q·Kᵀ
  constexpr uint32_t TB = tile_bytes(D);
  const uint32_t base = (wg::smem_u32(fatc_smem) + 1023u) & ~1023u;
  unsigned char* const sm = fatc_smem + (base - wg::smem_u32(fatc_smem));
  // tile (part s) of Q, and of K and V in stage st
  const uint32_t sQ = base, sK = base + IN * TB, sV = sK + ST * IN * TB;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
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

  // keys any row of this tile can see: [k_lo, k_hi)
  int k_lo = 0, k_hi = S;
  if (a.causal) k_hi = min(S, q0 + BQ);
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  const int kt0 = (k_lo / BK) * BK;
  const int n_tiles = (k_hi - kt0 + BK - 1) / BK;

  [[maybe_unused]] F32Tile<D> kr, vr;  // f32: the next K and V tiles
  if constexpr (F32) {
    F32Tile<D> qr;
    load_f32<D>(qr, qp, a.q_ss, q0, S, tid);
    load_f32<D>(kr, kp, a.k_ss, kt0, S, tid);
    load_f32<D>(vr, vp, a.v_ss, kt0, S, tid);
    store_parts<D, IN>(sm + (sQ - base), qr, tid);
    store_parts<D, IN>(sm + (sK - base), kr, tid);
    store_parts<D, IN>(sm + (sV - base), vr, tid);
  } else {
    load_tile<D>(sQ, qp, a.q_ss, q0, S, tid);
    load_tile<D>(sK, kp, a.k_ss, kt0, S, tid);
    load_tile<D>(sV, vp, a.v_ss, kt0, S, tid);
    wg::cp_async_commit();
  }

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
    const uint32_t kst = sK + (it % ST) * IN * TB;
    const uint32_t vst = sV + (it % ST) * IN * TB;
    if constexpr (F32) {
      if (PREFETCH && it + 1 < n_tiles) {  // in registers during this tile
        load_f32<D>(kr, kp, a.k_ss, k0 + BK, S, tid);
        load_f32<D>(vr, vp, a.v_ss, k0 + BK, S, tid);
      }
    } else if (it + 1 < n_tiles) {  // the next tile's copies overlap this one
      load_tile<D>(sK + ((it + 1) % ST) * TB, kp, a.k_ss, k0 + BK, S, tid);
      load_tile<D>(sV + ((it + 1) % ST) * TB, vp, a.v_ss, k0 + BK, S, tid);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    wg::fence_proxy_async();
    __syncthreads();

    // S = Q·Kᵀ over the kept pairs of parts: k-step kk reads bytes
    // 32·(kk % 4) of column block kk / 4
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg::fence_acc(s);
    wg::wgmma_fence();
    wg::for_parts<IN, IN>([&](int pi, int pj, bool first) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
        wg::wgmma_ss<0>(s, desc_sw128(sQ + pi * TB + off, 16, 1024),
                        desc_sw128(kst + pj * TB + off, 16, 1024),
                        !(first && kk == 0));
      }
    });
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
    // P as the A operand, in PP parts: k-step kk (keys 16kk..16kk+15) is
    // registers 8kk..8kk+7 of the score fragment
    uint32_t pa[4][4][PP];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wg::split_parts(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1],
                        pa[kk][i]);

    // O += P·V: V MN-major, k-step kk at key row 16kk (2048 bytes).  bf16
    // rescales O and accumulates into it; f32 takes a fresh accumulator
    // per key tile and adds it to the rescaled O on the CUDA cores.
    float pv[NB][32];  // f32 only
    float (&acc)[NB][32] = F32 ? pv : o;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[n][4 * j] *= c0;
        o[n][4 * j + 1] *= c0;
        o[n][4 * j + 2] *= c1;
        o[n][4 * j + 3] *= c1;
      }
#pragma unroll
    for (int n = 0; n < NB; ++n) wg::fence_acc(acc[n]);
    wg::wgmma_fence();
    wg::for_parts<PP, IN>([&](int pi, int pj, bool first) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t frag[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) frag[i] = pa[kk][i][pi];
          wg::wgmma_rs<1>(acc[n], frag,
                          desc_sw128(vst + pj * TB + n * 8192 + kk * 2048,
                                     1024, 1024),
                          !(F32 && first && kk == 0));
        }
    });
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NB; ++n) wg::fence_acc(acc[n]);
    if constexpr (F32) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[n][i] += pv[n][i];
    }
    __syncthreads();  // this stage is free for the next tiles
    if constexpr (F32) {
      if (it + 1 < n_tiles) {
        if (!PREFETCH) load_f32<D>(kr, kp, a.k_ss, k0 + BK, S, tid);
        store_parts<D, IN>(sm + (sK - base), kr, tid);
        if (!PREFETCH) load_f32<D>(vr, vp, a.v_ss, k0 + BK, S, tid);
        store_parts<D, IN>(sm + (sV - base), vr, tid);
      }
    }
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
      const float v00 = o[n][4 * j] / d0, v01 = o[n][4 * j + 1] / d0;
      const float v10 = o[n][4 * j + 2] / d1, v11 = o[n][4 * j + 3] / d1;
      if constexpr (F32) {
        if (qi0 < S)
          *reinterpret_cast<float2*>(op + qi0 * a.o_ss + col) =
              make_float2(v00, v01);
        if (qi1 < S)
          *reinterpret_cast<float2*>(op + qi1 * a.o_ss + col) =
              make_float2(v10, v11);
      } else {
        if (qi0 < S)
          *reinterpret_cast<uint32_t*>(op + qi0 * a.o_ss + col) =
              wg::pack_bf16x2(v00, v01);
        if (qi1 < S)
          *reinterpret_cast<uint32_t*>(op + qi1 * a.o_ss + col) =
              wg::pack_bf16x2(v10, v11);
      }
    }
}


// f32 at D = 256 (flash_attention_tc_f32_256_launch): the same three
// bf16 parts, six cross products and fresh P·V accumulators, tiled to
// fit a block's 227 KB.  Q in three parts is 3 x 32 KB; K and V come in
// tiles of BK256 = 32 keys, 3 x 16 KB each, one stage: 192 KB.  S =
// Q·Kᵀ is 16 k-steps of wgmma m64n32k16 a pair of parts (16 f32
// registers a thread); P·V runs in four 64-column slices of O, each a
// fresh accumulator of 32 registers added to O (128 registers a thread)
// on the CUDA cores.  The next tile's K and V are read into registers
// and split after the tile's products (no room for a second stage), Q
// in two halves of 32 rows.
constexpr int BK256 = 32;      // keys per tile
constexpr int F32_WIDE_D = 256;

__host__ __device__ constexpr int smem_bytes_f32_wide() {
  return 3 * tile_bytes(F32_WIDE_D) + 2 * 3 * (tile_bytes(F32_WIDE_D) / 2) +
         1024;
}

// One 32-row f32 tile of `src` from row `row0`, stored as three bf16 parts
// of TROWS-row tiles at `dst`, from row r0 of them.
template <int TROWS>
__device__ __forceinline__ void stage_wide(unsigned char* dst,
                                           const float* src, long long ss,
                                           int row0, int r0, int S, int tid) {
  F32Tile<F32_WIDE_D, 32> t;
  load_f32<F32_WIDE_D, 32>(t, src, ss, row0, S, tid);
  store_parts<F32_WIDE_D, 3, 32, TROWS>(dst, t, tid, r0);
}

__global__ void __launch_bounds__(NT) flash_tc_f32_wide_kernel(Args a) {
  extern __shared__ unsigned char fatc_smem[];
  constexpr int D = F32_WIDE_D, IN = 3;
  constexpr int NB = D / 64;   // 64-column slices of O
  constexpr int KS = D / 16;   // k-steps of Q·Kᵀ
  constexpr uint32_t TQ = tile_bytes(D), TK = TQ / 2;
  const uint32_t base = (wg::smem_u32(fatc_smem) + 1023u) & ~1023u;
  unsigned char* const sm = fatc_smem + (base - wg::smem_u32(fatc_smem));
  // part s of Q at sQ + s·TQ, of K at sK + s·TK, of V at sV + s·TK
  const uint32_t sQ = base, sK = base + IN * TQ, sV = sK + IN * TK;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int S = a.S;
  const int n_qt = (S + BQ - 1) / BQ;
  const int BH = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / a.H, h = bh % a.H, hk = h / a.g;
  const int q0 = qt * BQ;
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  // keys any row of this tile can see: [k_lo, k_hi)
  int k_lo = 0, k_hi = S;
  if (a.causal) k_hi = min(S, q0 + BQ);
  if (a.window > 0) k_lo = max(0, q0 - a.window + 1);
  const int kt0 = (k_lo / BK256) * BK256;
  const int n_tiles = (k_hi - kt0 + BK256 - 1) / BK256;

  // Q in two halves of 32 rows, then the first K and V tiles
  stage_wide<BQ>(sm, qp, a.q_ss, q0, 0, S, tid);
  stage_wide<BQ>(sm, qp, a.q_ss, q0 + 32, 32, S, tid);
  stage_wide<BK256>(sm + (sK - base), kp, a.k_ss, kt0, 0, S, tid);
  stage_wide<BK256>(sm + (sV - base), vp, a.v_ss, kt0, 0, S, tid);

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
    const int k0 = kt0 + it * BK256;
    wg::fence_proxy_async();
    __syncthreads();

    // S = Q·Kᵀ over the kept pairs of parts: k-step kk reads bytes
    // 32·(kk % 4) of column block kk / 4 (Q's 64 rows, K's 32)
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    wg::fence_acc(s);
    wg::wgmma_fence();
    wg::for_parts<IN, IN>([&](int pi, int pj, bool first) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wg::wgmma_ss_n32(
            s, desc_sw128(sQ + pi * TQ + (kk / 4) * 8192 + (kk % 4) * 32, 16,
                          1024),
            desc_sw128(sK + pj * TK + (kk / 4) * 4096 + (kk % 4) * 32, 16,
                       1024),
            !(first && kk == 0));
    });
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(s);

    // mask and scale; register 4j + e holds row r0 (e < 2) or r1, key
    // column 8j + 2·quad + e % 2
    const bool edge = (a.causal && k0 + BK256 - 1 > q0) ||
                      (a.window > 0 && k0 <= q0 + BQ - 1 - a.window) ||
                      k0 + BK256 > S;
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < 4; ++j)
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
    const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x0 = s[4 * j + e];
        float& x1 = s[4 * j + 2 + e];
        x0 = x0 > 0.5f * NEG ? exp2f(x0 - n0) : 0.f;
        x1 = x1 > 0.5f * NEG ? exp2f(x1 - n1) : 0.f;
        sum0 += x0;
        sum1 += x1;
      }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    // P as the A operand in three parts: k-step kk (keys 16kk..16kk+15)
    // is registers 8kk..8kk+7 of the score fragment
    uint32_t pa[2][4][IN];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wg::split_parts(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1],
                        pa[kk][i]);

    // O += P·V a 64-column slice at a time: V MN-major, slice n in
    // column block n (4096 bytes), k-step kk at key row 16kk (2048
    // bytes); a fresh accumulator per slice, added to the rescaled O
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[n][4 * j] *= c0;
        o[n][4 * j + 1] *= c0;
        o[n][4 * j + 2] *= c1;
        o[n][4 * j + 3] *= c1;
      }
      float pv[32];
      wg::fence_acc(pv);
      wg::wgmma_fence();
      wg::for_parts<IN, IN>([&](int pi, int pj, bool first) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t frag[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) frag[i] = pa[kk][i][pi];
          wg::wgmma_rs<1>(pv, frag,
                          desc_sw128(sV + pj * TK + n * 4096 + kk * 2048,
                                     1024, 1024),
                          !(first && kk == 0));
        }
      });
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_acc(pv);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] += pv[i];
    }
    __syncthreads();  // the stage is free for the next tile
    if (it + 1 < n_tiles) {
      stage_wide<BK256>(sm + (sK - base), kp, a.k_ss, k0 + BK256, 0, S, tid);
      stage_wide<BK256>(sm + (sV - base), vp, a.v_ss, k0 + BK256, 0, S, tid);
    }
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
      if (qi0 < S)
        *reinterpret_cast<float2*>(op + qi0 * a.o_ss + col) =
            make_float2(o[n][4 * j] / d0, o[n][4 * j + 1] / d0);
      if (qi1 < S)
        *reinterpret_cast<float2*>(op + qi1 * a.o_ss + col) =
            make_float2(o[n][4 * j + 2] / d1, o[n][4 * j + 3] / d1);
    }
}

}  // namespace fatc

// ---- host entry point -------------------------------------------------
template <class T, int D>
static int flash_tc_launch_d(const fatc::Args& a, int blocks,
                             cudaStream_t stream) {
  const int smem = fatc::smem_bytes(D, std::is_same<T, float>::value);
  cudaError_t e = cudaFuncSetAttribute(
      fatc::flash_tc_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fatc::flash_tc_kernel<T, D><<<blocks, fatc::NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
static int flash_tc_launch_t(const void* q, const void* k, const void* v,
                             void* o, const long long* strides, int B,
                             int H, int S, int D, int g, int causal,
                             int window, float scale, cudaStream_t stream) {
  fatc::Args a{q, k, v, o,
               strides[0], strides[1], strides[2],
               strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8],
               strides[9], strides[10], strides[11],
               H, S, g, causal, window, scale};
  const int blocks = B * H * ((S + fatc::BQ - 1) / fatc::BQ);
  constexpr bool f32 = std::is_same<T, float>::value;
  switch (D) {
    case 16: return flash_tc_launch_d<T, 16>(a, blocks, stream);
    case 32: return flash_tc_launch_d<T, 32>(a, blocks, stream);
    case 64: return flash_tc_launch_d<T, 64>(a, blocks, stream);
    case 128: return flash_tc_launch_d<T, 128>(a, blocks, stream);
    case 256:
      if constexpr (!f32) return flash_tc_launch_d<T, 256>(a, blocks, stream);
      [[fallthrough]];
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 q, k, v, out
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides,  // q, k, v, o: (sb, sh, ss) each
    int B, int H, int S, int D, int g, int causal, int window, float scale,
    cudaStream_t stream) {
  return flash_tc_launch_t<__nv_bfloat16>(q, k, v, o, strides, B, H, S, D,
                                          g, causal, window, scale, stream);
}

// f32 q, k, v, out; D <= fatc::F32_MAX_D
extern "C" int flash_attention_tc_f32_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, int B, int H, int S, int D, int g, int causal,
    int window, float scale, cudaStream_t stream) {
  return flash_tc_launch_t<float>(q, k, v, o, strides, B, H, S, D, g,
                                  causal, window, scale, stream);
}

// f32 q, k, v, out at D = fatc::F32_WIDE_D (the kernel of that width)
extern "C" int flash_attention_tc_f32_256_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, int B, int H, int S, int D, int g, int causal,
    int window, float scale, cudaStream_t stream) {
  if (D != fatc::F32_WIDE_D) return static_cast<int>(cudaErrorInvalidValue);
  fatc::Args a{q, k, v, o,
               strides[0], strides[1], strides[2],
               strides[3], strides[4], strides[5],
               strides[6], strides[7], strides[8],
               strides[9], strides[10], strides[11],
               H, S, g, causal, window, scale};
  const int blocks = B * H * ((S + fatc::BQ - 1) / fatc::BQ);
  const int smem = fatc::smem_bytes_f32_wide();
  cudaError_t e = cudaFuncSetAttribute(
      fatc::flash_tc_f32_wide_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fatc::flash_tc_f32_wide_kernel<<<blocks, fatc::NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
