// flash_attention_ws: forward online-softmax attention in bf16 on
// Hopper's tensor cores, warp-specialised, at head dims 64, 128 and 256
// (entry flash_attention_tc_ws_launch).
//
// Replaces the Pallas kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body
// _kernel), with the contract of flash_attention_tc.cu's bf16 entry:
// out = softmax(q kᵀ · D^-0.5, masked) v per (batch, head), causal mask
// (k <= q), optional window (k > q - window), f32 running max,
// normaliser and accumulator, max(l, 1e-30) at the end, query head h
// reading KV head h / g, q, k, v and out read and written through
// strides (D unit-stride, every stride a multiple of 16 bytes, pointers
// 16-byte aligned), any S (rows past S arrive as zeros and are masked),
// bf16 out written through its own strides.
//
// What bounds it: at the serving shapes (S >= 1024, D >= 128) the work is
// bound by its operations, 4·D flops per kept (query, key) pair against
// 2·D bytes per row of q, k, v and out.  flash_attention_tc.cu's bf16
// kernel gives one warpgroup a 64-row query tile and waits on each
// product before the softmax and on the softmax before the next product,
// all 128 threads issuing the copies; at D = 256 its 161 KB of shared
// memory leave one such warpgroup on an SM, so the tensor cores idle
// through every softmax.  This kernel keeps them busy:
//
// * A block takes a 128-query tile with 384 threads: a producer
//   warpgroup that gives up its registers (setmaxnreg 24) and whose one
//   elected thread issues every copy, and two consumer warpgroups
//   (setmaxnreg 240) that own 64 query rows each.
// * Copies are TMA tile loads: the host builds 4-d tensor maps over (D,
//   S, H, B) of q, k and v from their strides (S and H ordered by stride),
//   in the 128-byte swizzle that the wgmma descriptors name, each tile as
//   D/64 boxes of 64 columns; rows past S arrive as zeros.  Q arrives once
//   a work tile (into one of two buffers where two fit); K and V stream
//   through a ring of ST stages, each with a full mbarrier (the copy's
//   bytes) and an empty one (the 8 consumer warps' release), K and V
//   apart so that Q·Kᵀ starts before V lands.
// * Inside a consumer, tile j + 1's Q·Kᵀ is issued with tile j's P·V and
//   waited with wgmma_wait<1>, so the softmax of tile j + 1 runs under
//   P·V of tile j; between the consumers, named barriers 1 and 2 take
//   turns (one consumer issues its two products, then lets the other
//   issue), so one consumer's softmax runs under the other's products.
// * Key tiles that no row of the 128-row tile sees are skipped (the
//   window's lower edge is the union over both halves); only tiles that
//   cross the causal or window edge or S mask anything, each row for
//   itself.
// * The epilogue normalises O, rounds it to bf16, stages it in the
//   consumer's half of Q's shared memory (swizzled, so the stores are
//   free of bank conflicts) and writes it with 16-byte stores, a row's
//   chunks from neighbouring threads.
//
// Tiles and grid, per head dim, as measured on an H100 (each variant in
// turns with this build at the path shapes): D = 256 takes 64-key tiles
// and two stages (Q 64 KB and the ring 128 KB; 80-key tiles, 225 KB, were
// no faster) and a block per work tile; D = 128 128-key tiles and two
// stages (Q twice, 64 KB, and the ring 128 KB; 64-key tiles were 7 %
// slower, three stages no faster) and a persistent grid of at most one
// block an SM, each walking the tile list with a stride of the grid, so
// that its next Q and K/V load while it writes the last O (14 % faster
// than a block per tile; slower at D = 256, where Q fits once, and at
// smollm-135m's D = 64, whose 288 tiles split unevenly over 132 blocks);
// D = 64 128-key tiles, three stages and a block per work tile.  S = Q·Kᵀ
// is D/16 wgmma m64nBKk16 with both operands K-major in shared memory;
// P·V is BK/16 k-steps of D/64 wgmma m64n64k16 with P from registers
// (the accumulator layout of one product is the A-fragment layout of the
// next) and V MN-major.  O is D/2 f32 registers a consumer thread (128
// at D = 256).
//
// Precision is flash_attention_tc.cu's bf16 route: exact bf16 operands,
// f32 accumulation, P (in [0, 1]) entering P·V as one bf16 part.
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "wgmma_tile.cuh"

namespace faws {

constexpr int NC = 2;              // consumer warpgroups
constexpr int BQ = 64 * NC;        // query rows per block
constexpr int NT = 128 * (NC + 1); // threads: producer + consumers
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -__builtin_huge_valf();

// keys per tile, stages of the K/V ring, and the grid at head dim D: a
// block per work tile, or (PERSIST) at most one block an SM walking them
template <int D>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int BK = 128, ST = 3;
  static constexpr bool PERSIST = false;
};
template <>
struct Tile<128> {
  static constexpr int BK = 128, ST = 2;
  static constexpr bool PERSIST = true;
};
template <>
struct Tile<256> {
  static constexpr int BK = 64, ST = 2;
  static constexpr bool PERSIST = false;
};

struct Args {
  void* o;
  long long o_sb, o_sh, o_ss;  // element strides of out's (B, H, S)
  int BH, H, S, g, causal, window;  // BH = B·H; window <= 0: none
  int q_hs, k_hs, v_hs;  // the map's dims 1 and 2 are (H, S), not (S, H)
  float scale;
};

// q, k and v as 4-d tensor maps (D, S, H, B) or (D, H, S, B)
struct Maps {
  CUtensorMap q, k, v;
};

template <int D>
__host__ __device__ constexpr uint32_t q_bytes() {
  return BQ * D * 2;
}
template <int D>
__host__ __device__ constexpr uint32_t kv_bytes() {
  return Tile<D>::BK * D * 2;
}
constexpr int SMEM_MAX = 232448;  // a block's shared memory on sm_90
// Q's buffers, their mbarriers (full and empty each), then per stage K
// full, V full, K empty and V empty, the ring, and room to align the
// base to 1024
template <int D>
__host__ __device__ constexpr int smem_bytes(int qb) {
  return qb * q_bytes<D>() + 2 * Tile<D>::ST * kv_bytes<D>() +
         8 * (2 * qb + 4 * Tile<D>::ST) + 1024;
}
// Q is double-buffered where two fit, so that a block walking tiles loads
// its next Q while it writes out the last O
template <int D>
__host__ __device__ constexpr int q_bufs() {
  return smem_bytes<D>(2) <= SMEM_MAX ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return smem_bytes<D>(q_bufs<D>());
}

__device__ __forceinline__ bool visible(int kj, int qi, const Args& a) {
  bool ok = kj < a.S;
  if (a.causal) ok = ok && kj <= qi;
  if (a.window > 0) ok = ok && kj > qi - a.window;
  return ok;
}

// The boxes of one tile: rows row0.. of (head, batch), D/64 column
// blocks of `rows` x 128 bytes from dst, completing on `bar`.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap& m,
                                          uint32_t bar, int rows, int row0,
                                          int head, int b, int hs) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
    const uint32_t at = dst + cb * rows * 128;
    if (hs)
      wg::tma_load_4d(at, &m, bar, 64 * cb, head, row0, b);
    else
      wg::tma_load_4d(at, &m, bar, 64 * cb, row0, head, b);
  }
}

// The work of one (batch·head, 128-query tile): its place and the key
// tiles any of its rows sees.  Index i of the B·H·⌈S/128⌉ tiles takes
// query tile n_qt - 1 - i / BH, so that the heaviest causal tiles come
// first.
struct Work {
  int q0, b, h, kt0, n_tiles;
};
template <int BK>
__device__ __forceinline__ Work work_of(int i, const Args& a) {
  const int n_qt = (a.S + BQ - 1) / BQ;
  Work w;
  w.q0 = (n_qt - 1 - i / a.BH) * BQ;
  w.b = (i % a.BH) / a.H;
  w.h = (i % a.BH) % a.H;
  int k_lo = 0, k_hi = a.S;  // keys any row of the tile can see
  if (a.causal) k_hi = min(a.S, w.q0 + BQ);
  if (a.window > 0) k_lo = max(0, w.q0 - a.window + 1);
  w.kt0 = (k_lo / BK) * BK;
  w.n_tiles = (k_hi - w.kt0 + BK - 1) / BK;
  return w;
}

// A block walks work tiles blockIdx.x, + gridDim.x, ... (one each when
// the grid has a block per tile).  The K/V ring, its barriers' phases,
// and the consumers' turns run on across a block's tiles; Q's buffer is
// refilled once both consumers have written their rows of O out of it.
template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_ws_kernel(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ unsigned char faws_smem[];
  constexpr int BK = Tile<D>::BK, ST = Tile<D>::ST, QB = q_bufs<D>();
  constexpr int NB = D / 64;   // 64-column blocks of a tile, and of O
  constexpr int KS = D / 16;   // k-steps of Q·Kᵀ
  constexpr int PK = BK / 16;  // k-steps of P·V
  constexpr uint32_t KVB = kv_bytes<D>();
  const uint32_t base = (wg::smem_u32(faws_smem) + 1023u) & ~1023u;
  unsigned char* const sm = faws_smem + (base - wg::smem_u32(faws_smem));
  const uint32_t sQ = base, sK = sQ + QB * q_bytes<D>(), sV = sK + ST * KVB;
  const uint32_t bars = sV + ST * KVB;
  auto q_full = [&](int b) { return bars + 8u * b; };
  auto q_empty = [&](int b) { return bars + 8u * (QB + b); };
  auto k_full = [&](int s) { return bars + 8u * (2 * QB + s); };
  auto v_full = [&](int s) { return bars + 8u * (2 * QB + ST + s); };
  auto k_empty = [&](int s) { return bars + 8u * (2 * QB + 2 * ST + s); };
  auto v_empty = [&](int s) { return bars + 8u * (2 * QB + 3 * ST + s); };
  const int n_work = a.BH * ((a.S + BQ - 1) / BQ);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int b = 0; b < QB; ++b) {
      wg::mbar_init(q_full(b), 1);
      wg::mbar_init(q_empty(b), 4 * NC);  // one arrival per consumer warp
    }
    for (int s = 0; s < ST; ++s) {
      wg::mbar_init(k_full(s), 1);
      wg::mbar_init(v_full(s), 1);
      wg::mbar_init(k_empty(s), 4 * NC);
      wg::mbar_init(v_empty(s), 4 * NC);
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one elected thread issues every copy ----
    wg::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid < 32 && wg::elect_one()) {
      int ring = 0;  // K/V tiles loaded so far
      for (int i = blockIdx.x, done = 0; i < n_work;
           i += gridDim.x, ++done) {
        const Work w = work_of<BK>(i, a);
        const int hk = w.h / a.g;
        const int qb = done % QB;
        if (done >= QB) wg::mbar_wait(q_empty(qb), (done / QB - 1) & 1);
        wg::mbar_expect_tx(q_full(qb), q_bytes<D>());
        load_tile<D>(sQ + qb * q_bytes<D>(), maps.q, q_full(qb), BQ, w.q0,
                     w.h, w.b, a.q_hs);
        for (int it = 0; it < w.n_tiles; ++it, ++ring) {
          const int s = ring % ST, ph = (ring / ST) & 1;
          const int k0 = w.kt0 + it * BK;
          wg::mbar_wait(k_empty(s), ph ^ 1);
          wg::mbar_expect_tx(k_full(s), KVB);
          load_tile<D>(sK + s * KVB, maps.k, k_full(s), BK, k0, hk, w.b,
                       a.k_hs);
          wg::mbar_wait(v_empty(s), ph ^ 1);
          wg::mbar_expect_tx(v_full(s), KVB);
          load_tile<D>(sV + s * KVB, maps.v, v_full(s), BK, k0, hk, w.b,
                       a.v_hs);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns query rows q0 + 64c .. + 63 ----
  wg::setmaxnreg_inc<CONSUMER_REGS>();
  const int c = tid / 128 - 1, t = tid % 128;
  const int warp = t / 32, lane = t % 32, quad = lane % 4;
  uint32_t sQc = 0;  // its rows of each column block of the tile's Q
  // this thread's rows of the tile: r0 and r1 = r0 + 8
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const float sl2 = a.scale * LOG2E;
  float o[NB][32];
  float s[BK / 2] = {};  // scores, then probabilities, of the newest tile
  uint32_t p[PK][4];     // P of the tile whose P·V is next, as A fragments

  // turns between the consumers: c waits on barrier 1 + c, then lets the
  // other issue; consumer 0 takes the first turn
  const int my_turn = 1 + c, other_turn = 2 - c;
  if (c == 0) wg::bar_arrive(my_turn, 256);

  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(bar);
  };
  // S = Q·Kᵀ of the tile in stage st: k-step kk reads bytes 32·(kk % 4)
  // of column block kk / 4
  auto issue_qk = [&](int st) {
    const uint32_t kst = sK + st * KVB;
    wg::fence_acc(s);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wg::wgmma_ss<0>(
          s, wg::desc_sw128(sQc + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16,
                            1024),
          wg::desc_sw128(kst + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wg::wgmma_commit();
  };
  // O += P·V of the tile in stage st: V MN-major, column block n at
  // n·BK·128 bytes, k-step kk at key row 16kk (2048 bytes)
  auto issue_pv = [&](int st) {
    const uint32_t vst = sV + st * KVB;
#pragma unroll
    for (int n = 0; n < NB; ++n) wg::fence_acc(o[n]);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
        wg::wgmma_rs<1>(o[n], p[kk],
                        wg::desc_sw128(vst + n * BK * 128 + kk * 2048, 1024,
                                       1024),
                        1);
    wg::wgmma_commit();
  };
  // retire the P·V in flight: O and P stay put until here
  auto retire_pv = [&]() {
    wg::wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NB; ++n) wg::fence_acc(o[n]);
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) wg::fence_regs(p[kk]);
  };
  // P from s as the A operand: k-step kk (keys 16kk..16kk+15) is
  // registers 8kk..8kk+7 of the score fragment
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[kk][i] = wg::pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  };

  int ring = 0;  // K/V tiles consumed so far
  for (int i = blockIdx.x, done = 0; i < n_work; i += gridDim.x, ++done) {
    const Work w = work_of<BK>(i, a);
    const int qc0 = w.q0 + 64 * c, qi0 = qc0 + r0, qi1 = qc0 + r1;
    // running max (scaled, log2 units) and normaliser of rows r0 and r1
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[n][j] = 0.f;

    // The softmax of the tile at key k0 in s: mask where the tile
    // crosses an edge, the new running max, the factors (cc0, cc1) that
    // rescale O and l, and the probabilities in s.  Register 4j + e of s
    // holds row r0 (e < 2) or r1, key column 8j + 2·quad + e % 2.
    auto softmax = [&](int k0, float& cc0, float& cc1) {
      const bool edge = (a.causal && k0 + BK - 1 > qc0) ||
                        (a.window > 0 && k0 <= qc0 + 63 - a.window) ||
                        k0 + BK > a.S;
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kj = k0 + 8 * j + 2 * quad + e;
            if (!visible(kj, qi0, a)) s[4 * j + e] = NEG_INF;
            if (!visible(kj, qi1, a)) s[4 * j + 2 + e] = NEG_INF;
          }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0 * sl2), n1 = fmaxf(m1, mx1 * sl2);
      // a row with no key yet keeps max -inf: subtract 0 there, so its
      // masked scores give 0 and its (zero) O and l a factor of 0
      const float z0 = n0 == NEG_INF ? 0.f : n0;
      const float z1 = n1 == NEG_INF ? 0.f : n1;
      cc0 = exp2f(m0 - z0);
      cc1 = exp2f(m1 - z1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x0 = s[4 * j + e];
          float& x1 = s[4 * j + 2 + e];
          x0 = exp2f(fmaf(x0, sl2, -z0));
          x1 = exp2f(fmaf(x1, sl2, -z1));
          sum0 += x0;
          sum1 += x1;
        }
      // the quad's partial sums share the row's max: reduced at the end
      l0 = l0 * cc0 + sum0;
      l1 = l1 * cc1 + sum1;
    };

    const int qb = done % QB;
    sQc = sQ + qb * q_bytes<D>() + c * 64 * 128;
    unsigned char* const sq = sm + (sQc - base);
    wg::mbar_wait(q_full(qb), (done / QB) & 1);
    // key tile 0: its Q·Kᵀ alone
    {
      const int st = ring % ST;
      wg::mbar_wait(k_full(st), (ring / ST) & 1);
      wg::bar_sync(my_turn, 256);
      wg::wgmma_fence();
      issue_qk(st);
      wg::bar_arrive(other_turn, 256);
      wg::wgmma_wait<0>();
      wg::fence_acc(s);
      release(k_empty(st));
      float cc0, cc1;
      softmax(w.kt0, cc0, cc1);
      pack_p();
    }
    // key tile it's Q·Kᵀ with tile it - 1's P·V, then tile it's softmax
    // under that P·V
    for (int it = 1; it < w.n_tiles; ++it) {
      const int cur = ring + it, st = cur % ST, pst = (cur - 1) % ST;
      wg::mbar_wait(k_full(st), (cur / ST) & 1);
      wg::bar_sync(my_turn, 256);
      wg::wgmma_fence();
      issue_qk(st);
      wg::mbar_wait(v_full(pst), ((cur - 1) / ST) & 1);
      issue_pv(pst);
      wg::bar_arrive(other_turn, 256);
      wg::wgmma_wait<1>();
      wg::fence_acc(s);
      release(k_empty(st));
      float cc0, cc1;
      softmax(w.kt0 + it * BK, cc0, cc1);
      retire_pv();
      release(v_empty(pst));
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[n][4 * j] *= cc0;
          o[n][4 * j + 1] *= cc0;
          o[n][4 * j + 2] *= cc1;
          o[n][4 * j + 3] *= cc1;
        }
      pack_p();
    }
    // the last key tile's P·V
    {
      const int last = ring + w.n_tiles - 1, pst = last % ST;
      wg::mbar_wait(v_full(pst), (last / ST) & 1);
      wg::bar_sync(my_turn, 256);
      wg::wgmma_fence();
      issue_pv(pst);
      wg::bar_arrive(other_turn, 256);
      retire_pv();
      release(v_empty(pst));
    }
    ring += w.n_tiles;

    // ---- epilogue: O / l in bf16, staged in this consumer's rows of
    // Q (no product reads them any more), then written out
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = 1.f / fmaxf(l0, 1e-30f), d1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        unsigned char* const blk = sq + n * BQ * 128 + 4 * quad;
        *reinterpret_cast<uint32_t*>(blk + r0 * 128 +
                                     ((j ^ (r0 & 7)) << 4)) =
            wg::pack_bf16x2(o[n][4 * j] * d0, o[n][4 * j + 1] * d0);
        *reinterpret_cast<uint32_t*>(blk + r1 * 128 +
                                     ((j ^ (r1 & 7)) << 4)) =
            wg::pack_bf16x2(o[n][4 * j + 2] * d1, o[n][4 * j + 3] * d1);
      }
    wg::bar_sync(3 + c, 128);
    constexpr int CPR = D / 8;  // 16-byte chunks of a row
    __nv_bfloat16* const op = static_cast<__nv_bfloat16*>(a.o) +
                              w.b * a.o_sb + w.h * a.o_sh;
#pragma unroll
    for (int j = 0; j < 64 * CPR / 128; ++j) {
      const int e = t + 128 * j, r = e / CPR, cc = e % CPR, row = qc0 + r;
      if (row < a.S)
        *reinterpret_cast<uint4*>(op + row * a.o_ss + cc * 8) =
            *reinterpret_cast<const uint4*>(sq + (cc / 8) * BQ * 128 +
                                            r * 128 +
                                            (((cc % 8) ^ (r & 7)) << 4));
    }
    // Q's buffer is free once both consumers' reads of it are ordered
    // before the next tile's TMA writes
    wg::fence_proxy_async();
    release(q_empty(qb));
  }
}

// The tensor map of one bf16 (B, H, S, D) operand with element strides
// (sb, sh, ss), boxes of 64 columns x `rows` rows; its dims 1 and 2 are
// (S, H), or (H, S) where H has the smaller stride (*hs = 1), so that the
// strides after D ascend as in the model's (B, S, H, D) layout.  `encode`
// is cuTensorMapEncodeTiled.  Returns 0, or 1 if the map is refused.
template <class Encode>
int make_map(Encode encode, CUtensorMap* m, const void* p, int B, int H,
             int S, int D, long long sb, long long sh, long long ss,
             int rows, int* hs) {
  *hs = sh < ss;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                        static_cast<cuuint64_t>(*hs ? H : S),
                        static_cast<cuuint64_t>(*hs ? S : H),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * (*hs ? sh : ss)),
                           static_cast<cuuint64_t>(2 * (*hs ? ss : sh)),
                           static_cast<cuuint64_t>(2 * sb)};
  cuuint32_t box[4] = {64, static_cast<cuuint32_t>(*hs ? 1 : rows),
                       static_cast<cuuint32_t>(*hs ? rows : 1), 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : 1;
}

// The kernel's maps and arguments for a call of the C entry, or 1 if it
// takes no such call (a head dim other than 64, 128 or 256, or a map
// refused).
template <class Encode>
int prepare(Encode encode, Maps* maps, Args* a, const void* q,
            const void* k, const void* v, void* o, const long long* st,
            int B, int H, int S, int D, int g, int causal, int window,
            float scale) {
  if (D != 64 && D != 128 && D != 256) return 1;
  const int bk = D == 64    ? Tile<64>::BK
                 : D == 128 ? Tile<128>::BK
                            : Tile<256>::BK;
  *a = Args{o,      st[9],  st[10], st[11], B * H, H, S, g,
            causal, window, 0,      0,      0,      scale};
  return make_map(encode, &maps->q, q, B, H, S, D, st[0], st[1], st[2], BQ,
                  &a->q_hs) ||
         make_map(encode, &maps->k, k, B, H / g, S, D, st[3], st[4], st[5],
                  bk, &a->k_hs) ||
         make_map(encode, &maps->v, v, B, H / g, S, D, st[6], st[7], st[8],
                  bk, &a->v_hs);
}

// work tiles of a call, and the grid that walks them at head dim D
inline int n_work(int B, int H, int S) { return B * H * ((S + BQ - 1) / BQ); }
template <int D>
int grid(int work, int sms) {
  return Tile<D>::PERSIST && sms < work ? sms : work;
}

}  // namespace faws

// ---- host entry point -------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver that the runtime has loaded
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int D>
static int flash_ws_launch_d(const faws::Maps& m, const faws::Args& a,
                             int work, int sms, cudaStream_t stream) {
  const int blocks = faws::grid<D>(work, sms), smem = faws::smem_bytes<D>();
  if (blocks == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      faws::flash_ws_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  faws::flash_ws_kernel<D><<<blocks, faws::NT, smem, stream>>>(m, a);
  return static_cast<int>(cudaGetLastError());
}

// bf16 q, k, v, out at D = 64, 128 or 256; any other D returns
// cudaErrorInvalidValue
extern "C" int flash_attention_tc_ws_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides,  // q, k, v, o: (sb, sh, ss) each
    int B, int H, int S, int D, int g, int causal, int window, float scale,
    cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  faws::Maps m;
  faws::Args a;
  if (faws::prepare(encode, &m, &a, q, k, v, o, strides, B, H, S, D, g,
                    causal, window, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int work = faws::n_work(B, H, S);
  switch (D) {
    case 64: return flash_ws_launch_d<64>(m, a, work, sms, stream);
    case 128: return flash_ws_launch_d<128>(m, a, work, sms, stream);
    default: return flash_ws_launch_d<256>(m, a, work, sms, stream);
  }
}
