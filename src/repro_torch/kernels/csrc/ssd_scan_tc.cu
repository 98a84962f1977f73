// ssd_scan_tc: Mamba2 SSD chunked scan (dual form) on Hopper's tensor
// cores, for bf16 and f32 inputs.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:68
// ssd_scan_pallas (body _kernel), with the initial state of the function
// it stands for, repro/models/ssm.py::ssd_chunked, at chunk 64 or 128,
// P <= 64 and N <= 128 (multiples of 8); other f32 shapes keep the FMA
// kernel (ssd_scan.cu).  The contract is ssd_scan.cu's: per (batch,
// head), chunks of Q steps,
//   da_cum = cumsum(dt · A)
//   y      = ((C Bᵀ) ∘ L ∘ dt) x + exp(da_cum) · (C carryᵀ),
//            L[i, j] = exp(da_cum[i] - da_cum[j]) for j <= i, else 0
//   carry  = carry · exp(da_cum[-1]) + (x · dt · exp(da_cum[-1] - da_cum))ᵀ B
// with B and C shared by all heads (g = 1), the f32 carry starting at
// init (or 0) and ending in fin, x, B and C read through strides (unit
// last stride, other strides multiples of 16 bytes, data 16-byte
// aligned), y contiguous, and any S: steps past the end load dt = 0 and
// x = B = C = 0 (decay 1, no input) and their y is not stored.
//
// What bounds it: bytes.  At mamba2-1.3b's prefill (4 x 1024 steps, 64
// heads of P = 64, N = 128, Q = 128) the function reads x, dt, B and C
// and writes y and the final state once: 78.6 MB in bf16 (0.0235 ms at
// 3.35 TB/s), 147.8 MB in f32 (0.044 ms).  The products, in the parts
// below and tiled as the kernel tiles them, are ~42 GFLOP (bf16) and ~55
// GFLOP (f32) of bf16 work, 0.04-0.06 ms at the tensor-core peak, so the
// kernel sits near the line between the two bounds; only wgmma gets the
// products that low, and only chunks run in parallel keep enough loads
// in flight.
//
// Design: the unit of work is (batch, chunk, head), so every chunk runs
// in parallel; only the carry is serial.  A block is Q/64 warpgroups;
// warpgroup w owns chunk rows 64w..64w+63.  C, B and the head's x arrive
// in the 128-byte swizzle that the wgmma descriptors name (P, N < 64
// zero-padded to 64 columns): bf16 by 16-byte cp.async, f32 read into
// registers and stored as its parts.  Each block:
//   * C·Bᵀ on wgmma (K-major operands, key tiles above the diagonal
//     skipped), kept in registers;
//   * da_cum by a block scan (warp shuffles, then the warps' totals);
//   * y_diag = M·x, M = (C·Bᵀ) ∘ L ∘ dt built in the accumulator
//     registers (the exponent only on and below the diagonal), as the
//     register A operand of wgmma, x as an MN-major B;
//   * the chunk's own state S_c = (x·dt·exp(da_cum[-1] - da_cum))ᵀ B,
//     P x N over depth Q: the scaled x is read transposed from the x
//     tiles into A fragments in registers, B is an MN-major operand;
//   * the chain: the block waits until chunk c - 1 of the head has
//     published (acquire load of its flag), each owner of an S_c entry
//     reads carry_in from fin (L2) and writes carry_out = carry_in ·
//     exp(da_cum[-1]) + S_c back in place, then the block publishes
//     chunk c (__threadfence, barrier, release store).  The carry stays
//     f32 in fin, and the link of the chain holds no product;
//   * y_off = exp(da_cum) · (C · carry_inᵀ), carry_in as K-major B
//     tiles; y = y_diag + y_off stored in the input's type.
// Precision.  Every operand enters its products as bf16 parts
// (wg::split_parts), and of the cross products those with i + j below
// the larger part count are kept (wg::for_parts).  bf16: x, B and C are
// exact as one part; M, the scaled x and carry_in are f32 and enter as
// three parts (24 bits).  A single bf16 part moves y by ~2^-9 relative,
// which rounds hundreds of outputs with |y| >= 16 one ulp (0.125) away,
// past the 1e-1 limit.  f32: every operand enters as two parts, and the
// three products with i + j <= 1 leave ~2^-17 of each (an error of
// ~1e-4 at |y| ~ 37, against the f32 limit of 1e-3); three parts of x,
// B and C would need 240 KB of shared memory at Q = 128, N = 128.
// The tensor cores' f32 accumulator loses low-order bits as it grows, so
// a long run of products into one accumulator drifts toward zero: the
// low products are issued first, while the accumulator is small, and
// each k-step of C·Bᵀ, each key tile of M·x and each pair of parts of
// C·carry_inᵀ goes to a fresh accumulator that is added on the CUDA
// cores (rounded to nearest).  On the H100 (80GB HBM3, 700 W) this takes
// the outputs past 1e-1 at mamba2's prefill shape over 8 seeds from 6
// to none, and the mean f32 error at |y| >= 16 from 3.1x the plain
// version's to 1.3x, for +10 % of the kernel's time; each of the three
// alone leaves some, and natural-unit exponents, an in-order scan or an
// f64 scan are not needed for none (python -m
// repro_torch.kernels.ssd_tc_probe measures each choice).
// Blocks per SM: bf16 runs two (at most 128 registers a thread at
// Q = 128): the block's phases wait on one another, so a second block is
// what hides their latency.  f32 at Q = 128, N = 128 needs 163 KB of
// shared memory and runs one.  Sharing C·Bᵀ among several heads of a
// block was no faster on the card (PERF.md), so a block serves one head.
// A block takes its (chunk, batch, head) from an atomic ticket,
// chunk-major, not from blockIdx: every block of chunk c - 1 took its
// ticket, and so is resident, before any block of chunk c, so a block
// never waits on one that has not started, whatever the dispatch
// order.  The wrapper zeroes the ticket and the flags (sync) and
// allocates fin; the kernel allocates nothing.
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"
#include "wgmma_tile.cuh"

namespace ssdtc {

using wg::desc_sw128;
using wg::sw128;

constexpr float LOG2E = 1.4426950408889634f;
constexpr bool LOW_FIRST = true;  // the products' order (Precision)

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* init;  // (B, H, P, N) or null for a zero state
  void* y;            // (B, S, H, P), contiguous
  float* fin;         // (B, H, P, N), contiguous: the carry after each chunk
  int* sync;          // [0] ticket, [1 + b·H + h] chunks of (b, h) published
  long long x_sb, x_ss, x_sh;  // element strides; P is unit
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;        // N is unit
  long long c_sb, c_ss;
  int batch, S, H, P, N;
};

// bf16 parts of the inputs x, B and C, and of the f32 operands M, the
// scaled x and carry_in (Precision)
__host__ __device__ constexpr int in_parts(bool f32) { return f32 ? 2 : 1; }
__host__ __device__ constexpr int op_parts(bool f32) { return f32 ? 2 : 3; }

// Shared memory, byte offsets from the 1024-aligned base: the C and B
// tiles (Q rows x NB column blocks of 128 B, `in` parts each), the x
// tiles (Q rows x 128 B, `in` parts) and a region R.  During the
// chunk-local phase R holds dt, da_cum, the scaled x's row factors, the
// scan's warp totals and the ticket; after the chain it holds the
// carry's `op` bf16 parts (64 rows x NB blocks each), as many of them in
// the x tiles as fit.
struct Layout {
  int c, b, x, r, carry[3], bytes;
};
__host__ __device__ constexpr Layout layout(int q, int nb, int in, int op) {
  const int tcb = q * nb * 128, xb = q * 128, ct = nb * 8192;
  const int x = 2 * in * tcb, r = x + in * xb;
  const int fit = in * xb / ct < op ? in * xb / ct : op;
  const int rest = r + (op - fit) * ct, rb = r + (3 * q + 5) * 4;
  Layout L{0, in * tcb, x, r, {0, 0, 0}, rest > rb ? rest : rb};
  for (int s = 0; s < op; ++s)
    L.carry[s] = s < fit ? x + s * ct : r + (s - fit) * ct;
  return L;
}
__host__ __device__ constexpr int smem_bytes(int q, int nb, bool f32) {
  return layout(q, nb, in_parts(f32), op_parts(f32)).bytes +
         1024;  // room to align the base
}
// blocks an SM runs: two where their shared memory fits
__host__ __device__ constexpr int min_blocks(int q, int nb, bool f32) {
  return 2 * smem_bytes(q, nb, f32) <= 232448 ? 2 : 1;
}

// Issue the copies of rows row0..row0+ROWS-1 (CPR 16-byte chunks each,
// the first `valid` of them real, the rest zero) of a bf16 slice into a
// tile.
template <int ROWS, int CPR, int NT>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int row0, int S,
                                          int valid, int tid) {
#pragma unroll
  for (int j = 0; j < ROWS * CPR / NT; ++j) {
    const int i = tid + j * NT, r = i / CPR, cc = i % CPR, row = row0 + r;
    const bool ok = row < S && cc < valid;
    const __nv_bfloat16* p = ok ? src + row * ss + cc * 8 : src;
    wg::cp_async_16(dst + sw128(r, cc, ROWS), p, ok);
  }
}

// The same rows of an f32 slice, read 8 floats a chunk and stored as
// PARTS bf16 tiles, part s at dst + s·part_bytes.
template <int ROWS, int CPR, int NT, int PARTS>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          int part_bytes, const float* src,
                                          long long ss, int row0, int S,
                                          int valid, int tid) {
#pragma unroll 4
  for (int j = 0; j < ROWS * CPR / NT; ++j) {
    const int i = tid + j * NT, r = i / CPR, cc = i % CPR, row = row0 + r;
    float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
    if (row < S && cc < valid) {
      const float4* p = reinterpret_cast<const float4*>(src + row * ss +
                                                        cc * 8);
      v0 = p[0];
      v1 = p[1];
    }
    uint32_t q[4][PARTS];
    wg::split_parts(v0.x, v0.y, q[0]);
    wg::split_parts(v0.z, v0.w, q[1]);
    wg::split_parts(v1.x, v1.y, q[2]);
    wg::split_parts(v1.z, v1.w, q[3]);
#pragma unroll
    for (int s = 0; s < PARTS; ++s)
      *reinterpret_cast<uint4*>(dst + s * part_bytes + sw128(r, cc, ROWS)) =
          make_uint4(q[0][s], q[1][s], q[2][s], q[3][s]);
  }
}

template <class T, int Q, int NB>
__global__ void __launch_bounds__(2 * Q,
                                  min_blocks(Q, NB,
                                             std::is_same<T, float>::value))
    ssd_tc_kernel(Args a) {
  extern __shared__ unsigned char ssdtc_smem[];
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int IN = in_parts(F32), OP = op_parts(F32);
  constexpr int NT = 2 * Q;
  constexpr int NWG = Q / 64;               // warpgroups
  constexpr int NU = (NB + NWG - 1) / NWG;  // S_c column tiles a wg owns
  constexpr int TCB = Q * NB * 128;         // one part of C or B
  constexpr int XB = Q * 128;               // one part of x
  constexpr Layout L = layout(Q, NB, IN, OP);
  const uint32_t base = (wg::smem_u32(ssdtc_smem) + 1023u) & ~1023u;
  unsigned char* const sm = ssdtc_smem + (base - wg::smem_u32(ssdtc_smem));
  const uint32_t sC = base + L.c, sB = base + L.b, sX = base + L.x;
  float* dts = reinterpret_cast<float*>(sm + L.r);
  float* dcs = dts + Q;   // da_cum · log2(e): exponents for exp2f
  float* wts = dcs + Q;   // dt·exp(da_cum[-1] - da_cum), the x row factors
  float* wsum = wts + Q;  // the scan's warp totals (Q / 32 <= 4)
  int* tick = reinterpret_cast<int*>(wsum + 4);

  const int tid = threadIdx.x, w = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, quad = lane % 4;
  const int S = a.S, P = a.P, N = a.N;
  if (tid == 0) *tick = atomicAdd(a.sync, 1);
  __syncthreads();
  const int ticket = *tick;
  const int c = ticket / (a.batch * a.H);
  const int b = ticket % (a.batch * a.H) / a.H;
  const int h = ticket % a.H;
  const int s0 = c * Q;

  const T* xg = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const T* bg = static_cast<const T*>(a.Bm) + b * a.b_sb;
  const T* cg = static_cast<const T*>(a.Cm) + b * a.c_sb;
  if (tid < Q)
    dts[tid] = s0 + tid < S
                   ? a.dt[b * a.dt_sb + (s0 + tid) * a.dt_ss + h * a.dt_sh]
                   : 0.f;
  if constexpr (F32) {
    load_rows<Q, NB * 8, NT, IN>(sm + L.c, TCB, cg, a.c_ss, s0, S, N / 8,
                                 tid);
    load_rows<Q, NB * 8, NT, IN>(sm + L.b, TCB, bg, a.b_ss, s0, S, N / 8,
                                 tid);
    load_rows<Q, 8, NT, IN>(sm + L.x, XB, xg, a.x_ss, s0, S, P / 8, tid);
  } else {
    load_rows<Q, NB * 8, NT>(sC, cg, a.c_ss, s0, S, N / 8, tid);
    load_rows<Q, NB * 8, NT>(sB, bg, a.b_ss, s0, S, N / 8, tid);
    load_rows<Q, 8, NT>(sX, xg, a.x_ss, s0, S, P / 8, tid);
    wg::cp_async_commit();
    wg::cp_async_wait<0>();
  }
  wg::fence_proxy_async();
  __syncthreads();

  // this thread's chunk rows (r0, r0 + 8) in every 64-row fragment
  const int r0 = 64 * w + 16 * warp + lane / 4;

  // C·Bᵀ: k-step kk is bytes 32·(kk % 4) of column block kk / 4; each
  // k-step's products go to a fresh accumulator, added on the CUDA cores
  float cb[NWG][32];  // C·Bᵀ rows of warpgroup w, key tiles j <= w
#pragma unroll
  for (int j = 0; j < NWG; ++j) {
    if (j > w) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) cb[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const uint32_t off = (kk / 4) * Q * 128 + (kk % 4) * 32;
      float f[32];
      wg::fence_acc(f);
      wg::wgmma_fence();
      wg::for_parts<IN, IN, LOW_FIRST>([&](int pi, int pj, bool first) {
        wg::wgmma_ss<0>(f, desc_sw128(sC + pi * TCB + off + w * 8192, 16,
                                      1024),
                        desc_sw128(sB + pj * TCB + off + j * 8192, 16, 1024),
                        !first);
      });
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_acc(f);
#pragma unroll
      for (int i = 0; i < 32; ++i) cb[j][i] += f[i];
    }
  }

  // da_cum: an inclusive scan of dt·A over the chunk, in log2 units;
  // every thread takes part in the shuffles
  const float A = a.A[h] * LOG2E;
  float v = tid < Q ? dts[tid] * A : 0.f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31 && tid < Q) wsum[tid / 32] = v;
  __syncthreads();
  if (tid < Q) {
    for (int k = 0; k < tid / 32; ++k) v += wsum[k];
    dcs[tid] = v;
  }
  __syncthreads();
  const float dend = dcs[Q - 1];
  if (tid < Q) wts[tid] = dts[tid] * exp2f(dend - dcs[tid]);

  // y_diag = M·x by key tile j <= w, each tile's products in a fresh
  // accumulator added to y_diag on the CUDA cores; k-step kk of tile j is
  // registers 8kk..8kk+7 of M's fragment and chunk rows 64j + 16kk of x
  float yd[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yd[i] = 0.f;
  const float dr0 = dcs[r0], dr1 = dcs[r0 + 8];
#pragma unroll
  for (int j = 0; j < NWG; ++j) {
    if (j > w) continue;
    float m[32];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 64 * j + 8 * jj + 2 * quad + e;
        const float dc = dcs[col], dtc = dts[col];
        m[4 * jj + e] =
            col <= r0 ? cb[j][4 * jj + e] * exp2f(dr0 - dc) * dtc : 0.f;
        m[4 * jj + 2 + e] =
            col <= r0 + 8 ? cb[j][4 * jj + 2 + e] * exp2f(dr1 - dc) * dtc
                          : 0.f;
      }
    uint32_t pa[4][4][OP];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wg::split_parts(m[8 * kk + 2 * i], m[8 * kk + 2 * i + 1],
                        pa[kk][i]);
    float f[32];
    wg::fence_acc(f);
    wg::wgmma_fence();
    wg::for_parts<OP, IN, LOW_FIRST>([&](int pi, int pj, bool first) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t frag[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) frag[i] = pa[kk][i][pi];
        wg::wgmma_rs<1>(f, frag,
                        desc_sw128(sX + pj * XB + (4 * j + kk) * 2048, 1024,
                                   1024),
                        !(first && kk == 0));
      }
    });
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(f);
#pragma unroll
    for (int i = 0; i < 32; ++i) yd[i] += f[i];
  }
  __syncthreads();  // the row factors wts

  // S_c = (x·wts)ᵀ B: rows p, column tile t = w + NWG·u of 64 n; the A
  // fragment of k-step kk holds rows p = 16·warp + lane/4 (+8) and chunk
  // rows 16kk + 2·quad (+1, +8, +9), read transposed from the x tiles
  float st[NU][32];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
#pragma unroll
    for (int i = 0; i < 32; ++i) st[u][i] = 0.f;
    wg::fence_acc(st[u]);
  }
  if (w < NB) {
#pragma unroll
    for (int k0 = 0; k0 < Q / 16; k0 += 4) {
      uint32_t xa[4][4][OP];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = 16 * warp + lane / 4 + 8 * (i % 2);
          const int j = 16 * (k0 + kk) + 2 * quad + 8 * (i / 2);
          float x0 = 0.f, x1 = 0.f;
#pragma unroll
          for (int s = 0; s < IN; ++s) {
            x0 += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                sm + L.x + s * XB + sw128(j, p / 8, Q) + 2 * (p % 8)));
            x1 += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                sm + L.x + s * XB + sw128(j + 1, p / 8, Q) + 2 * (p % 8)));
          }
          wg::split_parts(x0 * wts[j], x1 * wts[j + 1], xa[kk][i]);
        }
      wg::wgmma_fence();
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int t = w + NWG * u;
        if (t >= NB) continue;
        wg::for_parts<OP, IN, LOW_FIRST>([&](int pi, int pj, bool first) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t frag[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) frag[i] = xa[kk][i][pi];
            wg::wgmma_rs<1>(st[u], frag,
                            desc_sw128(sB + pj * TCB + t * Q * 128 +
                                           (k0 + kk) * 2048,
                                       1024, 1024),
                            1);
          }
        });
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < NU; ++u) wg::fence_acc(st[u]);
    }
  }

  // the chain: carry_in is chunk c - 1's carry_out of this head; st
  // takes carry_in once carry_out is written
  int* flag = a.sync + 1 + b * a.H + h;
  if (tid == 0 && c > 0) {
    while (wg::ld_acquire(flag) < c) {
    }
    __threadfence();
  }
  __syncthreads();  // also: no warpgroup reads the x tiles any more
  const float decay = exp2f(dend);
  const long long head = (1LL * b * a.H + h) * P * N;
  float* fin = a.fin + head;
  const float* init = a.init ? a.init + head : nullptr;
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int t = w + NWG * u;
    if (t >= NB) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int p = 16 * warp + lane / 4 + 8 * hr;
        const int n = 64 * t + 8 * jj + 2 * quad;
        float& e0 = st[u][4 * jj + 2 * hr];
        float& e1 = st[u][4 * jj + 2 * hr + 1];
        float c0 = 0.f, c1 = 0.f;
        if (p < P && n < N) {
          const long long k = 1LL * p * N + n;
          if (c > 0) {
            const float2 cv =
                __ldcg(reinterpret_cast<const float2*>(fin + k));
            c0 = cv.x;
            c1 = cv.y;
          } else if (init) {
            c0 = init[k];
            c1 = init[k + 1];
          }
          fin[k] = c0 * decay + e0;
          fin[k + 1] = c1 * decay + e1;
        }
        e0 = c0;
        e1 = c1;
      }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) wg::st_release(flag, c + 1);

  // carry_in in OP bf16 parts, K-major B tiles of y_off (rows p,
  // columns n)
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int t = w + NWG * u;
    if (t >= NB) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int p = 16 * warp + lane / 4 + 8 * hr;
        const uint32_t off = sw128(p, 8 * t + jj) + 4 * quad;
        uint32_t q[OP];
        wg::split_parts(st[u][4 * jj + 2 * hr], st[u][4 * jj + 2 * hr + 1],
                        q);
#pragma unroll
        for (int s = 0; s < OP; ++s)
          *reinterpret_cast<uint32_t*>(sm + L.carry[s] + off) = q[s];
      }
  }
  wg::fence_proxy_async();
  __syncthreads();

  // y = y_diag + exp(da_cum) · (C · carry_inᵀ), each pair of parts'
  // products in a fresh accumulator added on the CUDA cores
  float yo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yo[i] = 0.f;
  wg::for_parts<IN, OP, LOW_FIRST>([&](int pi, int pj, bool) {
    float f[32];
    wg::fence_acc(f);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      wg::wgmma_ss<0>(
          f,
          desc_sw128(sC + pi * TCB + (kk / 4) * Q * 128 + (kk % 4) * 32 +
                         w * 8192,
                     16, 1024),
          desc_sw128(base + L.carry[pj] + (kk / 4) * 8192 + (kk % 4) * 32,
                     16, 1024),
          kk > 0);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(f);
#pragma unroll
    for (int i = 0; i < 32; ++i) yo[i] += f[i];
  });

  const float e0 = exp2f(dr0), e1 = exp2f(dr1);
  const int t0 = s0 + r0, t1 = t0 + 8;
  const long long y_ss = 1LL * a.H * P;
  T* yp = static_cast<T*>(a.y) + (1LL * b * S * a.H + h) * P;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = 8 * jj + 2 * quad;
    if (col >= P) continue;
    const float v00 = yd[4 * jj] + e0 * yo[4 * jj];
    const float v01 = yd[4 * jj + 1] + e0 * yo[4 * jj + 1];
    const float v10 = yd[4 * jj + 2] + e1 * yo[4 * jj + 2];
    const float v11 = yd[4 * jj + 3] + e1 * yo[4 * jj + 3];
    if constexpr (F32) {
      if (t0 < S)
        *reinterpret_cast<float2*>(yp + t0 * y_ss + col) =
            make_float2(v00, v01);
      if (t1 < S)
        *reinterpret_cast<float2*>(yp + t1 * y_ss + col) =
            make_float2(v10, v11);
    } else {
      if (t0 < S)
        *reinterpret_cast<uint32_t*>(yp + t0 * y_ss + col) =
            wg::pack_bf16x2(v00, v01);
      if (t1 < S)
        *reinterpret_cast<uint32_t*>(yp + t1 * y_ss + col) =
            wg::pack_bf16x2(v10, v11);
    }
  }
}

}  // namespace ssdtc

// ---- host entry point -------------------------------------------------
template <class T, int Q, int NB>
static int ssd_tc_launch_t(const ssdtc::Args& a, int blocks,
                           cudaStream_t stream) {
  const int smem = ssdtc::smem_bytes(Q, NB, std::is_same<T, float>::value);
  cudaError_t e = cudaFuncSetAttribute(
      ssdtc::ssd_tc_kernel<T, Q, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssdtc::ssd_tc_kernel<T, Q, NB><<<blocks, 2 * Q, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
static int ssd_tc_launch(const void* x, const float* dt, const float* A,
                         const void* Bm, const void* Cm, const float* init,
                         void* y, float* fin, int* sync,
                         const long long* strides, int batch, int S, int H,
                         int P, int N, int Q, cudaStream_t stream) {
  if (P < 8 || P > 64 || P % 8 || N < 8 || N > 128 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  ssdtc::Args a{x, dt, A, Bm, Cm, init, y, fin, sync,
                strides[0], strides[1], strides[2],
                strides[3], strides[4], strides[5],
                strides[6], strides[7], strides[8], strides[9],
                batch, S, H, P, N};
  const int blocks = (S + Q - 1) / Q * batch * H;
  if (blocks == 0) return 0;
  const bool wide = N > 64;
  switch (Q) {
    case 64:
      return wide ? ssd_tc_launch_t<T, 64, 2>(a, blocks, stream)
                  : ssd_tc_launch_t<T, 64, 1>(a, blocks, stream);
    case 128:
      return wide ? ssd_tc_launch_t<T, 128, 2>(a, blocks, stream)
                  : ssd_tc_launch_t<T, 128, 1>(a, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#define SSD_TC_ARGS                                                       \
  const void *x, const float *dt, const float *A, const void *Bm,         \
      const void *Cm, const float *init, void *y, float *fin, int *sync,  \
      const long long *strides, /* x (sb, ss, sh), dt (sb, ss, sh),       \
                                   B (sb, ss), C (sb, ss) */              \
      int batch, int S, int H, int P, int N, int Q, cudaStream_t stream

// bf16 x, B, C and y
extern "C" int ssd_scan_tc_launch(SSD_TC_ARGS) {
  return ssd_tc_launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, fin, sync,
                                      strides, batch, S, H, P, N, Q, stream);
}
// f32 x, B, C and y
extern "C" int ssd_scan_tc_f32_launch(SSD_TC_ARGS) {
  return ssd_tc_launch<float>(x, dt, A, Bm, Cm, init, y, fin, sync, strides,
                              batch, S, H, P, N, Q, stream);
}
