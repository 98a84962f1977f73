// ssd_scan_tc: Mamba2 SSD chunked scan (dual form) for bf16 on Hopper's
// tensor cores.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:68
// ssd_scan_pallas (body _kernel) for bf16 inputs, with the initial state
// of the function it stands for, repro/models/ssm.py::ssd_chunked; f32
// inputs keep the FMA kernel (ssd_scan.cu), because wgmma reads f32
// operands as TF32.  The contract is ssd_scan.cu's: per (batch, head),
// chunks of Q steps,
//   da_cum = cumsum(dt · A)
//   y      = ((C Bᵀ) ∘ L ∘ dt) x + exp(da_cum) · (C carryᵀ),
//            L[i, j] = exp(da_cum[i] - da_cum[j]) for j <= i, else 0
//   carry  = carry · exp(da_cum[-1]) + (x · dt · exp(da_cum[-1] - da_cum))ᵀ B
// with B and C shared by all heads (g = 1), the f32 carry starting at
// init (or 0) and ending in fin, x, B and C read through strides (unit
// last stride, other strides multiples of 8 elements, data 16-byte
// aligned), y contiguous, and any S: steps past the end load dt = 0 and
// x = B = C = 0 (decay 1, no input) and their y is not stored.
//
// What bounds it: bytes.  At mamba2-1.3b's prefill (4 x 1024 steps, 64
// heads of P = 64, N = 128, Q = 128) the function reads x, dt, B and C
// and writes y and the final state once: 78.6 MB, 0.0235 ms at
// 3.35 TB/s.  The products (C·Bᵀ once per block, the three others in
// three bf16 parts each, see Precision) are ~40 GFLOP, 0.04 ms at the
// bf16 tensor-core peak, so the kernel sits near the line between the
// two bounds; only wgmma gets the products that low, and only chunks run
// in parallel keep enough loads in flight.
//
// Design: the unit of work is (batch, chunk, head), so every chunk runs
// in parallel; only the carry is serial.  A block is Q/64 warpgroups;
// warpgroup w owns chunk rows 64w..64w+63.  C, B and the head's x arrive
// by 16-byte cp.async in the 128-byte swizzle that the wgmma descriptors
// name (P, N < 64 zero-padded to 64 columns).  Each block:
//   * C·Bᵀ on wgmma (K-major operands, key tiles above the diagonal
//     skipped), kept in registers;
//   * da_cum by a block scan (warp shuffles, then the warps' totals);
//   * y_diag = M·x, M = (C·Bᵀ) ∘ L ∘ dt built in the accumulator
//     registers (the exponent only on and below the diagonal), as the
//     register A operand of wgmma, x as an MN-major B;
//   * the chunk's own state S_c = (x·dt·exp(da_cum[-1] - da_cum))ᵀ B,
//     P x N over depth Q: the scaled x is read transposed from the x
//     tile into A fragments in registers, B is an MN-major operand;
//   * the chain: the block waits until chunk c - 1 of the head has
//     published (acquire load of its flag), each owner of an S_c entry
//     reads carry_in from fin (L2) and writes carry_out = carry_in ·
//     exp(da_cum[-1]) + S_c back in place, then the block publishes
//     chunk c (__threadfence, barrier, release store).  The carry stays
//     f32 in fin, and the link of the chain holds no product;
//   * y_off = exp(da_cum) · (C · carry_inᵀ), carry_in as K-major B
//     tiles; y = y_diag + y_off stored as bf16.
// Precision: M, the scaled x and carry_in are computed in f32, and each
// enters its product as three bf16 parts (hi + mid + lo, 24 bits); the
// inputs x, B and C are bf16 already and exact as operands.  A single
// bf16 part moves y by ~2^-9 relative, which rounds hundreds of outputs
// with |y| >= 16 one ulp (0.125) away, past the 1e-1 limit; the further
// parts cost ~18 % of the kernel's time (python -m
// repro_torch.kernels.ssd_tc_probe times and counts both).
// Two blocks run on an SM (at most 128 registers a thread at Q = 128):
// the block's phases wait on one another, so a second block is what
// hides their latency.  Sharing C·Bᵀ among several heads of a block was
// no faster on the card (PERF.md), so a block serves one head.
// A block takes its (chunk, batch, head) from an atomic ticket,
// chunk-major, not from blockIdx: every block of chunk c - 1 took its
// ticket, and so is resident, before any block of chunk c, so a block
// never waits on one that has not started, whatever the dispatch
// order.  The wrapper zeroes the ticket and the flags (sync) and
// allocates fin; the kernel allocates nothing.
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "wgmma_tile.cuh"

namespace ssdtc {

using wg::desc_sw128;
using wg::sw128;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int PARTS = 3;  // bf16 parts of each f32 operand (Precision)

struct Args {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* Bm;
  const __nv_bfloat16* Cm;
  const float* init;  // (B, H, P, N) or null for a zero state
  __nv_bfloat16* y;   // (B, S, H, P), contiguous
  float* fin;         // (B, H, P, N), contiguous: the carry after each chunk
  int* sync;          // [0] ticket, [1 + b·H + h] chunks of (b, h) published
  long long x_sb, x_ss, x_sh;  // element strides; P is unit
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;        // N is unit
  long long c_sb, c_ss;
  int batch, S, H, P, N;
};

// Shared memory, byte offsets from the 1024-aligned base: the C and B
// tiles (Q rows x NB column blocks of 128 B), the x tile (Q rows x
// 128 B) and a region R.  During the chunk-local phase R holds dt,
// da_cum, the scaled x's row factors, the scan's warp totals and the
// ticket; after the chain it holds the carry's bf16 parts (64 rows x
// NB blocks each), the first of them in the x tile when it fits.
struct Layout {
  int c, b, x, r, carry[3], bytes;
};
__host__ __device__ constexpr Layout layout(int q, int nb) {
  const int tcb = q * nb * 128, xb = q * 128, ct = nb * 8192;
  const int x = 2 * tcb, r = x + xb;
  const int c0 = xb >= ct ? x : r, c1 = c0 == x ? r : r + ct;
  return Layout{0, tcb, x, r, {c0, c1, c1 + ct}, c1 + 2 * ct};
}
__host__ __device__ constexpr int smem_bytes(int q, int nb) {
  return layout(q, nb).bytes + 1024;  // room to align the base
}

// Issue the copies of rows row0..row0+ROWS-1 (CPR 16-byte chunks each,
// the first `valid` of them real, the rest zero) into a tile.
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

// (u, v) as three packed bf16 pairs whose sums give u and v to 24 bits.
__device__ __forceinline__ void split3(float u, float v, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  p0 = wg::pack_bf16x2(u, v);
  u -= __uint_as_float(p0 << 16);
  v -= __uint_as_float(p0 & 0xffff0000u);
  p1 = wg::pack_bf16x2(u, v);
  u -= __uint_as_float(p1 << 16);
  v -= __uint_as_float(p1 & 0xffff0000u);
  p2 = wg::pack_bf16x2(u, v);
}

template <int Q, int NB>
__global__ void __launch_bounds__(2 * Q, 2) ssd_tc_kernel(Args a) {
  extern __shared__ unsigned char ssdtc_smem[];
  constexpr int NT = 2 * Q;
  constexpr int NWG = Q / 64;               // warpgroups
  constexpr int NU = (NB + NWG - 1) / NWG;  // S_c column tiles a wg owns
  constexpr Layout L = layout(Q, NB);
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

  load_rows<Q, NB * 8, NT>(sC, a.Cm + b * a.c_sb, a.c_ss, s0, S, N / 8, tid);
  load_rows<Q, NB * 8, NT>(sB, a.Bm + b * a.b_sb, a.b_ss, s0, S, N / 8, tid);
  load_rows<Q, 8, NT>(sX, a.x + b * a.x_sb + h * a.x_sh, a.x_ss, s0, S,
                      P / 8, tid);
  wg::cp_async_commit();
  if (tid < Q)
    dts[tid] = s0 + tid < S
                   ? a.dt[b * a.dt_sb + (s0 + tid) * a.dt_ss + h * a.dt_sh]
                   : 0.f;
  wg::cp_async_wait<0>();
  wg::fence_proxy_async();
  __syncthreads();

  // this thread's chunk rows (r0, r0 + 8) in every 64-row fragment
  const int r0 = 64 * w + 16 * warp + lane / 4;

  // C·Bᵀ: k-step kk is bytes 32·(kk % 4) of column block kk / 4
  float cb[NWG][32];  // C·Bᵀ rows of warpgroup w, key tiles j <= w
#pragma unroll
  for (int j = 0; j < NWG; ++j) {
    if (j > w) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) cb[j][i] = 0.f;
    wg::fence_acc(cb[j]);
  }
  wg::wgmma_fence();
#pragma unroll
  for (int j = 0; j < NWG; ++j) {
    if (j > w) continue;
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const uint32_t off = (kk / 4) * Q * 128 + (kk % 4) * 32;
      wg::wgmma_ss<0>(cb[j], desc_sw128(sC + off + w * 8192, 16, 1024),
                      desc_sw128(sB + off + j * 8192, 16, 1024), kk > 0);
    }
  }
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NWG; ++j)
    if (j <= w) wg::fence_acc(cb[j]);

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

  // y_diag = M·x by key tile j <= w; k-step kk of tile j is registers
  // 8kk..8kk+7 of M's fragment and chunk rows 64j + 16kk of x
  float yd[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yd[i] = 0.f;
  wg::fence_acc(yd);
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
    uint32_t pa[3][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split3(m[8 * kk + 2 * i], m[8 * kk + 2 * i + 1], pa[0][kk][i],
               pa[1][kk][i], pa[2][kk][i]);
    wg::wgmma_fence();
#pragma unroll
    for (int s = 0; s < PARTS; ++s)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::wgmma_rs<1>(yd, pa[s][kk],
                        desc_sw128(sX + (4 * j + kk) * 2048, 1024, 1024),
                        1);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(yd);
  }
  __syncthreads();  // the row factors wts

  // S_c = (x·wts)ᵀ B: rows p, column tile t = w + NWG·u of 64 n; the A
  // fragment of k-step kk holds rows p = 16·warp + lane/4 (+8) and chunk
  // rows 16kk + 2·quad (+1, +8, +9), read transposed from the x tile
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
      uint32_t xa[3][4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = 16 * warp + lane / 4 + 8 * (i % 2);
          const int j = 16 * (k0 + kk) + 2 * quad + 8 * (i / 2);
          const __nv_bfloat16* x0 = reinterpret_cast<const __nv_bfloat16*>(
              sm + L.x + sw128(j, p / 8, Q) + 2 * (p % 8));
          const __nv_bfloat16* x1 = reinterpret_cast<const __nv_bfloat16*>(
              sm + L.x + sw128(j + 1, p / 8, Q) + 2 * (p % 8));
          split3(__bfloat162float(*x0) * wts[j],
                 __bfloat162float(*x1) * wts[j + 1], xa[0][kk][i],
                 xa[1][kk][i], xa[2][kk][i]);
        }
      wg::wgmma_fence();
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int t = w + NWG * u;
        if (t >= NB) continue;
#pragma unroll
        for (int s = 0; s < PARTS; ++s)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wg::wgmma_rs<1>(st[u], xa[s][kk],
                            desc_sw128(sB + t * Q * 128 + (k0 + kk) * 2048,
                                       1024, 1024),
                            1);
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
  __syncthreads();  // also: no warpgroup reads the x tile any more
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

  // carry_in in three bf16 parts, K-major B tiles of y_off (rows p,
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
        uint32_t q0, q1, q2;
        split3(st[u][4 * jj + 2 * hr], st[u][4 * jj + 2 * hr + 1], q0, q1,
               q2);
        *reinterpret_cast<uint32_t*>(sm + L.carry[0] + off) = q0;
        *reinterpret_cast<uint32_t*>(sm + L.carry[1] + off) = q1;
        *reinterpret_cast<uint32_t*>(sm + L.carry[2] + off) = q2;
      }
  }
  wg::fence_proxy_async();
  __syncthreads();

  // y = y_diag + exp(da_cum) · (C · carry_inᵀ)
  float yo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yo[i] = 0.f;
  wg::fence_acc(yo);
  wg::wgmma_fence();
#pragma unroll
  for (int s = 0; s < PARTS; ++s)
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      wg::wgmma_ss<0>(
          yo,
          desc_sw128(sC + (kk / 4) * Q * 128 + (kk % 4) * 32 + w * 8192, 16,
                     1024),
          desc_sw128(base + L.carry[s] + (kk / 4) * 8192 + (kk % 4) * 32,
                     16, 1024),
          1);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_acc(yo);

  const float e0 = exp2f(dr0), e1 = exp2f(dr1);
  const int t0 = s0 + r0, t1 = t0 + 8;
  const long long y_ss = 1LL * a.H * P;
  __nv_bfloat16* yp = a.y + (1LL * b * S * a.H + h) * P;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = 8 * jj + 2 * quad;
    if (col >= P) continue;
    if (t0 < S)
      *reinterpret_cast<uint32_t*>(yp + t0 * y_ss + col) = wg::pack_bf16x2(
          yd[4 * jj] + e0 * yo[4 * jj], yd[4 * jj + 1] + e0 * yo[4 * jj + 1]);
    if (t1 < S)
      *reinterpret_cast<uint32_t*>(yp + t1 * y_ss + col) =
          wg::pack_bf16x2(yd[4 * jj + 2] + e1 * yo[4 * jj + 2],
                          yd[4 * jj + 3] + e1 * yo[4 * jj + 3]);
  }
}

}  // namespace ssdtc

// ---- host entry point -------------------------------------------------
template <int Q, int NB>
static int ssd_tc_launch_t(const ssdtc::Args& a, int blocks,
                           cudaStream_t stream) {
  const int smem = ssdtc::smem_bytes(Q, NB);
  cudaError_t e = cudaFuncSetAttribute(
      ssdtc::ssd_tc_kernel<Q, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssdtc::ssd_tc_kernel<Q, NB><<<blocks, 2 * Q, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssd_scan_tc_launch(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, const float* init, void* y, float* fin, int* sync,
    const long long* strides,  // x (sb, ss, sh), dt (sb, ss, sh),
                               // B (sb, ss), C (sb, ss)
    int batch, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  if (P < 8 || P > 64 || P % 8 || N < 8 || N > 128 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  ssdtc::Args a{static_cast<const __nv_bfloat16*>(x), dt, A,
                static_cast<const __nv_bfloat16*>(Bm),
                static_cast<const __nv_bfloat16*>(Cm), init,
                static_cast<__nv_bfloat16*>(y), fin, sync,
                strides[0], strides[1], strides[2],
                strides[3], strides[4], strides[5],
                strides[6], strides[7], strides[8], strides[9],
                batch, S, H, P, N};
  const int blocks = (S + Q - 1) / Q * batch * H;
  if (blocks == 0) return 0;
  const bool wide = N > 64;
  switch (Q) {
    case 64:
      return wide ? ssd_tc_launch_t<64, 2>(a, blocks, stream)
                  : ssd_tc_launch_t<64, 1>(a, blocks, stream);
    case 128:
      return wide ? ssd_tc_launch_t<128, 2>(a, blocks, stream)
                  : ssd_tc_launch_t<128, 1>(a, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
