// cell_scan: the timed PCS engine's issue-time merge loop on Hopper.
//
// Replaces repro/core/engine/step.py::scan_cell, the reference's
// lax.scan under jit(vmap(vmap)) (repro/core/engine/grid.py) — the TPU
// hot path of the simulator.  Its plain version is the eager torch
// repro_torch/core/engine/step.py::scan_cell; every expression below
// keeps that code's form and order (f64 adds, maxes and products, built
// with -fmad=false), so the two agree bit for bit.
//
// Scope: switch chains of up to MAX_DEEP + 1 = 4 switches, no fabric,
// one schedule epoch — the handler and policy bodies with tenants,
// PBPolicy quotas and weighted victims, the SLO drain tightening, the
// crash gate and durability tracking, and the deep-hop rows of
// engine/chain.py (the template's D, the grid's deep-row count; D = 0
// compiles every chain statement out).
//
// Design: one block of one warp per (trace, config) cell; every cell of
// a grid in one launch, with the scheme read per cell.  The machine
// state (clocks, cursors, PB tables, bank/PBC next-free times, barrier
// counts, stats) lives in shared memory; aver/pm_ver (durability
// tracking, A addresses) live in global memory.  Lanes own PBE slots
// (slot s = lane + 32 j, j < SPL, the template's slots per lane: 1, 2
// or 4 for up to 32, 64 or 128 slots) and keep the per-step derived
// slot columns in registers; every argmin is a warp reduction that
// breaks ties to the lowest index, as jnp.argmin does.  All lanes run
// the scalar part of a step redundantly (same inputs, same values);
// lane 0 alone writes scalar state.  Each step reads what it needs,
// __syncwarp(), then writes — lanes of a warp are not in lock step.
//
// What bounds it: each cell is a chain of dependent steps (379 029 for
// the paper's cholesky at persist_budget=100_000), so the kernel is
// latency bound; the paper grid's 21 cells keep at most 21 of the
// H100's 132 SMs busy.  The section profile (-DCELL_SCAN_PROFILE,
// chip_smoke.py phase 4) showed where a step's latency went, and the
// design takes it off the step's dependent chain:
//   * trace entries: each core's next RING entries wait in shared
//     memory, refilled by cp.async as the core advances and read when it
//     is next chosen, so no global load sits between one step's merge
//     and the next;
//   * the merge: with at most 32 cores, core c sits on lane c and only
//     the keys go through the butterfly (one ballot then picks the
//     lowest lane holding the minimum);
//   * PB lookups, occupancy and counts: each lane evaluates its slots'
//     tag match, liveness and serving test at once (independent loads),
//     and warp-wide answers are ballots (tat_first, popc) instead of
//     sweeps and shuffle sums; the three slot argmins share one
//     butterfly; the RF drain ranks walk the Dirty slots by ballot and
//     shuffle instead of O(P²) shared-memory scans;
//   * addresses: the shared-memory carve-up is computed once on the
//     host and passed as offsets, and the read path's config scalars sit
//     in registers, so no step re-derives them;
//   * a PM bank is a mask when the bank count is a power of two.
// None of this changes an f64 expression or its order.
//
// The chain (struct Chain): the deep rows live in shared memory, a lane
// owning slot lane + 32 j of each row as on hop 1.  A hop-1 drain batch
// (the victim, then the policy drains) walks the rows as a list of its
// active packets in wire order, 32 packets at a time, one a lane: the
// reference's per-packet recurrences become warp operations (the FIFO
// service's running max a shuffle scan, allocation ranks and the bypass
// list ballot prefix counts, the per-bank burst order a ballot per
// bank), and a batch of one packet — most of them — is evaluated on
// every lane at once with no warp operation but its match.  The deep
// lookups go through tat_match.cuh: a read's candidates of every deep
// row fold into one key and one warp reduction finds the shallowest.
// Where the reference's vectorised form decides a result through the
// packets it carries inactive — an origin's ack written by the batch's
// last block only (XLA's in-order scatter), the commit-latency sum in
// XLA's chunk order — the list keeps each packet's position in that
// batch.  No f64 expression changes its form or order.
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tat_match.cuh"

// Section profile (built only with -DCELL_SCAN_PROFILE, never on the
// main path): every lane adds the clock64() cycles since its last mark
// to the section named at each mark; lane 0 writes, per cell, the
// cycles of each section, the steps of each op kind and the loop's
// total cycles to g_prof (cell_scan_set_profile).  The SEC_C_* sections
// are the switch chain's (D > 0): building a hop-1 batch, the deep read
// (its loads count in SEC_READ), and per deep row the FIFO service with
// the row's and the batch's loads, the coalesce match (a lone packet's
// counts in the next), allocation, gates, acks and bypass, the writers'
// hand-off and the row after the batch, the drain rank with the row's
// write-back, and the PM landing.
enum ProfSection {
  SEC_KEYS, SEC_ARGMIN, SEC_FETCH, SEC_READ, SEC_LOOKUP, SEC_OCC,
  SEC_SELECT, SEC_DRAIN, SEC_WRITE, SEC_STATS, SEC_OTHER, SEC_BOOK,
  SEC_C_BATCH, SEC_C_READ, SEC_C_FIFO, SEC_C_MATCH, SEC_C_ALLOC,
  SEC_C_WRITER, SEC_C_DRANK, SEC_C_LAND, N_SEC
};
constexpr int N_OPS = 6, N_PROF = N_SEC + N_OPS + 1;
#ifdef CELL_SCAN_PROFILE
__device__ long long* g_prof;
struct Prof {
  long long acc[N_SEC], t;
};
__device__ __forceinline__ void prof_mark(Prof& p, int sec) {
  const long long now = clock64();
  p.acc[sec] += now - p.t;
  p.t = now;
}
__device__ __forceinline__ void prof_mark(Prof* p, int sec) {
  prof_mark(*p, sec);
}
// `prof`: the kernel's Prof, or the Chain's pointer to it
#define PROF(sec) prof_mark(prof, sec)
#else
#define PROF(sec) \
  do {            \
  } while (0)
#endif

namespace {

constexpr double INF = 1e30;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SPL = 4;  // slots per lane: max_pbe <= 128
constexpr int RING = 4;  // trace entries per core held in shared memory

constexpr int EMPTY = 0, DIRTY = 1, DRAIN = 2;
constexpr int OP_COMPUTE = 0, OP_DRAM_READ = 1, OP_DRAM_WRITE = 2,
              OP_PM_READ = 3, OP_PERSIST = 4, OP_BARRIER = 5;

// stats columns (repro_torch/core/engine/state.py)
constexpr int S_PERSIST_SUM = 0, S_PERSIST_CNT = 1, S_READ_SUM = 2,
              S_READ_CNT = 3, S_READ_HITS = 4, S_COALESCES = 5,
              S_PM_WRITES = 6, S_STALL_TIME = 7, S_PI_DETOURS = 8,
              S_DRAM_READS = 9, S_VICTIM_CNT = 10, S_PBCQ_SUM = 11,
              S_ACKED = 12, S_DURABLE = 13, S_SLO_OVER = 14,
              S_LAT_HIST0 = 15, N_LAT_BINS = 28,
              N_STATS = S_LAT_HIST0 + N_LAT_BINS;
constexpr int H_FWD_SUM = 0, H_FWD_CNT = 1, H_COALESCES = 2, H_BYPASS = 3,
              H_READ_HITS = 4, N_HOP_STATS = 5;

// config table columns (repro_torch/kernels/cell_scan.py SC_KEYS)
enum ScKey {
  K_N_PBE, K_N_TENANTS, K_THRESHOLD, K_PRESET, K_DRAIN_SCOPE,
  K_VICTIM_WEIGHTED, K_LOW_WATER, K_EMPTY_SLACK, K_TAG_NS, K_DATA_NS,
  K_PBC_PROC, K_PBC_OCC, K_PBC_READ, K_PBC_READ_OCC, K_NVM_READ,
  K_NVM_WRITE, K_NVM_R_OCC, K_NVM_W_OCC, K_DRAM_NS, K_FWD_MARGIN,
  K_SWITCH_PIPE, K_OW_CPU_PM, K_OW_CPU_SW1, K_OW_SW1_PM, K_LAT_TARGET,
  K_LAT_TOL, K_CRASH_AT, N_SC
};
// per-tenant rows (TENANT_KEYS)
enum TenKey { T_QUOTA, T_SHARE, T_THRESHOLD, T_PRESET, N_TEN };
// the switch chain's row of the chain table: CHAIN_KEYS, then one run of
// D values per DEEP_KEYS entry (value j = switch j+2)
enum ChKey { C_N_SWITCHES, C_HOP_NS, C_LINK_NS, N_CH };
enum DeepKey { DK_PBE, DK_THR, DK_PRE, DK_TAG, DK_DATA, N_DK };

// Histogram bin of one persist latency: #{k : lat >= edges[k]} over the
// reference's own bin edges (state.py LAT_BIN_EDGES, passed in by the
// wrapper).
__device__ __forceinline__ int lat_bin(double lat, const double* edges) {
  int b = 0;
  for (int k = 0; k < N_LAT_BINS - 1; ++k) b += lat >= edges[k];
  return b;
}

// Floor modulo, as jnp/torch take it: the initial tag -1 maps to bank
// n - 1 (C's % would give -1).
__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// The PM bank of a tag: floor_mod(tag, B), by a mask when B is a power
// of two (two's complement makes the mask a floor modulo too).
struct Banks {
  int n, mask;  // mask = n - 1 for a power of two, else -1
  __device__ __forceinline__ int operator()(int tag) const {
    return mask >= 0 ? (tag & mask) : floor_mod(tag, n);
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void argmin_step(double& key, int& idx, int off) {
  const double k2 = __shfl_xor_sync(FULL, key, off);
  const int i2 = __shfl_xor_sync(FULL, idx, off);
  if (k2 < key || (k2 == key && i2 < idx)) {
    key = k2;
    idx = i2;
  }
}

// (key, idx) argmin over the warp, ties to the lowest index; every lane
// gets the result.
__device__ __forceinline__ void warp_argmin(double& key, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) argmin_step(key, idx, off);
}

// The same when lane l's candidate has index l and every key is a
// non-negative double (no NaN, no -0), whose bit patterns order as
// unsigned integers: the high words' minimum, then the low words' among
// the lanes that hold it (two warp reductions), and one ballot finds
// the lowest lane holding the minimum.
__device__ __forceinline__ void warp_argmin_lane(double& key, int& idx) {
  unsigned long long bits;
  memcpy(&bits, &key, sizeof bits);
  const unsigned hi = static_cast<unsigned>(bits >> 32);
  const unsigned lo = static_cast<unsigned>(bits);
  const unsigned min_hi = __reduce_min_sync(FULL, hi);
  const unsigned min_lo = __reduce_min_sync(FULL, hi == min_hi ? lo : ~0u);
  idx = __ffs(__ballot_sync(FULL, hi == min_hi && lo == min_lo)) - 1;
  bits = (static_cast<unsigned long long>(min_hi) << 32) | min_lo;
  memcpy(&key, &bits, sizeof bits);
}

// Three independent argmins in the same five rounds, so that their
// shuffles overlap.
__device__ __forceinline__ void warp_argmin3(double& k0, int& i0, double& k1,
                                             int& i1, double& k2, int& i2) {
  for (int off = 16; off > 0; off >>= 1) {
    argmin_step(k0, i0, off);
    argmin_step(k1, i1, off);
    argmin_step(k2, i2, off);
  }
}

// How many of the warp's slots have pred set (lane l's pred[j] is slot
// 32 j + l): one ballot per 32-slot tile.
template <int N>
__device__ __forceinline__ int warp_count(const bool (&pred)[N], int tiles) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < tiles) n += __popc(__ballot_sync(FULL, pred[j]));
  return n;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}


// Shared-memory carve-up of one cell's carry and scratch.  Per core c:
// its cursor, length, and the trace entry at the cursor (cop, caddr,
// cgap); the ring holds entries ptr .. ptr + RING - 1 at slot
// entry % RING, refilled by cp.async as the core advances.
struct Smem {
  double *clock, *lru, *dd, *pm_busy, *stats, *hop, *pbc, *sc, *ten, *occ,
      *edges;
  int *ptr, *len, *cop, *caddr, *rop, *raddr, *tag, *ver, *tids, *lpt;
  float *cgap, *rgap;
  short* bcount;
  signed char *state, *owner, *blocked;
};

struct Carver {
  unsigned char* base;
  size_t off;
  template <typename T>
  __host__ __device__ T* take(size_t n) {
    off = (off + 7) & ~static_cast<size_t>(7);
    T* p = reinterpret_cast<T*>(base + off);
    off += n * sizeof(T);
    return p;
  }
};

__host__ __device__ size_t carve(Smem& m, unsigned char* base, int C, int P,
                                 int B, int T) {
  Carver cv{base, 0};
  m.clock = cv.take<double>(C);
  m.lru = cv.take<double>(P);
  m.dd = cv.take<double>(P);
  m.pm_busy = cv.take<double>(B);
  m.stats = cv.take<double>(static_cast<size_t>(T) * N_STATS);
  m.hop = cv.take<double>(N_HOP_STATS);
  m.pbc = cv.take<double>(1);
  m.sc = cv.take<double>(N_SC);
  m.ten = cv.take<double>(static_cast<size_t>(N_TEN) * T);
  m.occ = cv.take<double>(T);
  m.edges = cv.take<double>(N_LAT_BINS - 1);
  m.ptr = cv.take<int>(C);
  m.len = cv.take<int>(C);
  m.cop = cv.take<int>(C);
  m.caddr = cv.take<int>(C);
  m.rop = cv.take<int>(static_cast<size_t>(C) * RING);
  m.raddr = cv.take<int>(static_cast<size_t>(C) * RING);
  m.tag = cv.take<int>(P);
  m.ver = cv.take<int>(P);
  m.tids = cv.take<int>(C);
  m.lpt = cv.take<int>(T);
  m.cgap = cv.take<float>(C);
  m.rgap = cv.take<float>(static_cast<size_t>(C) * RING);
  m.bcount = cv.take<short>(T);
  m.state = cv.take<signed char>(P);
  m.owner = cv.take<signed char>(P);
  m.blocked = cv.take<signed char>(C);
  return cv.off;
}

#define SMEM_FIELDS(X)                                                     \
  X(clock) X(lru) X(dd) X(pm_busy) X(stats) X(hop) X(pbc) X(sc) X(ten)     \
  X(occ) X(edges) X(ptr) X(len) X(cop) X(caddr) X(rop) X(raddr) X(tag)    \
  X(ver) X(tids) X(lpt) X(cgap) X(rgap) X(bcount) X(state) X(owner)       \
  X(blocked)

// The carve-up at `base`, from the offsets the host computed once.
// Re-deriving them in the kernel leaves a chain of aligned adds that the
// compiler rematerialises at every access under register pressure; an
// offset from the kernel's parameters is one add.
__device__ __forceinline__ Smem rebase(Smem m, unsigned char* base) {
#define REBASE(f) \
  m.f = reinterpret_cast<decltype(m.f)>(base + reinterpret_cast<size_t>(m.f));
  SMEM_FIELDS(REBASE)
#undef REBASE
  return m;
}


// ---- the switch chain (engine/chain.py) ----------------------------------
// The deep-hop rows of switches 2 .. D+1 (row j = switch j+2; slot s of
// a row is owned by lane s % 32, as on hop 1), the chain's config row,
// two packet lists, and per-slot and per-bank scratch.  A list holds a
// batch's *active* packets in wire order, each with its position in the
// reference's full batch (the inactive packets it carries decide only
// the order of the commit-latency sum, through the positions).  The
// writer scratch (w*) holds, per slot of the row being placed, the
// packet that writes it (wflag 0: none); the bank scratch, per PM bank,
// the latest burst end of a landing (f64 bits; both are all zero
// between uses).
struct ChainSmem {
  double *dlru, *ddd, *dwt, *csc, *vack, *emit0, *emit1, *wcommit;
  int *dtag, *dver, *pos0, *pos1, *oslot0, *oslot1, *addr0, *addr1, *ver0,
      *ver1, *wver, *waddr, *bcnt;
  unsigned long long* bnew;
  signed char *dstate, *downer, *ohop0, *ohop1, *own0, *own1, *wflag, *wown;
};

#define CHAIN_FIELDS(X)                                                     \
  X(dlru) X(ddd) X(dwt) X(csc) X(vack) X(emit0) X(emit1) X(wcommit) X(dtag) \
  X(dver) X(pos0) X(pos1) X(oslot0) X(oslot1) X(addr0) X(addr1) X(ver0)    \
  X(ver1) X(wver) X(waddr) X(bcnt) X(bnew) X(dstate) X(downer) X(ohop0)    \
  X(ohop1) X(own0) X(own1) X(wflag) X(wown)

// The chain's arrays after the depth-1 carve-up (which ends at `off`);
// returns the end.  Q = (D + 1) P packets hold any batch.
__host__ __device__ size_t carve_chain(ChainSmem& c, unsigned char* base,
                                       size_t off, int P, int B, int D) {
  Carver cv{base, off};
  const size_t DP = static_cast<size_t>(D) * P, Q = (D + 1) * static_cast<size_t>(P);
  c.dlru = cv.take<double>(DP);
  c.ddd = cv.take<double>(DP);
  c.dwt = cv.take<double>(DP);
  c.csc = cv.take<double>(N_CH + N_DK * D);
  c.vack = cv.take<double>(1);
  c.emit0 = cv.take<double>(Q);
  c.emit1 = cv.take<double>(Q);
  c.wcommit = cv.take<double>(P);
  c.dtag = cv.take<int>(DP);
  c.dver = cv.take<int>(DP);
  c.pos0 = cv.take<int>(Q);
  c.pos1 = cv.take<int>(Q);
  c.oslot0 = cv.take<int>(Q);
  c.oslot1 = cv.take<int>(Q);
  c.addr0 = cv.take<int>(Q);
  c.addr1 = cv.take<int>(Q);
  c.ver0 = cv.take<int>(Q);
  c.ver1 = cv.take<int>(Q);
  c.wver = cv.take<int>(P);
  c.waddr = cv.take<int>(P);
  c.bcnt = cv.take<int>(B);
  c.bnew = cv.take<unsigned long long>(B);
  c.dstate = cv.take<signed char>(DP);
  c.downer = cv.take<signed char>(DP);
  c.ohop0 = cv.take<signed char>(Q);
  c.ohop1 = cv.take<signed char>(Q);
  c.own0 = cv.take<signed char>(Q);
  c.own1 = cv.take<signed char>(Q);
  c.wflag = cv.take<signed char>(P);
  c.wown = cv.take<signed char>(P);
  return cv.off;
}

__device__ __forceinline__ ChainSmem rebase_chain(ChainSmem c,
                                                  unsigned char* base) {
#define REBASE(f) \
  c.f = reinterpret_cast<decltype(c.f)>(base + reinterpret_cast<size_t>(c.f));
  CHAIN_FIELDS(REBASE)
#undef REBASE
  return c;
}

// One packet of a list, in a lane's registers.
struct Pkt {
  double emit;
  int pos, oslot, addr, ver, ohop;
  signed char owner;
};

// One packet list: active packets in wire order.
struct Pkts {
  int *pos, *oslot, *addr, *ver;
  double* emit;
  signed char *ohop, *owner;
  __device__ Pkt at(int q) const {
    return Pkt{emit[q], pos[q], oslot[q], addr[q], ver[q], ohop[q], owner[q]};
  }
};

// The writer of a slot (ChainSmem::wflag): a coalesce or an allocation.
constexpr int F_CO = 1, F_PLACED = 2;

// The reference's commit-latency sum is an f64 sum over the Q packets of
// a batch, in XLA's CPU order (chain.py::xla_sum): chunks summed left to
// right, then the chunk sums.  The inactive packets add 0.0, so the
// addends go in by their positions in the full batch, in order.
struct ChunkSum {
  int first, m, chunk = 0;
  double part = 0.0, total = 0.0;
  __host__ __device__ explicit ChunkSum(int Q) {
    m = Q <= 32 ? 0 : max(0, (Q - 64 + 31) / 32);
    const int r = Q - 32 * m;
    first = Q <= 32 ? Q : (r + 1) / 2;
  }
  __host__ __device__ int chunk_of(int pos) const {
    return pos < first ? 0 : 1 + min((pos - first) / 32, m);
  }
  // the addend v at a position of chunk ch, after those before it
  __host__ __device__ void add_in(int ch, double v) {
    if (ch != chunk) {
      total += part;
      part = 0.0;
      chunk = ch;
    }
    part += v;
  }
  __host__ __device__ void add(int pos, double v) { add_in(chunk_of(pos), v); }
  __host__ __device__ double sum() const { return total + part; }
};

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// The k-th (from 0) set bit of m, which has more than k.
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
  int base = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      m >>= w;
      base += w;
    }
  }
  return base;
}

// The largest v over lanes 0 .. cnt-1 (the others hold -INF), on every
// lane: the butterfly's rounds stop at the first power of two >= cnt.
__device__ __forceinline__ double warp_max_n(double v, int cnt) {
  for (int off = 1; off < cnt; off <<= 1)
    v = fmax(v, __shfl_xor_sync(FULL, v, off));
  return __shfl_sync(FULL, v, 0);
}

// The chain's forwarding for one cell: forward_chain, its _place and
// _pm_land, and deep_read (engine/chain.py), over the deep rows in
// shared memory.  Every lane calls every method together.  A batch is
// walked in tiles of 32 packets, packet base + l on lane l, and each
// per-packet recurrence of the reference is a warp operation on the
// tile: the FIFO service's running max a shuffle scan, the allocation
// ranks and the bypass list a ballot prefix count, the coalesce matches
// a ballot per packet or a shuffle per Dirty slot (the shorter loop),
// each slot's writer staged in shared memory for the owning lane, the
// per-bank burst order at PM a ballot per bank present; what crosses a
// tile is carried.  A batch of at most one packet is held by every lane
// and needs none of this.  Per-slot work runs on the owning lanes.  Only
// the commit-latency sum stays in order, packet by packet (its order is
// the reference's).  Lane j holds row j's PBC clock, lane l the deep
// rows' telemetry value l, and lane b bank b's PM clock during a
// forward, so none of them passes through shared memory.  `pm_ver` is
// the cell's durable-version row (global).
template <int SPL, int D>
struct Chain {
  ChainSmem c;
  int lane, P, B, A, n_track, tiles;
  Banks bank_of;
  double crash, n_sw, hop_ns, link_ns, pbc_occ, pbc_proc, w_occ, nvm_write;
  int* pm_ver;
  int live_rows, pbe[D > 0 ? D : 1];  // rows of switches 2 .. n_sw; capacities
  double hpbc_r = 0.0, hop_r = 0.0, pmb_r = 0.0;
#ifdef CELL_SCAN_PROFILE
  Prof* prof;
#endif

  __device__ double deep(int key, int j) const { return c.csc[N_CH + key * D + j]; }
  __device__ int idx(int j, int s) const { return j * P + s; }
  __device__ Pkts list(int which) const {
    return which == 0 ? Pkts{c.pos0, c.oslot0, c.addr0, c.ver0, c.emit0,
                             c.ohop0, c.own0}
                      : Pkts{c.pos1, c.oslot1, c.addr1, c.ver1, c.emit1,
                             c.ohop1, c.own1};
  }
  // telemetry value k of deep row j (hop j + 2) += v
  __device__ void hop_add(int j, int k, double v) {
    if (lane == j * N_HOP_STATS + k) hop_r += v;
  }

  // _pm_land at switch `pos_sw`: the list's n packets land at PM
  // (per-bank burst order, the banks' clocks on lanes < B); the acks of
  // the batch's last block (`last`, >= 1) go to deep row last-1.
  // Returns the writes.
  __device__ double land(const Pkts& b, int n, int pos_sw, int last) {
    const double rem = fmax(n_sw - static_cast<double>(pos_sw), 0.0);
    const double path_down = link_ns + rem * hop_ns;
    const bool tiled = n > 32;  // ranks carried from tile to tile
    Pkt pk = b.at(lane < n ? lane : 0);
    if (n == 1) {  // one packet, held by every lane
      const int bk = bank_of(pk.addr);
      const double start =
          fmax(__shfl_sync(FULL, pmb_r, bk), pk.emit + path_down) +
          static_cast<double>(0) * w_occ;
      const double path_up =
          link_ns + fmax(n_sw - static_cast<double>(pk.ohop + 1), 0.0) * hop_ns;
      const double dd_val = start + nvm_write + path_up;
      if (lane == 0) {
        if (dd_val <= crash && pk.addr >= 0 && pk.addr < n_track)
          atomicMax(&pm_ver[clampi(pk.addr, 0, A - 1)], pk.ver);
        if (pk.ohop == last) c.ddd[idx(last - 1, pk.oslot)] = dd_val;
      }
      const double end = start + w_occ;
      if (lane < B)
        pmb_r = fmax(pmb_r, lane == bk ? (end > 0.0 ? end : 0.0) : 0.0);
      PROF(SEC_C_LAND);
      return 1.0;
    }
    for (int base = 0; base < n; base += 32) {
      const int q = base + lane;
      const bool act = q < n;
      const int ad = pk.addr, ver = pk.ver, oslot = pk.oslot, ohop = pk.ohop;
      const double arr = pk.emit + path_down;
      const int bk = bank_of(ad);
      // rank_b: the packets of the same bank before this one, a ballot
      // per bank present (B <= 32)
      unsigned same = 0;
      for (unsigned pres = __reduce_or_sync(FULL, act ? 1u << bk : 0u); pres;
           pres &= pres - 1) {
        const int bq = __ffs(pres) - 1;
        const unsigned m = __ballot_sync(FULL, act && bk == bq);
        if (bk == bq) same = m;
      }
      int rank_b = __popc(same & lanes_below(lane));
      if (tiled) rank_b += c.bcnt[bk];
      const double start = fmax(__shfl_sync(FULL, pmb_r, bk), arr) +
                           static_cast<double>(rank_b) * w_occ;
      const double path_up =
          link_ns + fmax(n_sw - static_cast<double>(ohop + 1), 0.0) * hop_ns;
      const double dd_val = start + nvm_write + path_up;
      if (act) {
        // the bank's new clock: the latest burst end, as ordered f64 bits
        // of a value >= +0 (the reference's max starts from 0.0)
        const double end = start + w_occ;
        atomicMax(&c.bnew[bk], static_cast<unsigned long long>(
                                   __double_as_longlong(end > 0.0 ? end : 0.0)));
        if (dd_val <= crash && ad >= 0 && ad < n_track)
          atomicMax(&pm_ver[clampi(ad, 0, A - 1)], ver);
        // an origin slot is named once per origin row in a batch
        if (ohop == last) c.ddd[idx(last - 1, oslot)] = dd_val;
      }
      if (tiled) {
        __syncwarp();
        if (act && lane == 31 - __clz(same)) c.bcnt[bk] = rank_b + 1;
        __syncwarp();
        pk = b.at(q + 32 < n ? q + 32 : 0);
      }
    }
    __syncwarp();
    if (lane < B) {
      pmb_r = fmax(pmb_r, __longlong_as_double(
                              static_cast<long long>(c.bnew[lane])));
      c.bnew[lane] = 0ull;
      if (tiled) c.bcnt[lane] = 0;
    }
    PROF(SEC_C_LAND);
    return static_cast<double>(n);
  }

  // fifo_service for the packets of one tile (packet q on this lane,
  // cnt of the tile's lanes active): start_q = occ*q + max(busy,
  // cummax(arr - occ*rank)), the running max a shuffle scan carried in
  // `run` from the tiles before.
  __device__ double fifo_start(double emit, bool act, int q, int cnt,
                               double busy, double& run) const {
    const double rank = static_cast<double>(q);
    const double arr = emit + hop_ns;
    double x = act ? arr - pbc_occ * rank : -INF;
    for (int d = 1; d < cnt; d <<= 1) {
      const double y = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x = fmax(x, y);
    }
    x = fmax(run, x);
    if (cnt == 32) run = __shfl_sync(FULL, x, 31);  // on to the next tile
    return pbc_occ * rank + fmax(x, busy);
  }

  // _place of the list's n packets (Q in the full batch) into row j, its
  // own drain-down, and the next list `nx`; returns the next list's
  // count.  Row 0's acks go to the hop-1 dd sink (`dd1`, or the single
  // slot `*dd1` when `single`).
  __device__ int place(int j, int scheme, const Pkts& b, int n, int Q,
                       const Pkts& nx, double* dd1, bool single,
                       long long& lookups) {
    const double tag_j = deep(DK_TAG, j), data_j = deep(DK_DATA, j);
    const int pbe_j = static_cast<int>(deep(DK_PBE, j));
    const double busy = __shfl_sync(FULL, hpbc_r, j);
    // the batch's first tile, and the row as the batch finds it
    Pkt pk = b.at(lane < n ? lane : 0);
    const double emit0 = b.emit[0];
    signed char v0[SPL], own0[SPL];
    int tg[SPL], dv[SPL];
    double ddv[SPL], lru0[SPL], wt0[SPL];
    bool dirty0[SPL];
#pragma unroll
    for (int jj = 0; jj < SPL; ++jj) {
      const int s = lane + 32 * jj, i = idx(j, s < P ? s : 0);
      v0[jj] = c.dstate[i];
      tg[jj] = c.dtag[i];
      ddv[jj] = c.ddd[i];
      dv[jj] = c.dver[i];
      own0[jj] = c.downer[i];
      lru0[jj] = c.dlru[i];
      wt0[jj] = c.dwt[i];
      dirty0[jj] = s < pbe_j && v0[jj] == DIRTY;
    }
    // lazy free observed once, at the batch head: the least classify
    // time.  While pbc_occ >= 0 the FIFO's starts never decrease (each is
    // a sum of two non-decreasing terms, rounded monotonically), so that
    // is packet 0's, evaluated here as its own lane evaluates it.
    double run0 = -INF;
    const double start0 = fifo_start(emit0, true, 0, 1, busy, run0);
    double t0 = -INF;
    if (n > 0) {
      if (pbc_occ >= 0.0) {
        t0 = start0 + pbc_proc + tag_j;
      } else {
        double run = -INF, mn = INF;
        for (int base = 0; base < n; base += 32) {
          const int q = base + lane;
          const bool act = q < n;
          const double st = fifo_start(b.emit[act ? q : 0], act, q,
                                       min(n - base, 32), busy, run);
          mn = fmin(mn, act ? st + pbc_proc + tag_j : INF);
        }
        for (int off = 16; off > 0; off >>= 1)
          mn = fmin(mn, __shfl_xor_sync(FULL, mn, off));
        t0 = mn;
      }
    }
    // the Empty slots after the lazy free, by rank (a mask per tile)
    signed char st0[SPL];
    unsigned emask[SPL];
    int n_empty = 0;
#pragma unroll
    for (int jj = 0; jj < SPL; ++jj) {
      const int s = lane + 32 * jj;
      st0[jj] = static_cast<signed char>(
          (v0[jj] == DRAIN && ddv[jj] <= t0) ? EMPTY : v0[jj]);
      emask[jj] = jj < tiles ? __ballot_sync(FULL, s < pbe_j && st0[jj] == EMPTY)
                             : 0u;
      n_empty += __popc(emask[jj]);
    }
    auto empty_slot = [&](int e) {  // the e-th Empty slot (e < n_empty)
      int s = -1;
#pragma unroll
      for (int jj = 0; jj < SPL; ++jj) {
        const int cnt = __popc(emask[jj]);
        if (s < 0 && e < cnt) s = 32 * jj + nth_set_bit(emask[jj], e);
        e -= cnt;
      }
      return s;
    };
    PROF(SEC_C_FIFO);
    // the batch's outcome: each lane's slots' writers (wf: F_CO or
    // F_PLACED, 0 for none), the row's telemetry and clocks, and the
    // bypass list's length
    int wf[SPL], wv[SPL], wa[SPL];
    signed char wo[SPL];
    double wc[SPL];
    int nb = 0, n_ended = 0, n_co = 0, n_by = 0;
    ChunkSum fwd_sum(Q);
    double busy_after = busy, t_row = 0.0;
    if (n <= 1) {
      // at most one packet, held by every lane: the reference's
      // expressions for it need no warp operation but the match
      const bool one = n == 1;
      const double start = start0;
      const double klass = start + pbc_proc + tag_j;
      const double cm = klass + data_j;
      bool hit[SPL];
#pragma unroll
      for (int jj = 0; jj < SPL; ++jj) hit[jj] = dirty0[jj] && tg[jj] == pk.addr;
      const int co = one ? tat_first(hit, tiles) : -1;
      const bool placed = one && co < 0 && n_empty > 0;
      const bool ended = co >= 0 || placed;
      int slot = co;
#pragma unroll
      for (int jj = SPL - 1; jj >= 0; --jj)  // the first Empty slot
        if (placed && emask[jj]) slot = 32 * jj + __ffs(emask[jj]) - 1;
      const bool gate = one && cm <= crash;
      n_ended = ended && gate;
      n_co = co >= 0 && gate;
      n_by = !ended && gate;
      if (ended && gate) fwd_sum.add(pk.pos, cm - pk.emit);
      if (one) busy_after = fmax(busy, start + pbc_occ);
      t_row = fmax(ended && gate ? cm : -INF, 0.0);
      if (lane == 0 && ended && pk.ohop == j) {
        const double dd_val =
            cm + (static_cast<double>(j + 2) -
                  (static_cast<double>(pk.ohop) + 1.0)) * hop_ns;
        if (j == 0)
          dd1[single ? 0 : pk.oslot] = dd_val;
        else
          c.ddd[idx(j - 1, pk.oslot)] = dd_val;
      }
      if (one && !ended) {
        if (lane == 0) {
          nx.pos[0] = pk.pos;
          nx.oslot[0] = pk.oslot;
          nx.addr[0] = pk.addr;
          nx.ver[0] = pk.ver;
          nx.owner[0] = pk.owner;
          nx.ohop[0] = static_cast<signed char>(pk.ohop);
          nx.emit[0] = klass;
        }
        nb = 1;
      }
#pragma unroll
      for (int jj = 0; jj < SPL; ++jj) {
        wf[jj] = ended && gate && lane + 32 * jj == slot
                     ? (co >= 0 ? F_CO : F_PLACED) : 0;
        wv[jj] = pk.ver;
        wa[jj] = pk.addr;
        wo[jj] = pk.owner;
        wc[jj] = cm;
      }
      lookups += n;
      PROF(SEC_C_ALLOC);
    } else {
      // a tile at a time
      double run = -INF, ba = -INF, tr = -INF;
      int a_carry = 0;
      for (int base = 0; base < n; base += 32) {
        const int q = base + lane, cnt = min(n - base, 32);
        const bool act = q < n;
        const double emit = pk.emit;
        const int ad = pk.addr, ver = pk.ver, pos = pk.pos, oslot = pk.oslot;
        const int ohop = pk.ohop;
        const signed char own = pk.owner;
        const double start = fifo_start(emit, act, q, cnt, busy, run);
        const double klass = start + pbc_proc + tag_j;
        const double cm = klass + data_j;
        if (act) ba = fmax(ba, start + pbc_occ);
        PROF(SEC_C_FIFO);
        // coalesce match: the lowest Dirty slot holding the line, every
        // packet at once
        const int co = tat_first_each(ad, tg, dirty0, tiles);
        PROF(SEC_C_MATCH);
        // allocation: the e-th packet that did not coalesce takes the e-th
        // Empty slot, if there is one
        const bool alloc = act && co < 0;
        const unsigned am = __ballot_sync(FULL, alloc);
        const int arank = a_carry + __popc(am & lanes_below(lane));
        a_carry += __popc(am);
        const bool placed = alloc && arank < n_empty;
        const bool ended = act && (co >= 0 || placed);
        const int slot = co >= 0 ? co : (placed ? empty_slot(arank) : -1);
        const bool gate = act && cm <= crash;
        const unsigned gm = __ballot_sync(FULL, ended && gate);
        n_ended += __popc(gm);
        n_co += __popc(__ballot_sync(FULL, co >= 0 && gate));
        n_by += __popc(__ballot_sync(FULL, !ended && gate));
        if (ended && gate) tr = fmax(tr, cm);
        // the commit-latency sum, in list order
        const int ch = fwd_sum.chunk_of(pos);
        const double lat = cm - emit;
        for (unsigned bits = gm; bits; bits &= bits - 1) {
          const int l = __ffs(bits) - 1;
          fwd_sum.add_in(__shfl_sync(FULL, ch, l), __shfl_sync(FULL, lat, l));
        }
        // the acks of the batch's last block (row 0: the hop-1 origins; an
        // origin slot is named once per origin row in a batch)
        if (ended && ohop == j) {
          const double dd_val =
              cm + (static_cast<double>(j + 2) -
                    (static_cast<double>(ohop) + 1.0)) * hop_ns;
          if (j == 0)
            dd1[single ? 0 : oslot] = dd_val;
          else
            c.ddd[idx(j - 1, oslot)] = dd_val;
        }
        // bypass: on toward the next switch, in list order
        const bool by = act && !ended;
        const unsigned bm = __ballot_sync(FULL, by);
        if (by) {
          const int o = nb + __popc(bm & lanes_below(lane));
          nx.pos[o] = pos;
          nx.oslot[o] = oslot;
          nx.addr[o] = ad;
          nx.ver[o] = ver;
          nx.owner[o] = own;
          nx.ohop[o] = static_cast<signed char>(ohop);
          nx.emit[o] = klass;
        }
        nb += __popc(bm);
        PROF(SEC_C_ALLOC);
        // each slot's writer, staged for the owning lane.  A slot has one:
        // allocations take distinct Empty slots, and only packets of one
        // line could coalesce into one, but a batch never repeats a line
        // (every hop holds at most one Dirty entry per line, and a packet
        // bypasses a row only when it holds none for its line)
        if (ended && gate) {
          c.wflag[slot] = static_cast<signed char>(co >= 0 ? F_CO : F_PLACED);
          c.wver[slot] = ver;
          c.waddr[slot] = ad;
          c.wown[slot] = own;
          c.wcommit[slot] = cm;
        }
        if (base + 32 < n) pk = b.at(q + 32 < n ? q + 32 : 0);
        PROF(SEC_C_WRITER);
      }
      lookups += n;
      __syncwarp();
      // each lane's slots take their staged writers
#pragma unroll
      for (int jj = 0; jj < SPL; ++jj) {
        const int s = lane + 32 * jj, sp = s < P ? s : 0;
        wf[jj] = s < P ? c.wflag[sp] : 0;
        wv[jj] = c.wver[sp];
        wa[jj] = c.waddr[sp];
        wo[jj] = c.wown[sp];
        wc[jj] = c.wcommit[sp];
        if (wf[jj]) c.wflag[sp] = 0;
      }
      const int cnt0 = min(n, 32);
      busy_after = fmax(busy, warp_max_n(ba, cnt0));
      t_row = fmax(warp_max_n(tr, cnt0), 0.0);
    }
    // the row after the batch
    signed char st1[SPL], own1[SPL];
    int tag1[SPL], ver1[SPL];
    double lru1[SPL], wt1[SPL];
    bool dirty[SPL];
#pragma unroll
    for (int jj = 0; jj < SPL; ++jj) {
      const int s = lane + 32 * jj;
      const bool upd = wf[jj] != 0;
      const bool al = wf[jj] == F_PLACED;
      const bool co_upd = wf[jj] == F_CO;
      const int ver_in = upd ? wv[jj] : 0;
      tag1[jj] = al ? wa[jj] : tg[jj];
      st1[jj] = al ? static_cast<signed char>(DIRTY) : st0[jj];
      ver1[jj] = al ? ver_in : (co_upd ? max(ver_in, dv[jj]) : dv[jj]);
      const bool keep_owner = co_upd && dv[jj] > ver_in;
      own1[jj] = (upd && !keep_owner) ? wo[jj] : own0[jj];
      lru1[jj] = upd ? wc[jj] : lru0[jj];
      wt1[jj] = upd ? wc[jj] : wt0[jj];
      dirty[jj] = s < pbe_j && st1[jj] == DIRTY;
    }
    if (lane == j) hpbc_r = busy_after;
    hop_add(j, H_FWD_CNT, static_cast<double>(n_ended));
    hop_add(j, H_FWD_SUM, fwd_sum.sum());
    hop_add(j, H_COALESCES, static_cast<double>(n_co));
    hop_add(j, H_BYPASS, static_cast<double>(n_by));
    PROF(SEC_C_WRITER);
    // this hop's own drain-down: PB forwards every Dirty entry, PB_RF
    // its threshold/preset count, in LRU order (ties to the lower slot)
    unsigned dbits[SPL];
    int n_dirty = 0;
#pragma unroll
    for (int jj = 0; jj < SPL; ++jj) {
      dbits[jj] = jj < tiles ? __ballot_sync(FULL, dirty[jj]) : 0u;
      n_dirty += __popc(dbits[jj]);
    }
    const double dirty_cnt = static_cast<double>(n_dirty);
    const double k =
        scheme == 1 ? dirty_cnt
                    : (dirty_cnt >= deep(DK_THR, j) ? dirty_cnt - deep(DK_PRE, j)
                                                    : 0.0);
    int rank[SPL];
#pragma unroll
    for (int jj = 0; jj < SPL; ++jj) rank[jj] = 0;
#pragma unroll
    for (int jq = 0; jq < SPL; ++jq) {
      if (n_dirty < 2) break;  // a lone Dirty entry ranks 0
      for (unsigned bits = dbits[jq]; bits; bits &= bits - 1) {
        const int l = __ffs(bits) - 1, q = 32 * jq + l;
        const double kq = __shfl_sync(FULL, lru1[jq], l);
#pragma unroll
        for (int jj = 0; jj < SPL; ++jj) {
          const int s = lane + 32 * jj;
          rank[jj] += (kq < lru1[jj]) || (kq == lru1[jj] && q < s);
        }
      }
    }
    bool drain[SPL];
#pragma unroll
    for (int jj = 0; jj < SPL; ++jj)
      drain[jj] = dirty[jj] && static_cast<double>(rank[jj]) < k;
    const int n_drain = warp_count(drain, tiles);
#pragma unroll
    for (int jj = 0; jj < SPL; ++jj) {
      const int s = lane + 32 * jj;
      if (s < P) {
        const int i = idx(j, s);
        c.dtag[i] = tag1[jj];
        c.dstate[i] = drain[jj] ? static_cast<signed char>(DRAIN) : st1[jj];
        c.dlru[i] = lru1[jj];
        c.dver[i] = ver1[jj];
        c.downer[i] = own1[jj];
        c.dwt[i] = wt1[jj];
        if (drain[jj]) {  // the drained entry leaves at its LRU rank
          const int o = nb + rank[jj];
          nx.pos[o] = Q + rank[jj];
          nx.oslot[o] = s;
          nx.addr[o] = tag1[jj];
          nx.ver[o] = ver1[jj];
          nx.owner[o] = own1[jj];
          nx.ohop[o] = static_cast<signed char>(j + 1);
          nx.emit[o] = t_row;
        }
      }
    }
    __syncwarp();
    PROF(SEC_C_DRANK);
    return nb + n_drain;
  }

  // forward_chain: list 0 holds the batch's n packets (Q0 in the full
  // batch), placed into the live rows; the rest land at PM from the
  // first row past the depth.  Returns the PM writes.
  __device__ double forward(int scheme, int Q0, int n, double* dd1,
                            bool single, long long& lookups) {
    int cur = 0, Q = Q0, j = 0;
#pragma unroll 1
    for (; j < live_rows; ++j) {
      n = place(j, scheme, list(cur), n, Q, list(1 - cur), dd1, single,
                lookups);
      cur = 1 - cur;
      Q += P;
    }
    return land(list(cur), n, j + 1, j);
  }

  // deep_read, in two parts: probe reads, with no branch, which of each
  // lane's slots of the live deep rows hold `addr` (bit j SPL + jj: slot
  // lane + 32 jj of row j; none without a chain); pick, when some row
  // does, evaluates their visibility and service at t and takes the
  // warp's least tat_first_key: the shallowest row holding a visible
  // servable entry for `addr`, its first Dirty one, else its first late
  // Drain.
  __device__ unsigned probe(int addr) const {
    unsigned tm = 0;
#pragma unroll
    for (int j = 0; j < D; ++j) {
#pragma unroll
      for (int jj = 0; jj < SPL; ++jj) {
        const int s = lane + 32 * jj;
        const int tg = c.dtag[idx(j, s < P ? s : 0)];
        if (j < live_rows && s < pbe[j] && tg == addr)
          tm |= 1u << (j * SPL + jj);
      }
    }
    return tm;
  }
  // Returns the row (or -1), with the slot and the response time.
  __device__ int pick(unsigned tm, double t, double ow_cpu_sw1,
                      double fwd_margin, double pbc_read_ns, int& slot,
                      double& resp, long long& lookups) const {
    lookups += 1;
    if (!__any_sync(FULL, tm != 0)) return -1;
    int key = TAT_NO_KEY;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const double arr =
          t + ow_cpu_sw1 + static_cast<double>(j + 1) * hop_ns;
#pragma unroll
      for (int jj = 0; jj < SPL; ++jj) {
        if ((tm >> (j * SPL + jj)) & 1u) {
          const int s = lane + 32 * jj, i = idx(j, s);
          const int v = c.dstate[i];
          const bool sv = v != EMPTY && c.dwt[i] <= t &&
                          (v == DIRTY ||
                           (v == DRAIN && c.ddd[i] > arr + fwd_margin));
          if (sv) key = min(key, tat_key(j, v != DIRTY, s));
        }
      }
    }
    key = tat_first_key(key);
    if (key == TAT_NO_KEY) return -1;
    const int j = tat_key_table(key);
    slot = tat_key_slot(key);
    const double arr = t + ow_cpu_sw1 + static_cast<double>(j + 1) * hop_ns;
    resp = arr + pbc_read_ns + deep(DK_TAG, j) + deep(DK_DATA, j) +
           ow_cpu_sw1 + static_cast<double>(j + 1) * hop_ns;
    return j;
  }
};

struct Args {
  const int* ops;          // (K, C, L)
  const int* addrs;        // (K, C, L)
  const float* gaps;       // (K, C, L)
  const int* lengths;      // (K, C)
  const int* cell_trace;   // (N,)
  const int* cell_cfg;     // (N,)
  const int* schemes;      // (Kc,)
  const double* sc_table;  // (Kc, N_SC)
  const double* ten_table; // (Kc, N_TEN, T)
  const double* lat_edges; // (N_LAT_BINS - 1,)
  double* runtime;         // (N,)
  double* stats;           // (N, T, N_STATS)
  double* hop_stats;       // (N, 1, N_HOP_STATS)
  int* durable_ver;        // (N, A)  pm_ver during the run
  double* n_recov;         // (N,)
  double* recov_ns;        // (N,)
  double* recov_t;         // (N, T)
  long long* steps;        // (N,)
  long long* lookups;      // (N,)
  int* aver;               // (N, A)  scratch
  int C, L, P, B, A, T, n_track;
  Smem lay;  // the carve-up with a null base: byte offsets
  // ---- the switch chain (D > 0 instantiations only) ----
  const double* chain_table;  // (Kc, N_CH + N_DK * D)
  double* recov_h;            // (N, D + 1) survivors per hop
  ChainSmem clay;             // the chain's carve-up: byte offsets
};

}  // namespace

// SPL: PBE slots per lane (slot s = lane + 32 j, j < SPL), the fewest
// that hold max_pbe, so that a small PB keeps one slot a lane.  D: the
// grid's deep-hop rows (0: no switch chain; every `if constexpr (D > 0)`
// below is then compiled out).
template <int SPL, int D>
__global__ void __launch_bounds__(32) cell_scan_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem m = rebase(a.lay, smem_raw);
  const int lane = threadIdx.x;
  const int cell = blockIdx.x;
  const int C = a.C, L = a.L, P = a.P, B = a.B, A = a.A, T = a.T;
  const int n_track = a.n_track;
  const int tr = a.cell_trace[cell];
  const int cf = a.cell_cfg[cell];
  const int scheme = a.schemes[cf];
  const size_t trace_off = static_cast<size_t>(tr) * C * L;
  const int* ops = a.ops + trace_off;
  const int* addrs = a.addrs + trace_off;
  const float* gaps = a.gaps + trace_off;
  const int* lens = a.lengths + static_cast<size_t>(tr) * C;
  int* pm_ver = a.durable_ver + static_cast<size_t>(cell) * A;
  int* aver = a.aver + static_cast<size_t>(cell) * A;
  double* sc = m.sc;
  double* stats = m.stats;

  // ---- init_state + config row -----------------------------------------
  for (int i = lane; i < C; i += 32) {
    m.clock[i] = 0.0;
    m.ptr[i] = 0;
    m.blocked[i] = 0;
    const int len = lens[i], last = max(len - 1, 0);
    m.len[i] = len;
    for (int k = 0; k < RING; ++k) {
      const size_t e = static_cast<size_t>(i) * L + min(k, last);
      m.rop[i * RING + k] = ops[e];
      m.raddr[i * RING + k] = addrs[e];
      m.rgap[i * RING + k] = gaps[e];
    }
    m.cop[i] = m.rop[i * RING];
    m.caddr[i] = m.raddr[i * RING];
    m.cgap[i] = m.rgap[i * RING];
  }
  for (int s = lane; s < P; s += 32) {
    m.tag[s] = -1;
    m.state[s] = EMPTY;
    m.lru[s] = 0.0;
    m.dd[s] = 0.0;
    m.ver[s] = 0;
    m.owner[s] = 0;
  }
  for (int b = lane; b < B; b += 32) m.pm_busy[b] = 0.0;
  for (int i = lane; i < T * N_STATS; i += 32) stats[i] = 0.0;
  for (int i = lane; i < N_HOP_STATS; i += 32) m.hop[i] = 0.0;
  for (int i = lane; i < T; i += 32) m.bcount[i] = 0;
  for (int i = lane; i < N_SC; i += 32)
    sc[i] = a.sc_table[static_cast<size_t>(cf) * N_SC + i];
  for (int i = lane; i < N_TEN * T; i += 32)
    m.ten[i] = a.ten_table[static_cast<size_t>(cf) * N_TEN * T + i];
  for (int i = lane; i < N_LAT_BINS - 1; i += 32) m.edges[i] = a.lat_edges[i];
  for (int i = lane; i < A; i += 32) {
    pm_ver[i] = 0;
    aver[i] = 0;
  }
  if (lane == 0) m.pbc[0] = 0.0;
  // the chain: its rows and clocks start empty, its config row in smem
  Chain<SPL, D> ch{};
  if constexpr (D > 0) {
    ch.c = rebase_chain(a.clay, smem_raw);
    for (int i = lane; i < D * P; i += 32) {
      ch.c.dtag[i] = -1;
      ch.c.dstate[i] = EMPTY;
      ch.c.dlru[i] = 0.0;
      ch.c.ddd[i] = 0.0;
      ch.c.dver[i] = 0;
      ch.c.downer[i] = 0;
      ch.c.dwt[i] = 0.0;
    }
    for (int i = lane; i < P; i += 32) ch.c.wflag[i] = 0;
    for (int i = lane; i < B; i += 32) {
      ch.c.bnew[i] = 0ull;
      ch.c.bcnt[i] = 0;
    }
    for (int i = lane; i < N_CH + N_DK * D; i += 32)
      ch.c.csc[i] = a.chain_table[static_cast<size_t>(cf) * (N_CH + N_DK * D) + i];
  }
  __syncwarp();

  // ---- tenancy: balanced contiguous partition of the live cores ---------
  int n_live = 0;
  for (int c = lane; c < C; c += 32) n_live += lens[c] > 0;
  n_live = warp_sum(n_live);
  const int t_int = max(static_cast<int>(sc[K_N_TENANTS]), 1);
  const int t_top = min(t_int, T) - 1;
  for (int c = lane; c < C; c += 32)
    m.tids[c] = clampi((c * t_int) / max(n_live, 1), 0, t_top);
  __syncwarp();
  for (int t = lane; t < T; t += 32) {
    int cnt = 0;
    for (int c = 0; c < C; ++c) cnt += (m.tids[c] == t) && (lens[c] > 0);
    m.lpt[t] = cnt;
  }
  __syncwarp();
  const int n_pbe = static_cast<int>(sc[K_N_PBE]);
  const int tiles = (P + 31) / 32;  // 32-slot tiles of the PB
  const Banks bank_of{B, (B & (B - 1)) == 0 ? B - 1 : -1};
  const double crash = sc[K_CRASH_AT];
  bool is_chain = false;  // n_switches >= 2: hop 1's drains go down the chain
  if constexpr (D > 0) {
    ch.lane = lane;
    ch.P = P;
    ch.B = B;
    ch.A = A;
    ch.n_track = n_track;
    ch.tiles = (P + 31) / 32;
    ch.bank_of = bank_of;
    ch.crash = crash;
    ch.n_sw = ch.c.csc[C_N_SWITCHES];
    ch.hop_ns = ch.c.csc[C_HOP_NS];
    ch.link_ns = ch.c.csc[C_LINK_NS];
    ch.pbc_occ = sc[K_PBC_OCC];
    ch.pbc_proc = sc[K_PBC_PROC];
    ch.w_occ = sc[K_NVM_W_OCC];
    ch.nvm_write = sc[K_NVM_WRITE];
    ch.pm_ver = pm_ver;
    is_chain = ch.n_sw >= 2.0;
    ch.live_rows = 0;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      ch.live_rows += static_cast<double>(j) + 2.0 <= ch.n_sw;
      ch.pbe[j] = static_cast<int>(ch.deep(DK_PBE, j));
    }
  }
  // the read path's config scalars, in registers for the whole cell
  // (pbc_read_tag is the reference's own sum pbc_read_ns + tag_ns)
  const struct {
    double ow_cpu_pm, nvm_read, nvm_r_occ, ow_cpu_sw1, pbc_read_tag,
        fwd_margin, data_ns, switch_pipe, ow_sw1_pm, pbc_read_occ;
  } rd{sc[K_OW_CPU_PM], sc[K_NVM_READ], sc[K_NVM_R_OCC],
       sc[K_OW_CPU_SW1], sc[K_PBC_READ] + sc[K_TAG_NS], sc[K_FWD_MARGIN],
       sc[K_DATA_NS], sc[K_SWITCH_PIPE], sc[K_OW_SW1_PM],
       sc[K_PBC_READ_OCC]};

  long long steps = 0, lookups = 0;
#ifdef CELL_SCAN_PROFILE
  Prof prof{};
  long long prof_ops[N_OPS] = {};
  const long long prof_t0 = clock64();
  prof.t = prof_t0;
  if constexpr (D > 0) ch.prof = &prof;
#endif
  for (;;) {
    // ---- issue-time merge: the core whose next op issues first ---------
    // (inactive and blocked cores key INF, so when none can be selected
    // the minimum is INF and every later step is a no-op)
    auto key_of = [&](int c) {
      const int p = m.ptr[c], len = m.len[c];
      const bool blocked = m.blocked[c];
      const double ck = m.clock[c];
      const float gap = m.cgap[c];
      return (p < len && !blocked) ? ck + static_cast<double>(gap) : INF;
    };
    double best = INF;
    int bc = lane;
    if (C <= 32) {  // core c on lane c (an idle lane keys INF)
      if (lane < C) best = key_of(lane);
      PROF(SEC_KEYS);
      warp_argmin_lane(best, bc);
    } else {
      for (int c = lane; c < C; c += 32) {
        const double key = key_of(c);
        if (key < best) {
          best = key;
          bc = c;
        }
      }
      PROF(SEC_KEYS);
      warp_argmin(best, bc);
    }
    PROF(SEC_ARGMIN);
    if (!(best < INF * 0.5)) break;
    ++steps;
    const int c = bc;
    const double t_issue = best;
    // ops issuing after the power loss never happen (machine is off)
    const bool live = t_issue <= crash;
    const int op = live ? m.cop[c] : OP_COMPUTE;
    const double t = live ? t_issue : m.clock[c];
    const int addr = m.caddr[c];
    const int tid = m.tids[c];
    const int n_live_t = m.lpt[tid];
    double* st_row = stats + static_cast<size_t>(tid) * N_STATS;
    // core c's next trace entry, read now for the end of the step (lane
    // 0's copies, one group a step: the entry was issued RING - 1 or
    // more steps ago, so all but the newest RING - 2 groups suffice)
    wg::cp_async_wait<RING - 2>();
    const int p_next = m.ptr[c] + 1, nxt = c * RING + p_next % RING;
    const int op_next = m.rop[nxt], addr_next = m.raddr[nxt];
    const float gap_next = m.rgap[nxt];
    const int last_c = max(m.len[c] - 1, 0);
#ifdef CELL_SCAN_PROFILE
    prof_ops[op] += 1;
#endif
    PROF(SEC_FETCH);

    if (op == OP_COMPUTE || op == OP_DRAM_WRITE) {
      __syncwarp();
      if (lane == 0) m.clock[c] = t;
    } else if (op == OP_DRAM_READ) {
      __syncwarp();
      if (lane == 0) {
        st_row[S_DRAM_READS] += 1.0;
        m.clock[c] = t + sc[K_DRAM_NS];
      }
    } else if (op == OP_PM_READ) {
      // the deep rows' tag matches, loaded first so that hop 1's lookup
      // covers their latency
      unsigned deep_tm = 0;
      if constexpr (D > 0) deep_tm = ch.probe(addr);
      const int bank = bank_of(addr);
      const double pm_start_dir = fmax(m.pm_busy[bank], t + rd.ow_cpu_pm);
      const double resp_dir = pm_start_dir + rd.nvm_read + rd.ow_cpu_pm;
      if (scheme == 0) {
        // NoPB: the volatile switch forwards every read to PM.
        __syncwarp();
        if (lane == 0) {
          st_row[S_READ_SUM] += resp_dir - t;
          st_row[S_READ_CNT] += 1.0;
          m.clock[c] = resp_dir;
          m.pm_busy[bank] = pm_start_dir + rd.nvm_r_occ;
        }
      } else {
        // PB/PB_RF: read forwarding through the PI buffer.
        const double arr = t + rd.ow_cpu_sw1;
        const double pbc_prev = m.pbc[0];
        const double pbc_start = fmax(pbc_prev, arr) + rd.pbc_read_tag;
        // s0: the lazily freed state at t (policy.lazy_free) of this
        // lane's slots; each lane also decides whether its slot would
        // serve the read, so the chosen slot's answer is one ballot bit
        signed char s0[SPL];
        bool hit_d[SPL], hit_l[SPL], serves[SPL];
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j, sp = s < P ? s : 0;
          const int v = m.state[sp], tg = m.tag[sp];
          const double ddv = m.dd[sp];
          const int st = (v == DRAIN && ddv <= t) ? EMPTY : v;
          s0[j] = static_cast<signed char>(s < P ? st : EMPTY);
          const bool tm = s < n_pbe && tg == addr;
          hit_d[j] = tm && st == DIRTY;
          hit_l[j] = tm && st != EMPTY;
          serves[j] = (st == DIRTY) ||
                      ((st == DRAIN) && (ddv > pbc_start + rd.fwd_margin));
        }
        // policy.pb_lookup: the first Dirty match, else the first live
        // match, else slot 0 — two tat_match compositions, evaluated
        // together (counted as the reference runs them: the live match
        // only after a Dirty miss)
        const int i_dirty = tat_first(hit_d, tiles);
        const int i_live = tat_first(hit_l, tiles);
        lookups += i_dirty >= 0 ? 1 : 2;
        const bool has = i_dirty >= 0 || i_live >= 0;
        const int idx = i_dirty >= 0 ? i_dirty : (has ? i_live : 0);
        bool served = false;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const unsigned bits = j < tiles ? __ballot_sync(FULL, serves[j])
                                          : 0u;
          if (j == idx / 32) served = (bits >> (idx % 32)) & 1u;
        }
        const double resp_pb = pbc_start + rd.data_ns + rd.ow_cpu_sw1;
        const double pm_start_fwd =
            fmax(m.pm_busy[bank], pbc_start + rd.switch_pipe + rd.ow_sw1_pm);
        const double resp_fwd = pm_start_fwd + rd.nvm_read + rd.ow_cpu_pm;
        const bool hit = has && served;
        // read forwarding below hop 1 (chain.deep_read): with no live
        // hop-1 entry the packet passes every deeper switch's PBCS, and
        // the shallowest servable entry answers
        int deep_row = -1, deep_slot = 0;
        double resp_deep = 0.0;
        if constexpr (D > 0) {
          if (is_chain && !has) {
            PROF(SEC_READ);
            deep_row = ch.pick(deep_tm, t, rd.ow_cpu_sw1, rd.fwd_margin,
                               sc[K_PBC_READ], deep_slot, resp_deep, lookups);
            PROF(SEC_C_READ);
          }
        }
        const bool deep_hit = deep_row >= 0;
        const double resp =
            deep_hit ? resp_deep
                     : (has ? (served ? resp_pb : resp_fwd) : resp_dir);
        const double pmb =
            deep_hit ? m.pm_busy[bank]
                     : (has ? (served ? m.pm_busy[bank]
                                      : pm_start_fwd + rd.nvm_r_occ)
                            : pm_start_dir + rd.nvm_r_occ);
        const double pbc_new =
            has ? fmax(pbc_prev, arr) + rd.pbc_read_occ : pbc_prev;
        __syncwarp();
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j;
          if (s < P) m.state[s] = s0[j];
        }
        if (lane == 0) {
          if (hit) m.lru[idx] = t;
          m.hop[H_READ_HITS] += hit ? 1.0 : 0.0;
          if constexpr (D > 0) {
            if (deep_hit) ch.c.dlru[deep_row * P + deep_slot] = t;
          }
          st_row[S_READ_SUM] += resp - t;
          st_row[S_READ_CNT] += 1.0;
          st_row[S_READ_HITS] += (hit || deep_hit) ? 1.0 : 0.0;
          st_row[S_PI_DETOURS] += has ? 1.0 : 0.0;
          m.clock[c] = resp;
          m.pm_busy[bank] = pmb;
          m.pbc[0] = pbc_new;
        }
        if constexpr (D > 0) {
          if (deep_hit) ch.hop_add(deep_row, H_READ_HITS, 1.0);
        }
        PROF(SEC_READ);
      }
    } else if (op == OP_PERSIST) {
      const int bank = bank_of(addr);
      const bool tracked = addr >= 0 && addr < n_track;
      const int a_idx = clampi(addr, 0, A - 1);
      const int v_new = aver[a_idx] + 1;
      if (scheme == 0) {
        // Volatile switch: the persist round-trips to PM.
        const double ow = sc[K_OW_CPU_PM];
        const double pm_start = fmax(m.pm_busy[bank], t + ow);
        const double ack = pm_start + sc[K_NVM_WRITE] + ow;
        const bool ok = ack <= crash;
        const double lat = ack - t;
        const double over_now = lat > sc[K_LAT_TARGET] ? 1.0 : 0.0;
        const int hist = lat_bin(lat, m.edges);
        __syncwarp();
        if (lane == 0) {
          st_row[S_PERSIST_SUM] += ack - t;
          st_row[S_PERSIST_CNT] += 1.0;
          st_row[S_SLO_OVER] += over_now;
          st_row[S_PM_WRITES] += 1.0;
          st_row[S_ACKED] += ok ? 1.0 : 0.0;
          st_row[S_DURABLE] += ok ? 1.0 : 0.0;
          st_row[S_LAT_HIST0 + hist] += 1.0;
          m.clock[c] = ack;
          aver[a_idx] += tracked ? 1 : 0;
          pm_ver[a_idx] = max(pm_ver[a_idx], (tracked && ok) ? v_new : 0);
          m.pm_busy[bank] = pm_start + sc[K_NVM_W_OCC];
        }
      } else {
        // ---- shared PB persist core (handlers._persist_with_buffer) ----
        const bool is_rf = scheme == 2;
        const double arr = t + sc[K_OW_CPU_SW1];
        const double pbc_prev = m.pbc[0];
        const double pbc_start =
            fmax(pbc_prev, arr) + (sc[K_PBC_PROC] + sc[K_TAG_NS]);
        // st1: the lazily freed state at pbc_start of this lane's slots
        signed char st1[SPL];
        bool hit_d[SPL];
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j, sp = s < P ? s : 0;
          const int v = m.state[sp], tg = m.tag[sp];
          const double ddv = m.dd[sp];
          const int st = (v == DRAIN && ddv <= pbc_start) ? EMPTY : v;
          st1[j] = static_cast<signed char>(s < P ? st : EMPTY);
          hit_d[j] = s < n_pbe && tg == addr && st == DIRTY;
        }
        // policy.coalesce_lookup: the first Dirty match
        const int i_dirty = tat_first(hit_d, tiles);
        ++lookups;
        const bool has_dirty = i_dirty >= 0;
        const int idx = has_dirty ? i_dirty : 0;
        const bool is_coalesce = is_rf && has_dirty;
        PROF(SEC_LOOKUP);
        // tenant_occupancy: live entries per owning tenant, a ballot per
        // tile and tenant
        int own1[SPL];
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j;
          own1[j] = s < n_pbe && st1[j] != EMPTY
                        ? clampi(m.owner[s], 0, T - 1) : -1;
        }
        for (int tt = 0; tt < T; ++tt) {
          bool mine[SPL];
#pragma unroll
          for (int j = 0; j < SPL; ++j) mine[j] = own1[j] == tt;
          const int cnt = warp_count(mine, tiles);
          if (lane == 0) m.occ[tt] = static_cast<double>(cnt);
        }
        __syncwarp();
        PROF(SEC_OCC);
        // select_slot
        const bool over_quota = m.occ[tid] >= m.ten[T_QUOTA * T + tid];
        const bool weighted = sc[K_VICTIM_WEIGHTED] > 0.0;
        bool any_hot = false;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j;
          if (s < n_pbe && st1[j] == DIRTY) {
            const int o = clampi(m.owner[s], 0, T - 1);
            any_hot |= m.occ[o] >= m.ten[T_SHARE * T + o];
          }
        }
        const bool use_hot = weighted && __any_sync(FULL, any_hot);
        double ke = INF, kv = INF, kd = INF;
        int ie = lane, iv = lane, id = lane;
        bool any_e = false, any_d = false;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j;
          if (s < P) {
            const bool act = s < n_pbe;
            const bool own = m.owner[s] == tid;
            const bool empty_m = act && st1[j] == EMPTY && !over_quota;
            const bool dirty_all = act && st1[j] == DIRTY;
            const int o = clampi(m.owner[s], 0, T - 1);
            const bool hot = dirty_all && m.occ[o] >= m.ten[T_SHARE * T + o];
            const bool dirty_m = over_quota ? (dirty_all && own)
                                            : (use_hot ? hot : dirty_all);
            const bool drain_all = act && st1[j] == DRAIN;
            const bool drain_m = over_quota ? (drain_all && own) : drain_all;
            any_e |= empty_m;
            any_d |= dirty_m;
            const double k1 = empty_m ? m.lru[s] : INF;
            if (k1 < ke) { ke = k1; ie = s; }
            const double k2 = dirty_m ? m.lru[s] : INF;
            if (k2 < kv) { kv = k2; iv = s; }
            const double k3 = drain_m ? m.dd[s] : INF;
            if (k3 < kd) { kd = k3; id = s; }
          }
        }
        const bool any_empty = __any_sync(FULL, any_e);
        const bool any_dirty = __any_sync(FULL, any_d);
        warp_argmin3(ke, ie, kv, iv, kd, id);
        const int empty_idx = ie, victim_idx = iv, earliest_idx = id;

        // victim drain (only used when no Empty entry exists)
        const int vic_tag = m.tag[victim_idx];
        const int victim_bank = bank_of(vic_tag);
        const double victim_pm_start =
            fmax(m.pm_busy[victim_bank], pbc_start + sc[K_OW_SW1_PM]);
        const double victim_dd =
            victim_pm_start + sc[K_NVM_WRITE] + sc[K_OW_SW1_PM];
        const bool needs_victim = !is_coalesce && !any_empty && any_dirty;
        const bool vic_ok = needs_victim && victim_dd <= crash &&
                            vic_tag >= 0 && vic_tag < n_track;
        const int vic_ver = m.ver[victim_idx];
        const bool vic_emit = needs_victim && pbc_start <= crash;
        // switch chain, victim leg: the victim packet travels the chain
        // first (it leaves the PBC at pbc_start), and the slot frees at
        // its downstream ack; the chain works on its own copy of the
        // banks' clocks (ch.pmb_r, bank b's on lane b), as the PM path
        // below reads the machine's
        double vic_wait = victim_dd, pmw_v = 0.0, vack = 0.0;
        if constexpr (D > 0) {
          if (is_chain) {
            ch.pmb_r = lane < B ? m.pm_busy[lane] : 0.0;  // B <= 32
            if (vic_emit) {
              PROF(SEC_SELECT);
              if (lane == 0) {
                *ch.c.vack = m.dd[victim_idx];
                const Pkts b0 = ch.list(0);
                b0.pos[0] = 0;
                b0.oslot[0] = victim_idx;
                b0.addr[0] = vic_tag;
                b0.ver[0] = vic_ver;
                b0.owner[0] = m.owner[victim_idx];
                b0.ohop[0] = 0;
                b0.emit[0] = pbc_start;
              }
              __syncwarp();
              PROF(SEC_C_BATCH);
              pmw_v = ch.forward(scheme, 1, 1, ch.c.vack, true, lookups);
              vack = *ch.c.vack;
              vic_wait = vack;
            }
          }
        }
        const int slot =
            any_empty ? empty_idx : (any_dirty ? victim_idx : earliest_idx);
        const double ta =
            any_empty ? pbc_start
                      : (any_dirty ? vic_wait
                                   : fmax(pbc_start, m.dd[earliest_idx]));
        // pm_busy1: the victim's bank reserved
        auto pmb1 = [&](int b) {
          return (b == victim_bank && needs_victim)
                     ? victim_pm_start + sc[K_NVM_W_OCC]
                     : m.pm_busy[b];
        };

        // write the entry (new allocation or coalesce-in-place)
        const int wslot = is_coalesce ? idx : slot;
        const double t_written =
            (is_coalesce ? pbc_start : ta) + sc[K_DATA_NS];
        const double ack = t_written + sc[K_OW_CPU_SW1];
        const double lat = ack - t;
        const double over_now = lat > sc[K_LAT_TARGET] ? 1.0 : 0.0;
        const double cnt1 = st_row[S_PERSIST_CNT] + 1.0;
        const double over1 = st_row[S_SLO_OVER] + over_now;
        const bool tight = over1 > sc[K_LAT_TOL] * cnt1;
        const bool commit = t_written <= crash;

        signed char st3[SPL], st4[SPL], own3[SPL];
        double dd2[SPL], dd4[SPL], lru3[SPL];
        int tag3[SPL], ver3[SPL];
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j;
          const int sp = s < P ? s : 0;
          const bool vsl = needs_victim && s == victim_idx;
          const int st2 = vsl ? DRAIN : st1[j];
          dd2[j] = vsl ? victim_dd : m.dd[sp];
          const bool w = s == wslot;
          st3[j] = static_cast<signed char>(w ? DIRTY : st2);
          tag3[j] = w ? addr : m.tag[sp];
          lru3[j] = w ? t_written : m.lru[sp];
          ver3[j] = w ? v_new : m.ver[sp];
          own3[j] = static_cast<signed char>(w ? tid : m.owner[sp]);
        }

        PROF(SEC_SELECT);
        double policy_writes;
        double pmb2_mine = 0.0;  // pm_busy2[lane] (B <= 32)
        if (!is_rf) {
          // drain_immediate: ack at the switch, drain at once
          const double pm_start2 =
              fmax(pmb1(bank), t_written + sc[K_OW_SW1_PM]);
          const double dd_new =
              pm_start2 + sc[K_NVM_WRITE] + sc[K_OW_SW1_PM];
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const int s = lane + 32 * j;
            st4[j] = s == wslot ? static_cast<signed char>(DRAIN) : st3[j];
            dd4[j] = s == wslot ? dd_new : dd2[j];
          }
          if (lane < B)
            pmb2_mine = lane == bank ? pm_start2 + sc[K_NVM_W_OCC] : pmb1(lane);
          policy_writes = 1.0;
        } else {
          // drain_threshold_preset: threshold/preset drain-down over LRU
          // Dirty entries, per-bank burst serialization
          const bool scoped = sc[K_DRAIN_SCOPE] > 0.0;
          bool dmask[SPL], emask[SPL];
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const int s = lane + 32 * j;
            const bool act = s < n_pbe;
            const bool in_scope = scoped ? own3[j] == tid : true;
            dmask[j] = st3[j] == DIRTY && act && in_scope;
            emask[j] = st3[j] == EMPTY && act;
          }
          const int dcnt = warp_count(dmask, tiles);
          const int ecnt = warp_count(emask, tiles);
          double thr = scoped ? m.ten[T_THRESHOLD * T + tid] : sc[K_THRESHOLD];
          double pre = scoped ? m.ten[T_PRESET * T + tid] : sc[K_PRESET];
          thr = tight ? 1.0 : thr;
          pre = tight ? 0.0 : pre;
          const double dirty_cnt = static_cast<double>(dcnt);
          const bool do_drain = dirty_cnt >= thr;
          const double k_thresh = do_drain ? dirty_cnt - pre : 0.0;
          const double k_low = static_cast<double>(ecnt) <= sc[K_EMPTY_SLACK]
                                   ? fmin(sc[K_LOW_WATER], dirty_cnt)
                                   : 0.0;
          const double k = fmax(k_thresh, k_low);
          // stable-sort rank of the LRU key among the Dirty-masked
          // slots: #{q: key_q < key_s or (key_q == key_s and q < s)};
          // the others key INF and never count.  Lanes walk the masked
          // slots q (a ballot per tile) and take key_q by shuffle.
          int rank[SPL], bank[SPL];
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            rank[j] = 0;
            bank[j] = bank_of(tag3[j]);
          }
#pragma unroll
          for (int jq = 0; jq < SPL; ++jq) {
            if (jq >= tiles) break;
            for (unsigned bits = __ballot_sync(FULL, dmask[jq]); bits;
                 bits &= bits - 1) {
              const int l = __ffs(bits) - 1, q = 32 * jq + l;
              const double kq = __shfl_sync(FULL, lru3[jq], l);
#pragma unroll
              for (int j = 0; j < SPL; ++j) {
                const int s = lane + 32 * j;
                rank[j] += (kq < lru3[j]) || (kq == lru3[j] && q < s);
              }
            }
          }
          bool todo[SPL];
#pragma unroll
          for (int j = 0; j < SPL; ++j)
            todo[j] = dmask[j] && static_cast<double>(rank[j]) < k;
          // per-bank burst order: the drained slots of the same bank
          // with a lower rank
          unsigned todo_bits[SPL];
          int rank_b[SPL];
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            todo_bits[j] = j < tiles ? __ballot_sync(FULL, todo[j]) : 0u;
            rank_b[j] = 0;
          }
#pragma unroll
          for (int jq = 0; jq < SPL; ++jq) {
            for (unsigned bits = todo_bits[jq]; bits; bits &= bits - 1) {
              const int l = __ffs(bits) - 1;
              const int rq = __shfl_sync(FULL, rank[jq], l);
              const int bq = __shfl_sync(FULL, bank[jq], l);
#pragma unroll
              for (int j = 0; j < SPL; ++j)
                rank_b[j] += bq == bank[j] && rq < rank[j];
            }
          }
          double busy[SPL];
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const double start =
                fmax(pmb1(bank[j]), t_written + sc[K_OW_SW1_PM]) +
                static_cast<double>(rank_b[j]) * sc[K_NVM_W_OCC];
            st4[j] = todo[j] ? static_cast<signed char>(DRAIN) : st3[j];
            dd4[j] = todo[j] ? start + sc[K_NVM_WRITE] + sc[K_OW_SW1_PM]
                             : dd2[j];
            busy[j] = start + sc[K_NVM_W_OCC];
          }
          // pm_busy2: each bank's latest drained burst (lane b, B <= 32)
          double mx = 0.0;
#pragma unroll
          for (int jq = 0; jq < SPL; ++jq) {
            for (unsigned bits = todo_bits[jq]; bits; bits &= bits - 1) {
              const int l = __ffs(bits) - 1;
              const int bq = __shfl_sync(FULL, bank[jq], l);
              const double bz = __shfl_sync(FULL, busy[jq], l);
              if (bq == lane) mx = fmax(mx, bz);
            }
          }
          if (lane < B) pmb2_mine = fmax(pmb1(lane), mx);
          policy_writes = k;
        }
        PROF(SEC_DRAIN);
        const double pmb1_mine = lane < B ? pmb1(lane) : 0.0;
        const double stall = is_coalesce ? 0.0 : ta - pbc_start;
        const double pbc_free =
            fmax(fmax(pbc_prev, arr) + sc[K_PBC_OCC],
                 (is_coalesce || ta <= pbc_start) ? 0.0 : ta);
        const double pm_writes_inc =
            (vic_emit ? 1.0 : 0.0) + (commit ? policy_writes : 0.0);
        const int hist = lat_bin(lat, m.edges);
        // the originals the commit gate falls back to
        signed char st_o[SPL], own_o[SPL];
        double lru_o[SPL], dd_o[SPL];
        int tag_o[SPL], ver_o[SPL];
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int sp = min(lane + 32 * j, P - 1);
          st_o[j] = m.state[sp];
          own_o[j] = m.owner[sp];
          lru_o[j] = m.lru[sp];
          dd_o[j] = m.dd[sp];
          tag_o[j] = m.tag[sp];
          ver_o[j] = m.ver[sp];
        }
        __syncwarp();
        // ---- write phase: switch-commit gate --------------------------
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j;
          if (s < P) {
            const bool vsl = vic_emit && s == victim_idx;
            if (commit) {
              const bool drained_now = st4[j] == DRAIN && st3[j] == DIRTY;
              const bool drain_ok = drained_now && dd4[j] <= crash &&
                                    tag3[j] >= 0 && tag3[j] < n_track;
              if (drain_ok && !is_chain)
                atomicMax(&pm_ver[clampi(tag3[j], 0, A - 1)], ver3[j]);
              m.state[s] = st4[j];
              m.tag[s] = tag3[j];
              m.lru[s] = lru3[j];
              m.dd[s] = dd4[j];
              m.ver[s] = ver3[j];
              m.owner[s] = own3[j];
            } else {
              m.state[s] = vsl ? static_cast<signed char>(DRAIN) : st_o[j];
              m.dd[s] = vsl ? (is_chain ? vack : victim_dd) : dd_o[j];
              m.tag[s] = tag_o[j];
              m.lru[s] = lru_o[j];
              m.ver[s] = ver_o[j];
              m.owner[s] = own_o[j];
            }
          }
        }
        // switch chain, policy-drain leg: the drains just scheduled leave
        // the PBC together at t_written, in LRU order (ties to the lower
        // slot), and their downstream acks replace the PM-path dd
        double pmw_c = 0.0;
        if constexpr (D > 0) {
          if (is_chain) {
            PROF(SEC_WRITE);
            bool pol[SPL];
            int pol_rank[SPL];
#pragma unroll
            for (int j = 0; j < SPL; ++j) {
              pol[j] = commit && lane + 32 * j < P && st4[j] == DRAIN &&
                       st3[j] == DIRTY;
              pol_rank[j] = 0;
            }
#pragma unroll
            for (int jq = 0; jq < SPL; ++jq) {
              if (jq >= tiles) break;
              for (unsigned bits = __ballot_sync(FULL, pol[jq]); bits;
                   bits &= bits - 1) {
                const int l = __ffs(bits) - 1, q = 32 * jq + l;
                const double kq = __shfl_sync(FULL, lru3[jq], l);
#pragma unroll
                for (int j = 0; j < SPL; ++j) {
                  const int s = lane + 32 * j;
                  pol_rank[j] += (kq < lru3[j]) || (kq == lru3[j] && q < s);
                }
              }
            }
            const int n_pol = warp_count(pol, tiles);
            const Pkts b0 = ch.list(0);
#pragma unroll
            for (int j = 0; j < SPL; ++j) {
              if (pol[j]) {
                const int o = pol_rank[j];
                b0.pos[o] = o;
                b0.oslot[o] = lane + 32 * j;
                b0.addr[o] = tag3[j];
                b0.ver[o] = ver3[j];
                b0.owner[o] = own3[j];
                b0.ohop[o] = 0;
                b0.emit[o] = t_written;
              }
            }
            __syncwarp();  // the hop-1 columns and the batch are written
            PROF(SEC_C_BATCH);
            if (n_pol > 0)
              pmw_c = ch.forward(scheme, P, n_pol, m.dd, false, lookups);
            if (lane < B) m.pm_busy[lane] = ch.pmb_r;
          }
        }
        if (!is_chain && lane < B)
          m.pm_busy[lane] = commit ? pmb2_mine : pmb1_mine;
        PROF(SEC_WRITE);
        if (lane == 0) {
          if (vic_ok && !is_chain)
            atomicMax(&pm_ver[clampi(vic_tag, 0, A - 1)], vic_ver);
          if (commit && tracked) aver[a_idx] += 1;
          m.hop[H_FWD_CNT] += commit ? 1.0 : 0.0;
          m.hop[H_FWD_SUM] += commit ? t_written - arr : 0.0;
          m.hop[H_COALESCES] += (is_coalesce && commit) ? 1.0 : 0.0;
          st_row[S_VICTIM_CNT] += (!is_coalesce && !any_empty) ? 1.0 : 0.0;
          st_row[S_PBCQ_SUM] += fmax(pbc_prev - arr, 0.0);
          st_row[S_PERSIST_SUM] += ack - t;
          st_row[S_PERSIST_CNT] += 1.0;
          st_row[S_SLO_OVER] += over_now;
          st_row[S_COALESCES] += is_coalesce ? 1.0 : 0.0;
          st_row[S_PM_WRITES] += is_chain ? pmw_v + pmw_c : pm_writes_inc;
          st_row[S_STALL_TIME] += stall;
          st_row[S_ACKED] += ack <= crash ? 1.0 : 0.0;
          st_row[S_DURABLE] += commit ? 1.0 : 0.0;
          st_row[S_LAT_HIST0 + hist] += 1.0;
          m.pbc[0] = pbc_free;
          m.clock[c] = ack;
        }
        PROF(SEC_STATS);
      }
    } else if (op == OP_BARRIER) {  // centralized barrier per tenant
      const bool last = (m.bcount[tid] + 1) >= n_live_t;
      double ck[(1024 + 31) / 32];
      for (int k = lane, j = 0; k < C; k += 32, ++j) {
        const double released =
            (k == c) ? t : ((m.blocked[k] && m.tids[k] == tid) ? t : m.clock[k]);
        ck[j] = last ? released : (k == c ? INF * 0.9 : m.clock[k]);
      }
      __syncwarp();
      for (int k = lane, j = 0; k < C; k += 32, ++j) {
        m.clock[k] = ck[j];
        if (last && m.tids[k] == tid) m.blocked[k] = 0;
      }
      if (lane == 0) {
        if (last) {
          m.bcount[tid] = 0;
        } else {
          m.blocked[c] = 1;
          m.bcount[tid] = static_cast<short>(m.bcount[tid] + 1);
        }
      }
    }
    PROF(SEC_OTHER);
    // cursor and crash-clock bookkeeping; core c's next entry becomes
    // current and the ring slot it leaves takes entry p + RING - 1
    if (lane == 0) {
      m.ptr[c] = p_next;
      if (!live) m.clock[c] = t_issue;
      m.cop[c] = op_next;
      m.caddr[c] = addr_next;
      m.cgap[c] = gap_next;
      const int old = c * RING + (p_next - 1) % RING;
      const size_t e =
          static_cast<size_t>(c) * L + min(p_next + RING - 1, last_c);
      wg::cp_async_4(wg::smem_u32(&m.rop[old]), ops + e);
      wg::cp_async_4(wg::smem_u32(&m.raddr[old]), addrs + e);
      wg::cp_async_4(wg::smem_u32(&m.rgap[old]), gaps + e);
      wg::cp_async_commit();
    }
    __syncwarp();
    PROF(SEC_BOOK);
  }
#ifdef CELL_SCAN_PROFILE
  if (lane == 0) {
    long long* row = g_prof + static_cast<size_t>(cell) * N_PROF;
    for (int k = 0; k < N_SEC; ++k) row[k] = prof.acc[k];
    for (int k = 0; k < N_OPS; ++k) row[N_SEC + k] = prof_ops[k];
    row[N_PROF - 1] = prof.t - prof_t0;
  }
#endif

  // ---- recovery snapshot + runtime ----------------------------------------
  double rt = 0.0;
  for (int k = lane; k < C; k += 32) {
    const double ck = m.clock[k];
    rt = fmax(rt, ck < INF * 0.5 ? fmin(ck, crash) : 0.0);
  }
  rt = warp_max(rt);
  // the recovery pass and the outputs: the chain-free machine's as they
  // were (D = 0), or over every hop of the chain
  if constexpr (D == 0) {
    double n_rec = 0.0, cost = 0.0;
    double* rec_t = a.recov_t + static_cast<size_t>(cell) * T;
    if (scheme == 0) {
      for (int tt = lane; tt < T; tt += 32) rec_t[tt] = 0.0;
    } else {
      bool surv[SPL];
      int n = 0;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int s = lane + 32 * j;
        const int sp = s < P ? s : 0;
        const int v = m.state[sp];
        surv[j] = s < n_pbe &&
                  (v == DIRTY || (v == DRAIN && m.dd[sp] > crash));
        n += surv[j];
        if (surv[j] && m.tag[sp] >= 0 && m.tag[sp] < n_track)
          atomicMax(&pm_ver[clampi(m.tag[sp], 0, A - 1)], m.ver[sp]);
      }
      n = warp_sum(n);
      for (int tt = 0; tt < T; ++tt) {
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j;
          cnt += surv[j] && clampi(m.owner[s < P ? s : 0], 0, T - 1) == tt;
        }
        cnt = warp_sum(cnt);
        if (lane == 0) rec_t[tt] = static_cast<double>(cnt);
      }
      double worst = 0.0;
      for (int b = 0; b < B; ++b) {
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j;
          cnt += surv[j] && floor_mod(m.tag[s < P ? s : 0], B) == b;
        }
        worst = fmax(worst, static_cast<double>(warp_sum(cnt)));
      }
      n_rec = static_cast<double>(n);
      cost = n > 0 ? (worst - 1.0) * sc[K_NVM_W_OCC] + sc[K_NVM_WRITE] +
                         2.0 * sc[K_OW_SW1_PM]
                   : 0.0;
    }
    double* st_out = a.stats + static_cast<size_t>(cell) * T * N_STATS;
    for (int k = lane; k < T * N_STATS; k += 32) st_out[k] = stats[k];
    for (int k = lane; k < N_HOP_STATS; k += 32)
      a.hop_stats[static_cast<size_t>(cell) * N_HOP_STATS + k] = m.hop[k];
    if (lane == 0) {
      a.runtime[cell] = rt;
      a.n_recov[cell] = n_rec;
      a.recov_ns[cell] = cost;
      a.steps[cell] = steps;
      a.lookups[cell] = lookups;
    }
  } else {
    double n_rec = 0.0, cost = 0.0;
    double* rec_t = a.recov_t + static_cast<size_t>(cell) * T;
    double* rec_h = a.recov_h + static_cast<size_t>(cell) * (D + 1);
    if (scheme == 0) {
      for (int tt = lane; tt < T; tt += 32) rec_t[tt] = 0.0;
      for (int h = lane; h <= D; h += 32) rec_h[h] = 0.0;
    } else {
      // the union over the chain's hops: hop 1's survivors, then each
      // deep row's under the same rule (a Drain entry survives iff its
      // ack is lost), counted per hop, per owning tenant and per PM bank
      bool surv[D + 1][SPL];
      int n_all = 0;
      for (int h = 0; h <= D; ++h) {
        const bool live_h =
            h == 0 || static_cast<double>(h - 1) + 2.0 <= ch.n_sw;
        const int pbe_h =
            h == 0 ? n_pbe : static_cast<int>(ch.deep(DK_PBE, h - 1));
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j, sp = s < P ? s : 0;
          const int i = (h - 1) * P + sp;
          const int v = h == 0 ? m.state[sp] : ch.c.dstate[i];
          const double ack = h == 0 ? m.dd[sp] : ch.c.ddd[i];
          surv[h][j] = live_h && s < pbe_h &&
                       (h == 0 || ch.c.dwt[i] <= crash) &&
                       (v == DIRTY || (v == DRAIN && ack > crash));
          const int tg = h == 0 ? m.tag[sp] : ch.c.dtag[i];
          if (surv[h][j] && tg >= 0 && tg < n_track)
            atomicMax(&pm_ver[clampi(tg, 0, A - 1)],
                      h == 0 ? m.ver[sp] : ch.c.dver[i]);
        }
        const int nh = warp_count(surv[h], tiles);
        n_all += nh;
        if (lane == 0) rec_h[h] = static_cast<double>(nh);
      }
      for (int tt = 0; tt < T; ++tt) {
        int cnt = 0;
        for (int h = 0; h <= D; ++h) {
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const int sp = min(lane + 32 * j, P - 1);
            const int o = h == 0 ? m.owner[sp] : ch.c.downer[(h - 1) * P + sp];
            cnt += surv[h][j] && clampi(o, 0, T - 1) == tt;
          }
        }
        cnt = warp_sum(cnt);
        if (lane == 0) rec_t[tt] = static_cast<double>(cnt);
      }
      double worst = 0.0;
      for (int b = 0; b < B; ++b) {
        int cnt = 0;
        for (int h = 0; h <= D; ++h) {
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const int sp = min(lane + 32 * j, P - 1);
            const int tg = h == 0 ? m.tag[sp] : ch.c.dtag[(h - 1) * P + sp];
            cnt += surv[h][j] && floor_mod(tg, B) == b;
          }
        }
        worst = fmax(worst, static_cast<double>(warp_sum(cnt)));
      }
      n_rec = static_cast<double>(n_all);
      cost = n_all > 0 ? (worst - 1.0) * sc[K_NVM_W_OCC] + sc[K_NVM_WRITE] +
                             2.0 * sc[K_OW_SW1_PM]
                       : 0.0;
    }
    double* st_out = a.stats + static_cast<size_t>(cell) * T * N_STATS;
    for (int k = lane; k < T * N_STATS; k += 32) st_out[k] = stats[k];
    // hop_stats: row 0 (hop 1), then the chain's rows 1 .. D
    double* hop_out =
        a.hop_stats + static_cast<size_t>(cell) * (D + 1) * N_HOP_STATS;
    for (int k = lane; k < N_HOP_STATS; k += 32) hop_out[k] = m.hop[k];
    if (lane < D * N_HOP_STATS) hop_out[N_HOP_STATS + lane] = ch.hop_r;
    if (lane == 0) {
      a.runtime[cell] = rt;
      a.n_recov[cell] = n_rec;
      a.recov_ns[cell] = cost;
      a.steps[cell] = steps;
      a.lookups[cell] = lookups;
    }
  }
}

// ---- host entry point -------------------------------------------------
// n_deep (the grid's deep-hop rows, the D of the instantiation) is
// bounded by MAX_DEEP: chains of up to MAX_DEEP + 1 switches.
constexpr int MAX_DEEP = 3;

template <int SPL>
static int run_spl(Args& a, int n_cells, int n_deep, size_t smem,
                   cudaStream_t stream) {
  auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<n_cells, 32, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  };
  switch (n_deep) {
    case 0: return run(cell_scan_kernel<SPL, 0>);
    case 1: return run(cell_scan_kernel<SPL, 1>);
    case 2: return run(cell_scan_kernel<SPL, 2>);
    case 3: return run(cell_scan_kernel<SPL, 3>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int cell_scan_launch(
    const int* ops, const int* addrs, const float* gaps, const int* lengths,
    const int* cell_trace, const int* cell_cfg, const int* schemes,
    const double* sc_table, const double* ten_table,
    const double* lat_edges, double* runtime, double* stats,
    double* hop_stats, int* durable_ver, double* n_recov,
    double* recov_ns, double* recov_t, long long* steps, long long* lookups,
    int* aver, const double* chain_table, double* recov_h, int n_cells,
    int C, int L, int P, int B, int A, int T, int n_track, int n_deep,
    cudaStream_t stream) {
  Args a{ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
         sc_table, ten_table, lat_edges, runtime, stats, hop_stats,
         durable_ver, n_recov, recov_ns, recov_t, steps, lookups, aver,
         C, L, P, B, A, T, n_track, {}, chain_table, recov_h, {}};
  if (n_deep < 0 || n_deep > MAX_DEEP)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = carve(a.lay, nullptr, C, P, B, T);
  if (n_deep > 0) smem = carve_chain(a.clay, nullptr, smem, P, B, n_deep);
  if (P <= 32) return run_spl<1>(a, n_cells, n_deep, smem, stream);
  if (P <= 64) return run_spl<2>(a, n_cells, n_deep, smem, stream);
  return run_spl<MAX_SPL>(a, n_cells, n_deep, smem, stream);
}

#ifdef CELL_SCAN_PROFILE
// The profile's output: (n_cells, N_PROF) int64 on the device.
extern "C" int cell_scan_set_profile(long long* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, &buf, sizeof(buf)));
}
#endif
