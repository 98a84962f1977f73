// cell_scan: the timed PCS engine's issue-time merge loop on Hopper.
//
// Replaces repro/core/engine/step.py::scan_cell, the reference's
// lax.scan under jit(vmap(vmap)) (repro/core/engine/grid.py) — the TPU
// hot path of the simulator.  Its plain version is the eager torch
// repro_torch/core/engine/step.py::scan_cell; every expression below
// keeps that code's form and order (f64 adds, maxes and products, built
// with -fmad=false), so the two agree bit for bit.
//
// Scope: switch chains of up to MAX_DEEP + 1 = 4 switches, fan-out
// fabrics of up to MAX_LEAVES leaves and schedules of up to MAX_EPOCHS
// epochs — the handler and policy bodies with tenants, PBPolicy quotas
// and weighted victims, the SLO drain tightening, the crash gate and
// durability tracking, the deep-hop rows of engine/chain.py (the
// template's D, the grid's deep-row count; D = 0 compiles every chain
// statement out), the fabric of engine/fabric.py (the template's FAB,
// set when the grid holds a multi-leaf fabric; FAB = false compiles
// every fabric statement out), and the epoch rows of step.py's
// resolve_epoch_sc (the template's EP, set when the grid holds a
// Schedule; EP = false compiles every epoch statement out).
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
// write-back, and the PM landing.  SEC_MACRO is a MAC step's macro
// work: the head's gates and window replay, or a dead-run collapse.
enum ProfSection {
  SEC_KEYS, SEC_ARGMIN, SEC_FETCH, SEC_READ, SEC_LOOKUP, SEC_OCC,
  SEC_SELECT, SEC_DRAIN, SEC_WRITE, SEC_STATS, SEC_OTHER, SEC_BOOK,
  SEC_C_BATCH, SEC_C_READ, SEC_C_FIFO, SEC_C_MATCH, SEC_C_ALLOC,
  SEC_C_WRITER, SEC_C_DRANK, SEC_C_LAND, SEC_MACRO, N_SEC
};
constexpr int N_OPS = 6, N_PROF = N_SEC + N_OPS + 1;
#ifdef CELL_SCAN_PROFILE
// one per unit of the split build (cell_scan_set_profile sets each)
static __device__ long long* g_prof;
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

// The least of the warp's keys, each a non-negative double (as for
// warp_argmin_lane): two reductions of the bits' halves.
__device__ __forceinline__ double warp_min_nonneg(double key) {
  unsigned long long bits;
  memcpy(&bits, &key, sizeof bits);
  const unsigned hi = static_cast<unsigned>(bits >> 32);
  const unsigned lo = static_cast<unsigned>(bits);
  const unsigned min_hi = __reduce_min_sync(FULL, hi);
  const unsigned min_lo = __reduce_min_sync(FULL, hi == min_hi ? lo : ~0u);
  bits = (static_cast<unsigned long long>(min_hi) << 32) | min_lo;
  memcpy(&key, &bits, sizeof bits);
  return key;
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

// NL: the PBC clocks, one per leaf switch of a fabric grid (else 1).
__host__ __device__ size_t carve(Smem& m, unsigned char* base, int C, int P,
                                 int B, int T, int NL = 1) {
  Carver cv{base, 0};
  m.clock = cv.take<double>(C);
  m.lru = cv.take<double>(P);
  m.dd = cv.take<double>(P);
  m.pm_busy = cv.take<double>(B);
  m.stats = cv.take<double>(static_cast<size_t>(T) * N_STATS);
  m.hop = cv.take<double>(N_HOP_STATS);
  m.pbc = cv.take<double>(NL);
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
  // pad: the place of a field no kernel reads any more, which keeps
  // Args' layout and so the D = 0 kernels' parameter offsets
  double *dlru, *ddd, *dwt, *csc, *pad, *emit0, *emit1, *wcommit;
  int *dtag, *dver, *pos0, *pos1, *oslot0, *oslot1, *addr0, *addr1, *ver0,
      *ver1, *wver, *waddr, *bcnt;
  unsigned long long* bnew;
  signed char *dstate, *downer, *ohop0, *ohop1, *own0, *own1, *wflag, *wown;
};

#define CHAIN_FIELDS(X)                                                     \
  X(dlru) X(ddd) X(dwt) X(csc) X(emit0) X(emit1) X(wcommit) X(dtag)         \
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

// ---- the fan-out fabric (engine/fabric.py) -------------------------------
// Leaf i of a fabric owns the hop-1 slots from its base on; a lane keeps
// its slots' leaves in registers, and the tenants' leaves (lof) wait in
// shared memory after the chain's arrays.  The fabric table's row per
// config: FAB_KEYS, then the NL leaf bases, then the T tenants' leaves.
enum FabKey { F_N_LEAVES, F_BP_HIGH, N_FK };
constexpr int MAX_LEAVES = 32;

struct FabSmem {
  int* lof;  // (T,) tenant t's leaf switch
};

__host__ __device__ size_t carve_fab(FabSmem& f, unsigned char* base,
                                     size_t off, int T) {
  Carver cv{base, off};
  f.lof = cv.take<int>(T);
  return cv.off;
}

// ---- epoch schedules (step.py resolve_epoch_sc) ---------------------------
// A scheduled grid's epoch table holds, per config and epoch, the rows a
// Schedule may change (state.py EPOCH_KEYS): threshold, preset and SLO
// target (EpKey), the N_TEN tenant rows, the deep rows' thr and pre
// (D1 = max(D, 1) values each) and the T tenants' leaves; beside it
// the config's E - 1 boundaries (INF past its own).  The cell keeps one
// epoch's rows where the schedule-free kernel keeps the config's (sc,
// m.ten, the chain's csc, the fabric's lof), epoch 0's from the config
// tables, and copies another epoch's over them when an op issues in it.
enum EpKey { E_THRESHOLD, E_PRESET, E_LAT_TARGET, N_EK };
constexpr int MAX_EPOCHS = 8;

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
// tile is carried.  Per-slot work runs on the owning lanes.  Only the
// commit-latency sum stays in order, packet by packet (its order is the
// reference's).  Lane j holds row j's PBC clock, lane l the deep rows'
// telemetry value l, and lane b bank b's PM clock during a forward, so
// none of them passes through shared memory.  `pm_ver` is the cell's
// durable-version row (global).
//
// A batch of at most one packet — most of them — is lone: every lane
// holds the packet in registers (a Pkt), and its row's FIFO start,
// coalesce match, slot choice, writer hand-off, drain rank and PM
// landing are evaluated on every lane at once with no warp operation but
// the match and the ballots of the row's drain-down.  The victim leg's
// packet and a policy batch of one enter the chain lone, never written
// to a list; its ack goes to the slot's owner, which read that slot
// earlier in program order, so no __syncwarp orders them.  Each row
// hands on a list (its bypass and drains: an owner's store and one load
// measured shorter than keeping a bypass in registers or shuffling a
// drained entry from its owner), taken lone by the next row or the
// landing when it holds one packet.
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

  // _pm_land at switch `pos_sw`: the batch's n packets land at PM
  // (per-bank burst order, the banks' clocks on lanes < B); the acks of
  // the batch's last block (`last`, >= 1) go to deep row last-1.  A lone
  // batch (n <= 1) is `pk`, held by every lane, else list b.  Returns
  // the writes.
  __device__ double land(const Pkts& b, int n, int pos_sw, int last,
                         const Pkt& pk1, bool lone) {
    const double rem = fmax(n_sw - static_cast<double>(pos_sw), 0.0);
    const double path_down = link_ns + rem * hop_ns;
    if (lone) {
      if (n == 1) {
        const int bk = bank_of(pk1.addr);
        const double start =
            fmax(__shfl_sync(FULL, pmb_r, bk), pk1.emit + path_down) +
            static_cast<double>(0) * w_occ;
        const double path_up =
            link_ns +
            fmax(n_sw - static_cast<double>(pk1.ohop + 1), 0.0) * hop_ns;
        const double dd_val = start + nvm_write + path_up;
        if (lane == 0 && dd_val <= crash && pk1.addr >= 0 &&
            pk1.addr < n_track)
          atomicMax(&pm_ver[clampi(pk1.addr, 0, A - 1)], pk1.ver);
        if (pk1.ohop == last && lane == (pk1.oslot & 31))
          c.ddd[idx(last - 1, pk1.oslot)] = dd_val;
        const double end = start + w_occ;
        if (lane < B)
          pmb_r = fmax(pmb_r, lane == bk ? (end > 0.0 ? end : 0.0) : 0.0);
      } else if (lane < B) {
        pmb_r = fmax(pmb_r, 0.0);
      }
      PROF(SEC_C_LAND);
      return static_cast<double>(n);
    }
    const bool tiled = n > 32;  // ranks carried from tile to tile
    Pkt pk = b.at(lane < n ? lane : 0);
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

  // _place of the batch's n packets (Q in the full batch) into row j,
  // its own drain-down, and the next list nx; returns the next list's
  // count.  A lone batch (n <= 1, `lone`) comes in `pk1`, held by every
  // lane, a larger one in list b.  Row 0's acks go to the hop-1 dd sink:
  // `ack0` (every lane) when `single`, else `dd1`.
  __device__ int place(int j, int scheme, const Pkts& b, int n, int Q,
                       const Pkt& pk1, bool lone, const Pkts& nx,
                       double* dd1, bool single, double& ack0,
                       long long& lookups) {
    const double tag_j = deep(DK_TAG, j), data_j = deep(DK_DATA, j);
    const int pbe_j = static_cast<int>(deep(DK_PBE, j));
    const double busy = __shfl_sync(FULL, hpbc_r, j);
    // the batch's first tile, and the row as the batch finds it
    Pkt pk = lone ? pk1 : b.at(lane < n ? lane : 0);
    const double emit0 = lone ? pk.emit : b.emit[0];
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
    // is packet 0's, evaluated here as its own lane evaluates it (and a
    // lone packet's is its own).
    double run0 = -INF;
    const double start0 = fifo_start(emit0, true, 0, 1, busy, run0);
    double t0 = -INF;
    if (n > 0) {
      if (pbc_occ >= 0.0 || lone) {
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
    if (lone) {
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
      // the origin's ack: every lane holds it for the victim leg, else
      // the slot's owner writes it
      if (ended && pk.ohop == j) {
        const double dd_val =
            cm + (static_cast<double>(j + 2) -
                  (static_cast<double>(pk.ohop) + 1.0)) * hop_ns;
        if (j == 0 && single)
          ack0 = dd_val;
        else if (lane == (pk.oslot & 31))
          (j == 0 ? dd1 : c.ddd + idx(j - 1, 0))[pk.oslot] = dd_val;
      }
      if (one && !ended) {  // on toward the next switch
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
            dd1[oslot] = dd_val;  // a tiled batch is never the victim leg
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
      // a lone Dirty entry ranks 0, and ranks order only drains
      if (n_dirty < 2 || !(k > 0.0)) break;
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

  // chain.drain_pending: whether a live row's own drain-down would drain
  // now (k > 0).  The reference forwards every buffered persist's victim
  // leg and policy batch, with or without a packet; one with none
  // changes nothing while each row sits at or under its drain count, as
  // every forward leaves it, so the kernel skips it — unless a schedule
  // has lowered a row's threshold since the last forward (EP only).  The
  // rows are walked by constant index, as everywhere, so that pbe stays
  // in registers.
  __device__ bool pending(int scheme) const {
    bool any = false;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      bool dirty[SPL];
#pragma unroll
      for (int jj = 0; jj < SPL; ++jj) {
        const int s = lane + 32 * jj;
        dirty[jj] = j < live_rows && s < pbe[j] &&
                    c.dstate[idx(j, s < P ? s : 0)] == DIRTY;
      }
      const double cnt = static_cast<double>(warp_count(dirty, tiles));
      const double k =
          scheme == 1 ? cnt
                      : (cnt >= deep(DK_THR, j) ? cnt - deep(DK_PRE, j) : 0.0);
      any |= j < live_rows && k > 0.0;
    }
    return any;
  }

  // forward_chain: the batch's n packets (Q0 in the full batch; lone in
  // `pk` when n <= 1, else in list 0) placed into the live rows; the rest
  // land at PM from the first row past the depth.  Each row hands on a
  // list, which the next row and the landing take lone when it holds at
  // most one packet.  Row 0's acks go to `ack0` when `single` (the victim
  // leg), else to `dd1`.  Returns the PM writes.
  __device__ double forward(int scheme, int Q0, int n, Pkt pk, double* dd1,
                            bool single, double& ack0, long long& lookups) {
    int cur = 0, Q = Q0, j = 0;
    bool lone = n <= 1;
#pragma unroll 1
    for (; j < live_rows; ++j) {
      n = place(j, scheme, list(cur), n, Q, pk, lone, list(1 - cur), dd1,
                single, ack0, lookups);
      cur = 1 - cur;
      Q += P;
      lone = n <= 1;
      if (lone) pk = list(cur).at(0);
    }
    return land(list(cur), n, j + 1, j, pk, lone);
  }

  // deep_read, in two parts: probe reads, with no branch, which of each
  // lane's slots of the live deep rows hold `addr` (bit j SPL + jj: slot
  // lane + 32 jj of row j; every row's tags load at once, a predicate on
  // the row's liveness measured slower); pick, when some row
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

// ---- macro-steps (engine/macro.py) ---------------------------------------
// A live head's window of up to MAC_KMAX ops of its core, planned by
// traces.plan_runs (mlen), commits or aborts as macro_step decides; the
// kernel counts the outcome (the slots committed, or one abort reason)
// and advances the state slot by slot as ever: a committed window's ops
// are, by its no-interleave gate, the next steps of its core, so the
// state is exact by construction and the verdict alone needs the
// replay.  A dead post-crash run collapses for real (up to MAC_KMAX
// slots in one step), as the reference's does, so that the steps — and
// with them the heads counted — are the reference's.
//
// Every step of a multi-core grid is a live head, and nearly all of them
// abort on interleave.  So a head is decided from what the step holds
// anyway: the run plan's length rides in the op word (OPS_MLEN_SHIFT;
// the host packs it, kernels/cell_scan.py pack_ops), and bounds of the
// window's second issue time (op 0's completion plus the first gap, the
// ring's entry p + 1) go against the merge's keys in one vote.  Only a
// head that no bound settles loads its window and replays it, on a
// scratch copy (Scratch).  A cell whose fabric or chain gate settles
// every head and that never loses power runs no head: its counts
// follow from the run plan when the cell ends.
constexpr int MAC_KMAX = 8;  // params.MACRO_KMAX
// MACRO_ABORT_REASONS, in their order; MAC_COMMIT: the window commits
enum MacReason { R_WINDOW, R_FABRIC, R_DEEP, R_EPOCH, R_INTERLEAVE, R_GUARD,
                 N_REASONS, MAC_COMMIT = -1 };
// The op word under MAC: the op code in the low OPS_MLEN_SHIFT bits, the
// run plan's length (1..MAC_KMAX) above them.
constexpr int OPS_MLEN_SHIFT = 8;
template <bool MAC>
__device__ __forceinline__ int op_code(int word) {
  return MAC ? (word & ((1 << OPS_MLEN_SHIFT) - 1)) : word;
}

// The replay's scratch copy of the slots a window moves (state, owner,
// tag, LRU stamp and drain ack; lane l copies and replays its own slots
// l + 32 j, so no lane reads another's), after the fabric's carve-up.
struct MacSmem {
  double *lru, *dd;
  int* tag;
  signed char *state, *owner;
};

__host__ __device__ size_t carve_mac(MacSmem& s, unsigned char* base,
                                     size_t off, int P) {
  Carver cv{base, off};
  s.lru = cv.take<double>(P);
  s.dd = cv.take<double>(P);
  s.tag = cv.take<int>(P);
  s.state = cv.take<signed char>(P);
  s.owner = cv.take<signed char>(P);
  return cv.off;
}

__device__ __forceinline__ MacSmem rebase_mac(MacSmem s, unsigned char* base) {
#define REBASE(f) \
  s.f = reinterpret_cast<decltype(s.f)>(base + reinterpret_cast<size_t>(s.f));
  REBASE(lru) REBASE(dd) REBASE(tag) REBASE(state) REBASE(owner)
#undef REBASE
  return s;
}

// The replay's scratch copy of lane l's slots l + 32 j, j < SPL, taken
// slot by slot (the caller guards j's slot below n_pbe): in shared
// memory (SMEM, the MacSmem area) or in registers.  The D = 0 kernels
// take shared memory, where their step is the shortest and a replay the
// rarest; the D >= 1 kernels registers, where a one-core grid (Fig. 1)
// replays every window.
template <int SPL, bool SMEM>
struct Scratch;

template <int SPL>
struct Scratch<SPL, true> {
  MacSmem ms;
  int lane;
  __device__ signed char& st(int j) { return ms.state[lane + 32 * j]; }
  __device__ signed char& own(int j) { return ms.owner[lane + 32 * j]; }
  __device__ int& tg(int j) { return ms.tag[lane + 32 * j]; }
  __device__ double& lru(int j) { return ms.lru[lane + 32 * j]; }
  __device__ double& dd(int j) { return ms.dd[lane + 32 * j]; }
};

template <int SPL>
struct Scratch<SPL, false> {
  signed char st_[SPL], own_[SPL];
  int tg_[SPL];
  double lru_[SPL], dd_[SPL];
  __device__ Scratch(const MacSmem&, int) {}
  __device__ signed char& st(int j) { return st_[j]; }
  __device__ signed char& own(int j) { return own_[j]; }
  __device__ int& tg(int j) { return tg_[j]; }
  __device__ double& lru(int j) { return lru_[j]; }
  __device__ double& dd(int j) { return dd_[j]; }
};

// macro_step's live window from a head at cursor p of core c (every lane,
// with the same values), for a head the caller's gates did not settle:
// the window floor, then the window's clocks and guard
// replayed on the scratch copy — each lane's slots in `ms`, bank b's PM
// clock on lane b, the PBC clock that serves the op (`pbc0`), the
// tenant's persist and SLO-over counts — in macro.py's expressions and
// order, the config's latencies read from the cell's row as the replay
// starts.  Once the guard clears only the clocks go on (they alone
// decide t_last, and no slot state feeds them).  Returns the first
// failing gate of epoch_boundary, interleave and guard, or MAC_COMMIT.
// `others_min`: every other core's issue time, least;
// `next_bound`: the next epoch boundary (EP; INF otherwise).  Exact
// shortcuts (macro.py): while no op completes before it issues, the
// window's gaps added in order to t_issue bound t_last below, so a floor
// at or past the settling bound (next_bound under EP, else others_min)
// aborts with no replay; under EP, another core at or below the floor
// leaves epoch_boundary or interleave, which the clocks alone decide
// (the replay starts with the guard cleared); and with non-negative gaps
// the replay stops at the first op issuing at or past the settling bound.
template <int SPL, bool EP, bool SMEM>
__device__ __forceinline__ int macro_verdict(
    const Smem& m, const MacSmem& ms, const double* st_row, int lane, int c,
    int tid, int scheme, int k_live, double t_issue, bool floor_ok,
    const int* w_ops, const int* w_addrs, const float* w_gaps,
    double others_min, double next_bound, double pbc0, double crash,
    int n_pbe, int T, int B, int tiles, const Banks& bank_of) {
  const double stop = EP ? next_bound : others_min;
  const int settled = EP ? R_EPOCH : R_INTERLEAVE;
  // the window's entries, lane j holding entry j
  const int jw = lane < MAC_KMAX ? lane : 0;
  const float w_gap = w_gaps[jw];
  bool monotone = floor_ok, guard = true;
  if (floor_ok) {
    double lb = t_issue;
    for (int j = 1; j < k_live; ++j) {
      const float g = __shfl_sync(FULL, w_gap, j);
      lb = lb + static_cast<double>(g);
      monotone = monotone && g >= 0.0f;
    }
    if (lb >= stop) return settled;
    // (only under EP can another core sit at or below the floor here)
    guard = !(others_min <= lb);
  }
  const int w_op = op_code<true>(w_ops[jw]), w_addr = w_addrs[jw];
  const bool is_nopb = scheme == 0, is_rf = scheme == 2;
  const double* sc = m.sc;
  const double ow_cpu_pm = sc[K_OW_CPU_PM], nvm_read = sc[K_NVM_READ],
               nvm_r_occ = sc[K_NVM_R_OCC], nvm_write = sc[K_NVM_WRITE],
               nvm_w_occ = sc[K_NVM_W_OCC], ow_cpu_sw1 = sc[K_OW_CPU_SW1],
               pbc_proc_tag = sc[K_PBC_PROC] + sc[K_TAG_NS],
               data_ns = sc[K_DATA_NS], ow_sw1_pm = sc[K_OW_SW1_PM],
               pbc_occ = sc[K_PBC_OCC];
  // the scratch copy of this lane's slots (only slots below n_pbe take
  // part in a window, and none under NoPB)
  Scratch<SPL, SMEM> sx{ms, lane};
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int s = lane + 32 * j;
    if (!is_nopb && s < n_pbe) {
      sx.st(j) = m.state[s];
      sx.tg(j) = m.tag[s];
      sx.lru(j) = m.lru[s];
      sx.dd(j) = m.dd[s];
      sx.own(j) = m.owner[s];
    }
  }
  double pmb_r = lane < B ? m.pm_busy[lane] : 0.0;  // B <= 32
  double pbc = pbc0, clk = m.clock[c], t_last = t_issue;
  double cnt = st_row[S_PERSIST_CNT], over = st_row[S_SLO_OVER];
  // with no other core issuing (and, under EP, no boundary ahead) t_last
  // decides nothing: a cleared guard is the verdict
  const bool guard_decides =
      others_min >= INF && (!EP || next_bound >= INF);
  for (int j = 0; j < k_live; ++j) {
    if (guard_decides && !guard) return R_GUARD;
    const int o_j = __shfl_sync(FULL, w_op, j);
    const int a_j = __shfl_sync(FULL, w_addr, j);
    const double t_j = clk + static_cast<double>(__shfl_sync(FULL, w_gap, j));
    t_last = t_j;
    if (monotone && t_j >= stop) break;  // t_last >= t_j: settled
    const int bank = bank_of(a_j);
    const double pmb_b = __shfl_sync(FULL, pmb_r, bank);
    if (o_j != OP_PERSIST) {
      // PM read: the handler's miss path in both schemes
      const double pm_start_r = fmax(pmb_b, t_j + ow_cpu_pm);
      bool g_op = t_j <= crash;
      if (!is_nopb && guard) {
        bool hit[SPL];
#pragma unroll
        for (int jj = 0; jj < SPL; ++jj) {
          const int s = lane + 32 * jj;
          hit[jj] = false;
          if (s < n_pbe) {
            int st = sx.st(jj);
            if (st == DRAIN && sx.dd(jj) <= t_j) sx.st(jj) = st = EMPTY;
            hit[jj] = sx.tg(jj) == a_j && st != EMPTY;
          }
        }
        g_op = g_op && warp_count(hit, tiles) == 0;
      }
      guard = guard && g_op;
      if (lane == bank) pmb_r = pm_start_r + nvm_r_occ;
      clk = pm_start_r + nvm_read + ow_cpu_pm;
    } else if (is_nopb) {
      // persist, NoPB leg
      const double pm_start_w = fmax(pmb_b, t_j + ow_cpu_pm);
      guard = guard && t_j <= crash;
      if (lane == bank) pmb_r = pm_start_w + nvm_w_occ;
      clk = pm_start_w + nvm_write + ow_cpu_pm;
    } else {
      // persist, buffered leg (a fresh Empty slot)
      const double arr = t_j + ow_cpu_sw1;
      const double pbc_start = fmax(pbc, arr) + pbc_proc_tag;
      const double t_written = pbc_start + data_ns;
      const double ack_p = t_written + ow_cpu_sw1;
      const double over_j = ack_p - t_j > sc[K_LAT_TARGET] ? 1.0 : 0.0;
      if (guard) {
        // each slot's state after the lazy free at pbc_start, and owner
        signed char st[SPL], own[SPL];
        bool dirty_hit[SPL], live_own[SPL];
#pragma unroll
        for (int jj = 0; jj < SPL; ++jj) {
          const int s = lane + 32 * jj;
          st[jj] = EMPTY;
          own[jj] = 0;
          dirty_hit[jj] = live_own[jj] = false;
          if (s < n_pbe) {
            st[jj] = sx.st(jj);
            own[jj] = sx.own(jj);
            if (st[jj] == DRAIN && sx.dd(jj) <= pbc_start)
              sx.st(jj) = st[jj] = EMPTY;
            dirty_hit[jj] = sx.tg(jj) == a_j && st[jj] == DIRTY;
            live_own[jj] = st[jj] != EMPTY && clampi(own[jj], 0, T - 1) == tid;
          }
        }
        const bool has_dirty = warp_count(dirty_hit, tiles) > 0;
        const double occ_t = static_cast<double>(warp_count(live_own, tiles));
        const bool over_quota = occ_t >= m.ten[T_QUOTA * T + tid];
        double ke = INF;
        int ie = lane;
        bool any_e = false;
#pragma unroll
        for (int jj = 0; jj < SPL; ++jj) {
          const int s = lane + 32 * jj;
          const bool e = s < n_pbe && st[jj] == EMPTY && !over_quota;
          any_e |= e;
          const double k1 = e ? sx.lru(jj) : INF;
          if (k1 < ke) {
            ke = k1;
            ie = s;
          }
        }
        const bool any_empty = __any_sync(FULL, any_e);
        warp_argmin(ke, ie);
        const int wslot = ie;
#pragma unroll
        for (int jj = 0; jj < SPL; ++jj) {
          const int s = lane + 32 * jj;
          if (s == wslot) {
            st[jj] = DIRTY;
            own[jj] = static_cast<signed char>(tid);
            sx.st(jj) = DIRTY;
            sx.tg(jj) = a_j;
            sx.lru(jj) = t_written;
            sx.own(jj) = static_cast<signed char>(tid);
          }
        }
        bool g_wr = any_empty && t_written <= crash;
        if (is_rf) {
          // the threshold/preset drain-down must fire no drain
          const bool scoped = sc[K_DRAIN_SCOPE] > 0.0;
          bool dm[SPL], em[SPL];
#pragma unroll
          for (int jj = 0; jj < SPL; ++jj) {
            const int s = lane + 32 * jj;
            const bool in_scope = scoped ? own[jj] == tid : true;
            dm[jj] = st[jj] == DIRTY && s < n_pbe && in_scope;
            em[jj] = st[jj] == EMPTY && s < n_pbe;
          }
          const double dirty_cnt = static_cast<double>(warp_count(dm, tiles));
          const double empty_cnt = static_cast<double>(warp_count(em, tiles));
          double thr = scoped ? m.ten[T_THRESHOLD * T + tid] : sc[K_THRESHOLD];
          double pre = scoped ? m.ten[T_PRESET * T + tid] : sc[K_PRESET];
          const double cnt1 = cnt + 1.0;
          const double over1 = over + over_j;
          const bool tight = over1 > sc[K_LAT_TOL] * cnt1;
          thr = tight ? 1.0 : thr;
          pre = tight ? 0.0 : pre;
          const double k_thresh = dirty_cnt >= thr ? dirty_cnt - pre : 0.0;
          const double k_low = empty_cnt <= sc[K_EMPTY_SLACK]
                                   ? fmin(sc[K_LOW_WATER], dirty_cnt) : 0.0;
          g_wr = g_wr && !has_dirty && fmax(k_thresh, k_low) == 0.0;
        } else {
          // PB: the written entry drains at once
          const double pm_start2 = fmax(pmb_b, t_written + ow_sw1_pm);
#pragma unroll
          for (int jj = 0; jj < SPL; ++jj) {
            if (lane + 32 * jj == wslot) {
              sx.st(jj) = DRAIN;
              sx.dd(jj) = pm_start2 + nvm_write + ow_sw1_pm;
            }
          }
          if (lane == bank) pmb_r = pm_start2 + nvm_w_occ;
        }
        guard = t_j <= crash && g_wr;
      } else if (!is_rf) {
        // the guard has cleared: PB's drain still reserves its bank
        const double pm_start2 = fmax(pmb_b, t_written + ow_sw1_pm);
        if (lane == bank) pmb_r = pm_start2 + nvm_w_occ;
      }
      pbc = fmax(fmax(pbc, arr) + pbc_occ, 0.0);
      cnt = cnt + 1.0;
      over = over + over_j;
      clk = ack_p;
    }
  }
  if (EP && !(t_last < next_bound)) return R_EPOCH;
  if (!(others_min > t_last)) return R_INTERLEAVE;
  return guard ? MAC_COMMIT : R_GUARD;
}

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
  // ---- the fabric (FAB instantiations only) ----
  const double* fab_table;    // (Kc, N_FK + NL + T)
  double* recov_l;            // (N, NL) hop-1 survivors per leaf
  FabSmem flay;               // the fabric's carve-up: byte offsets
  int NL;                     // leaves: the grid's max(n_leaves, 1)
  // ---- epoch schedules (EP instantiations only) ----
  const double* ep_table;     // (Kc, E, N_EK + N_TEN * T + 2 * D1 + T)
  const double* ep_bounds;    // (Kc, E - 1)
  int E;                      // epochs: the grid's max(n_epochs)
  // ---- macro-steps (MAC instantiations only; ops then packs the run
  // plan into each op word, OPS_MLEN_SHIFT) ----
  long long* macro_ops;       // (N,) trace slots run as macro-steps
  long long* macro_aborts;    // (N, N_REASONS) aborted live windows
  MacSmem mlay;               // the replay's carve-up: byte offsets
};

}  // namespace

// SPL: PBE slots per lane (slot s = lane + 32 j, j < SPL), the fewest
// that hold max_pbe, so that a small PB keeps one slot a lane.  D: the
// grid's deep-hop rows (0: no switch chain; every `if constexpr (D > 0)`
// below is then compiled out).  FAB: the grid holds a multi-leaf fabric
// (instantiated with D >= 1 only: its spine is deep row 0); a tenant's
// hop-1 lookups, allocation, victim and drain-down see its leaf's slot
// window, its leaf's PBC clock serves it (m.pbc holds one a leaf), the
// spine's Dirty occupancy can defer a PB_RF drain-down, and recovery
// counts hop-1 survivors per leaf.  FAB = false compiles all of it out.
// EP: the grid holds a Schedule (E > 1); each op sees the rows of the
// epoch its issue time falls in.  EP = false compiles all of it out.
// MAC: macro-steps (engine/macro.py) are on: the kernel counts each live
// head's committed slots or abort reason and collapses dead runs.
// MAC = false compiles all of it out.
// At D >= 1 or with MAC, one block a multiprocessor (the launch bounds'
// second argument) frees ptxas to hold every register a lane needs: left
// to its own heuristic it stopped at 168 and spilled in the step loop.
// 0 leaves D = 0's bounds as they were without MAC (that machine code is
// unchanged).
template <int SPL, int D, bool FAB, bool EP, bool MAC>
__global__ void __launch_bounds__(32, (D > 0 || MAC) ? 1 : 0)
    cell_scan_kernel(Args a) {
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
  // the fabric: every leaf's PBC clock starts free, the tenants' leaves
  // in smem, and each lane's slots' leaves (fabric.slot_leaf: the bases
  // at or below the slot, minus one) and the n_leaves < 2 bypass in
  // registers
  FabSmem fs{};
  int sl[SPL];
  bool fab_bypass = true;
  double bp_high = INF;
  if constexpr (FAB) {
    const int NL = a.NL;
    const double* fr = a.fab_table + static_cast<size_t>(cf) * (N_FK + NL + T);
    fs.lof = reinterpret_cast<int*>(smem_raw + reinterpret_cast<size_t>(a.flay.lof));
    for (int i = lane; i < NL; i += 32) m.pbc[i] = 0.0;
    for (int t = lane; t < T; t += 32)
      fs.lof[t] = static_cast<int>(fr[N_FK + NL + t]);
    fab_bypass = fr[F_N_LEAVES] < 2.0;
    bp_high = fr[F_BP_HIGH];
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const double sd = static_cast<double>(lane + 32 * j);
      int below = 0;
      for (int k = 0; k < NL; ++k) below += sd >= fr[N_FK + k];
      sl[j] = clampi(below - 1, 0, NL - 1);
    }
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

  // epoch schedules: the epoch whose rows the copies hold, the window
  // [ep_lo, ep_hi) of issue times that select it (empty at first, so
  // the first step resolves it), and whether the epoch changed since the
  // chain's last forward (only then can a deep row sit over its drain
  // count: Chain::pending)
  int ep_cur = 0;
  double ep_lo = INF, ep_hi = -INF;
  bool ep_stale = false;

  // macro-steps: the window a committed head opened (its core and the
  // steps left in it, which are no heads), the counters (every lane's,
  // each by a fixed index: the slots run as macro-steps, the aborted
  // heads by reason), the replay's scratch in shared memory, and four
  // scalars of the config: the gate a buffered scheme fails before the
  // floor (fabric, else deep, from n_leaves and n_switches of the fabric
  // and chain tables, which every grid carries; MAC_COMMIT for none),
  // whether every latency of a replayed path is >= 0, so that no op
  // completes before it issues (macro.floor_holds), and the two latency
  // terms of a head's first bound that the read path does not hold
  int win_core = 0, win_left = 0;
  int mac_ops = 0, mac_ab[N_REASONS] = {};
  MacSmem ms{};
  int pb_gate = MAC_COMMIT;
  bool floor_ok = false;
  double mac_nvm_write = 0.0, mac_pbc_tag = 0.0;
  if constexpr (MAC) {
    ms = rebase_mac(a.mlay, smem_raw);
    mac_nvm_write = sc[K_NVM_WRITE];
    mac_pbc_tag = sc[K_PBC_PROC] + sc[K_TAG_NS];  // the replay's own sum
    floor_ok = sc[K_OW_CPU_PM] >= 0.0 && sc[K_NVM_READ] >= 0.0 &&
               sc[K_NVM_WRITE] >= 0.0 && sc[K_OW_CPU_SW1] >= 0.0 &&
               sc[K_PBC_PROC] >= 0.0 && sc[K_TAG_NS] >= 0.0 &&
               sc[K_DATA_NS] >= 0.0;
    constexpr int D1 = D > 0 ? D : 1;
    const double nsw = a.chain_table[static_cast<size_t>(cf) *
                                         (N_CH + N_DK * D1) + C_N_SWITCHES];
    const double nl = a.fab_table[static_cast<size_t>(cf) *
                                      (N_FK + a.NL + T) + F_N_LEAVES];
    // (a D = 0 grid holds neither: its buffered configs have one switch)
    if (D > 0 && scheme != 0)
      pb_gate = nl >= 2.0 ? R_FABRIC : (nsw >= 2.0 ? R_DEEP : MAC_COMMIT);
  }
  // a cell whose config gate settles every head and that never loses
  // power runs no head at all: no window commits and no op is dead, so
  // every slot is one step and one live head, and its reason follows
  // from the run plan alone (counted once the cell ends)
  const bool gate_only = MAC && pb_gate != MAC_COMMIT && crash >= INF * 0.5;

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
    double my_key = INF;  // MAC: lane c's own key (C <= 32)
    if (C <= 32) {  // core c on lane c (an idle lane keys INF)
      if (lane < C) best = key_of(lane);
      if constexpr (MAC) my_key = best;
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
    if constexpr (EP) {
      // the epoch at the issue time, #{b : b <= t_issue}; every time in
      // [ep_lo, ep_hi) counts the same bounds, so only an issue time
      // outside the window resolves again, and any change of epoch
      // copies that epoch's rows over the ones held (before the step's
      // first read of them, my_leaf below)
      if (!(ep_lo <= t_issue && t_issue < ep_hi)) {
        const int E = a.E;
        const double* eb = a.ep_bounds + static_cast<size_t>(cf) * (E - 1);
        int ep = 0;
        ep_lo = -INF;
        ep_hi = INF;
        for (int k = 0; k < E - 1; ++k) {
          const double b = eb[k];
          if (b <= t_issue) {
            ++ep;
            ep_lo = fmax(ep_lo, b);
          } else {
            ep_hi = fmin(ep_hi, b);
          }
        }
        if (ep != ep_cur) {
          constexpr int D1 = D > 0 ? D : 1;
          const int n_ep = N_EK + N_TEN * T + 2 * D1 + T;
          const double* row =
              a.ep_table + (static_cast<size_t>(cf) * E + ep) * n_ep;
          __syncwarp();  // every lane is done with the rows held
          if (lane == 0) {
            sc[K_THRESHOLD] = row[E_THRESHOLD];
            sc[K_PRESET] = row[E_PRESET];
            sc[K_LAT_TARGET] = row[E_LAT_TARGET];
          }
          for (int i = lane; i < N_TEN * T; i += 32) m.ten[i] = row[N_EK + i];
          if constexpr (D > 0) {
            // deep_thr then deep_pre: the chain row's DK_THR and DK_PRE runs
            for (int i = lane; i < 2 * D; i += 32)
              ch.c.csc[N_CH + DK_THR * D + i] = row[N_EK + N_TEN * T + i];
          }
          if constexpr (FAB) {
            for (int t = lane; t < T; t += 32)
              fs.lof[t] = static_cast<int>(row[N_EK + N_TEN * T + 2 * D1 + t]);
          }
          __syncwarp();
          ep_cur = ep;
          ep_stale = true;
        }
      }
    }
    if constexpr (MAC) {
      if (gate_only) {
        // (counted once the cell ends)
      } else if (win_left > 0) {
        // inside a committed window: its core's next op, no head
#ifdef CELL_SCAN_WINDOW_CHECK
        CELL_SCAN_WINDOW_CHECK(c == win_core);
#endif
        --win_left;
      } else {
        const int p = m.ptr[c], len = m.len[c];
        const int k_cap = clampi(len - p, 0, MAC_KMAX);
        const size_t w0 = static_cast<size_t>(c) * L + p;
        if (!(t_issue <= crash)) {
          // a dead run: every op of it a no-op that sets the clock to its
          // issue time; with all MAC_KMAX gaps >= 0 the next k_cap collapse
          // into this step (the host pads the trace axis by MAC_KMAX past
          // every stream; lane j holds entry p + j)
          const float w_gap = gaps[w0 + (lane < MAC_KMAX ? lane : 0)];
          const bool gaps_ok =
              __ballot_sync(FULL, lane >= MAC_KMAX || w_gap >= 0.0f) == FULL;
          if (k_cap >= 2 && gaps_ok) {
            double ck = m.clock[c];
            for (int j = 0; j < k_cap; ++j)
              ck = ck + static_cast<double>(__shfl_sync(FULL, w_gap, j));
            // core c's ring and current entry restart at the new cursor
            // (refills still in flight land first)
            wg::cp_async_wait<0>();
            __syncwarp();
            const int p2 = p + k_cap, last = max(len - 1, 0);
            if (lane < RING) {
              const int e = p2 + lane, slot = c * RING + e % RING;
              const size_t src = static_cast<size_t>(c) * L + min(e, last);
              m.rop[slot] = ops[src];
              m.raddr[slot] = addrs[src];
              m.rgap[slot] = gaps[src];
            }
            if (lane == 0) {
              const size_t src = static_cast<size_t>(c) * L + min(p2, last);
              m.ptr[c] = p2;
              m.clock[c] = ck;
              m.cop[c] = ops[src];
              m.caddr[c] = addrs[src];
              m.cgap[c] = gaps[src];
            }
            mac_ops += k_cap;
            steps += k_cap - 1;
            __syncwarp();
            PROF(SEC_MACRO);
            continue;
          }
        } else {
          // a live head: the window gate from the run plan in the op word,
          // the config's gate, then bounds of the window's second issue
          // time t_1 against the settling bound — under EP the next epoch
          // boundary, else whether another core's key (the merge's, core
          // k on lane k) is at or below it: one vote.  t_1 is the
          // replay's first step on the clocks alone: op 0's completion,
          // in its expressions, plus the first gap g1.  While no latency
          // is negative (floor_ok), with the plan's gaps >= 0
          // (traces.plan_runs: a run of two or more ops has none
          // negative), every later op of the window issues at or after
          // t_1, so the replay would stop there with this outcome.  The
          // bounds, each <= t_1 (an fmax taken by its second term and
          // the same adds in the same order: rounding is monotone): the
          // lesser of a read's and a persist's completion with a free
          // bank or PBC, from t_issue alone (so it waits on no load);
          // then op 0's own kind plus g1 (the ring's entry p + 1); then
          // t_1 itself, with op 0's bank or PBC clock loaded.
          const int word = m.cop[c];
          const int k_live = min(word >> OPS_MLEN_SHIFT, k_cap);
          // the core's tenant and its leaf, loaded only past the gates
          auto leaf_of = [&](int tid) { return FAB ? fs.lof[tid] : 0; };
          // the other cores' least key: from the merge's keys (C <= 32),
          // else each lane's cores again
          auto others_least = [&] {
            if (C <= 32) return warp_min_nonneg(lane == c ? INF : my_key);
            double o = INF;
            for (int k = lane; k < C; k += 32) {
              const double key = key_of(k);
              if (k != c && key < o) o = key;
            }
            for (int off = 16; off > 0; off >>= 1)
              o = fmin(o, __shfl_xor_sync(FULL, o, off));
            return o;
          };
          // the first gap, read from the ring only where a bound needs it
          auto gap1 = [&] {
            wg::cp_async_wait<RING - 2>();
            return static_cast<double>(m.rgap[c * RING + (p + 1) % RING]);
          };
          int why = MAC_COMMIT;
          double om = INF;
          if (k_live < 2) {
            why = R_WINDOW;
          } else if (pb_gate != MAC_COMMIT) {
            why = pb_gate;
          } else if (floor_ok && (EP || C > 1)) {
            // (a grid of one core has no other core to settle on)
            auto settle = [&](double t1) {
              if (EP) return t1 >= ep_hi ? R_EPOCH : MAC_COMMIT;
              if (C <= 32)
                return __any_sync(FULL, lane != c && my_key <= t1)
                           ? R_INTERLEAVE : MAC_COMMIT;
              if (!(om < INF)) om = others_least();
              return om <= t1 ? R_INTERLEAVE : MAC_COMMIT;
            };
            // op 0's arrival (at PM; a buffered persist at the PBC) and
            // its completion from its start
            const double arr_rd = t_issue + rd.ow_cpu_pm;
            const double arr_wr =
                t_issue + (scheme != 0 ? rd.ow_cpu_sw1 : rd.ow_cpu_pm);
            auto read_done = [&](double start) {
              return start + rd.nvm_read + rd.ow_cpu_pm;
            };
            auto write_done = [&](double start) {
              return scheme != 0
                         ? start + mac_pbc_tag + rd.data_ns + rd.ow_cpu_sw1
                         : start + mac_nvm_write + rd.ow_cpu_pm;
            };
            why = settle(fmin(read_done(arr_rd), write_done(arr_wr)));
            if (why == MAC_COMMIT) {
              const bool wr = op_code<true>(word) == OP_PERSIST;
              const double arr = wr ? arr_wr : arr_rd;
              auto done = [&](double start) {
                return wr ? write_done(start) : read_done(start);
              };
              const double g1 = gap1();
              why = settle(done(arr) + g1);
              if (why == MAC_COMMIT) {
                const double busy = wr && scheme != 0
                                        ? m.pbc[leaf_of(m.tids[c])]
                                        : m.pm_busy[bank_of(m.caddr[c])];
                why = settle(done(fmax(busy, arr)) + g1);
              }
            }
          }
          if (why == MAC_COMMIT) {
            // not settled: the other cores' least key, then the floor and
            // the replay
            if (!(om < INF)) om = others_least();
            const int tid = m.tids[c];
            why = macro_verdict<SPL, EP, D == 0>(
                m, ms, stats + static_cast<size_t>(tid) * N_STATS, lane, c,
                tid, scheme, k_live, t_issue, floor_ok,
                ops + w0, addrs + w0, gaps + w0, om, EP ? ep_hi : INF,
                m.pbc[leaf_of(tid)], crash, n_pbe, T, B, tiles, bank_of);
            if (why == MAC_COMMIT) {
              win_core = c;
              win_left = k_live - 1;
              mac_ops += k_live;
            }
          }
#pragma unroll
          for (int r = 0; r < N_REASONS; ++r) mac_ab[r] += why == r;
        }
      }
      PROF(SEC_MACRO);
    }
    // ops issuing after the power loss never happen (machine is off)
    const bool live = t_issue <= crash;
    const int op = live ? op_code<MAC>(m.cop[c]) : OP_COMPUTE;
    const double t = live ? t_issue : m.clock[c];
    const int addr = m.caddr[c];
    const int tid = m.tids[c];
    const int n_live_t = m.lpt[tid];
    // the fabric: the issuing tenant's leaf, whose PBC clock serves the
    // op (0 without a fabric), and its slot window (fabric.leaf_mask)
    int my_leaf = 0;
    bool lm[SPL];
    if constexpr (FAB) {
      my_leaf = fs.lof[tid];
#pragma unroll
      for (int j = 0; j < SPL; ++j) lm[j] = fab_bypass || sl[j] == my_leaf;
    }
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
        const double pbc_prev = m.pbc[my_leaf];
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
          bool tm = s < n_pbe && tg == addr;
          if constexpr (FAB) tm = tm && lm[j];
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
        // (the deep rows' tags are loaded only here, once hop 1 has no
        // live entry: loaded beside hop 1's own loads on every read, as
        // before, they lengthened the read path, PERF.md §6)
        int deep_row = -1, deep_slot = 0;
        double resp_deep = 0.0;
        if constexpr (D > 0) {
          if (is_chain && !has) {
            PROF(SEC_READ);
            deep_row = ch.pick(ch.probe(addr), t, rd.ow_cpu_sw1,
                               rd.fwd_margin, sc[K_PBC_READ], deep_slot,
                               resp_deep, lookups);
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
          m.pbc[my_leaf] = pbc_new;
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
        const double pbc_prev = m.pbc[my_leaf];
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
          if constexpr (FAB) hit_d[j] = hit_d[j] && lm[j];
        }
        // policy.coalesce_lookup: the first Dirty match
        const int i_dirty = tat_first(hit_d, tiles);
        ++lookups;
        const bool has_dirty = i_dirty >= 0;
        const int idx = has_dirty ? i_dirty : 0;
        const bool is_coalesce = is_rf && has_dirty;
        PROF(SEC_LOOKUP);
        // tenant_occupancy: live entries per owning tenant, a ballot per
        // tile and tenant (over the whole hop-1 PB, a fabric's too)
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
          bool act = s < n_pbe;
          if constexpr (FAB) act = act && lm[j];
          if (act && st1[j] == DIRTY) {
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
            bool act = s < n_pbe;
            if constexpr (FAB) act = act && lm[j];
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
              // one packet, held by every lane, its ack in vack
              PROF(SEC_SELECT);
              const Pkt vp{pbc_start, 0, victim_idx, vic_tag, vic_ver, 0,
                           m.owner[victim_idx]};
              vack = m.dd[victim_idx];
              PROF(SEC_C_BATCH);
              pmw_v = ch.forward(scheme, 1, 1, vp, nullptr, true, vack,
                                 lookups);
              if constexpr (EP) ep_stale = false;
              vic_wait = vack;
            } else if constexpr (EP) {
              // no victim packet: the leg's empty forward drains a row
              // that a lowered threshold left over its drain count
              if (ep_stale && ch.pending(scheme))
                pmw_v = ch.forward(scheme, 1, 0, Pkt{}, nullptr, true, vack,
                                   lookups);
              ep_stale = false;
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
            bool act = s < n_pbe;
            if constexpr (FAB) act = act && lm[j];
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
          double k = fmax(k_thresh, k_low);
          if constexpr (FAB) {
            // spine backpressure (fabric.spine_live, params.spine_defer):
            // the spine's Dirty entries inside its capacity, after this
            // op's victim leg landed; at or above bp_high the drain-down
            // defers
            bool sp[SPL];
#pragma unroll
            for (int j = 0; j < SPL; ++j) {
              const int s = lane + 32 * j;
              sp[j] = s < ch.pbe[0] && ch.c.dstate[ch.idx(0, s < P ? s : 0)] == DIRTY;
            }
            const double sp_live = static_cast<double>(warp_count(sp, tiles));
            k = sp_live >= bp_high ? 0.0 : k;
          }
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
            unsigned pol_bits[SPL];
            int n_pol = 0;
#pragma unroll
            for (int j = 0; j < SPL; ++j) {
              pol[j] = commit && lane + 32 * j < P && st4[j] == DRAIN &&
                       st3[j] == DIRTY;
              pol_bits[j] = j < tiles ? __ballot_sync(FULL, pol[j]) : 0u;
              n_pol += __popc(pol_bits[j]);
            }
            // one drain (most persists) is lone: every lane takes it from
            // its owner by shuffle; more go to list 0 in LRU rank order
            Pkt pk{t_written, 0, 0, 0, 0, 0, 0};
            if (n_pol == 1) {
              int l = 0, p_tag = 0, p_ver = 0, p_own = 0;
#pragma unroll
              for (int j = 0; j < SPL; ++j) {
                if (pol_bits[j]) {  // the one slot: 32 j + l
                  l = __ffs(pol_bits[j]) - 1;
                  pk.oslot = 32 * j + l;
                }
                if (pol[j]) {
                  p_tag = tag3[j];
                  p_ver = ver3[j];
                  p_own = own3[j];
                }
              }
              pk.addr = __shfl_sync(FULL, p_tag, l);
              pk.ver = __shfl_sync(FULL, p_ver, l);
              pk.owner = static_cast<signed char>(__shfl_sync(FULL, p_own, l));
            } else if (n_pol > 1) {
              int pol_rank[SPL];
#pragma unroll
              for (int j = 0; j < SPL; ++j) pol_rank[j] = 0;
#pragma unroll
              for (int jq = 0; jq < SPL; ++jq) {
                for (unsigned bits = pol_bits[jq]; bits; bits &= bits - 1) {
                  const int l = __ffs(bits) - 1, q = 32 * jq + l;
                  const double kq = __shfl_sync(FULL, lru3[jq], l);
#pragma unroll
                  for (int j = 0; j < SPL; ++j) {
                    const int s = lane + 32 * j;
                    pol_rank[j] += (kq < lru3[j]) || (kq == lru3[j] && q < s);
                  }
                }
              }
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
            }
            PROF(SEC_C_BATCH);
            double none = 0.0;
            if (n_pol > 0) {
              pmw_c = ch.forward(scheme, P, n_pol, pk, m.dd, false, none,
                                 lookups);
              if constexpr (EP) ep_stale = false;
            } else if constexpr (EP) {  // as on the victim leg
              if (ep_stale && ch.pending(scheme))
                pmw_c = ch.forward(scheme, P, 0, pk, m.dd, false, none,
                                   lookups);
              ep_stale = false;
            }
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
          m.pbc[my_leaf] = pbc_free;
          m.clock[c] = ack;
        }
        PROF(SEC_STATS);
      }
    } else if (op == OP_BARRIER) {  // centralized barrier per tenant
      const bool last = (m.bcount[tid] + 1) >= n_live_t;
      if constexpr (D > 0) {
        // in one pass: a lane reads and writes only its own cores (k =
        // lane + 32 i), so no array carries the new clocks over a
        // __syncwarp (the D = 0 body keeps them in one, on the stack)
        for (int k = lane; k < C; k += 32) {
          const bool mine = m.tids[k] == tid;
          const double released =
              (k == c) ? t : ((m.blocked[k] && mine) ? t : m.clock[k]);
          m.clock[k] = last ? released : (k == c ? INF * 0.9 : m.clock[k]);
          if (last && mine) m.blocked[k] = 0;
        }
        __syncwarp();  // every lane has read bcount
      } else {
        double ck[(1024 + 31) / 32];
        for (int k = lane, j = 0; k < C; k += 32, ++j) {
          const double released =
              (k == c) ? t
                       : ((m.blocked[k] && m.tids[k] == tid) ? t : m.clock[k]);
          ck[j] = last ? released : (k == c ? INF * 0.9 : m.clock[k]);
        }
        __syncwarp();
        for (int k = lane, j = 0; k < C; k += 32, ++j) {
          m.clock[k] = ck[j];
          if (last && m.tids[k] == tid) m.blocked[k] = 0;
        }
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

  if (MAC && gate_only) {
    // every slot a live head: a window's if its plan or its stream's end
    // leaves it under two ops, else the gate's
    int n_window = 0, n_slots = 0;
    for (int k = 0; k < C; ++k) {
      const int len = lens[k];
      n_slots += len;
#pragma unroll 4
      for (int i = lane; i < len; i += 32) {
        const int word = ops[static_cast<size_t>(k) * L + i];
        n_window += min(word >> OPS_MLEN_SHIFT, clampi(len - i, 0, MAC_KMAX)) < 2;
      }
    }
    n_window = warp_sum(n_window);
    mac_ab[R_WINDOW] = n_window;
    mac_ab[R_FABRIC] = pb_gate == R_FABRIC ? n_slots - n_window : 0;
    mac_ab[R_DEEP] = pb_gate == R_DEEP ? n_slots - n_window : 0;
  }

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
      if constexpr (MAC) {
        a.macro_ops[cell] = mac_ops;
#pragma unroll
        for (int r = 0; r < N_REASONS; ++r)
          a.macro_aborts[static_cast<size_t>(cell) * N_REASONS + r] = mac_ab[r];
      }
    }
  } else {
    double n_rec = 0.0, cost = 0.0;
    double* rec_t = a.recov_t + static_cast<size_t>(cell) * T;
    double* rec_h = a.recov_h + static_cast<size_t>(cell) * (D + 1);
    if (scheme == 0) {
      for (int tt = lane; tt < T; tt += 32) rec_t[tt] = 0.0;
      for (int h = lane; h <= D; h += 32) rec_h[h] = 0.0;
      if constexpr (FAB) {
        for (int l = lane; l < a.NL; l += 32)
          a.recov_l[static_cast<size_t>(cell) * a.NL + l] = 0.0;
      }
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
      if constexpr (FAB) {
        // hop 1's survivors per leaf switch (by slot_leaf)
        double* rec_l = a.recov_l + static_cast<size_t>(cell) * a.NL;
        for (int l = 0; l < a.NL; ++l) {
          bool mine[SPL];
#pragma unroll
          for (int j = 0; j < SPL; ++j) mine[j] = surv[0][j] && sl[j] == l;
          const int cnt = warp_count(mine, tiles);
          if (lane == 0) rec_l[l] = static_cast<double>(cnt);
        }
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
      if constexpr (MAC) {
        a.macro_ops[cell] = mac_ops;
#pragma unroll
        for (int r = 0; r < N_REASONS; ++r)
          a.macro_aborts[static_cast<size_t>(cell) * N_REASONS + r] = mac_ab[r];
      }
    }
  }
}

// ---- host entry point -------------------------------------------------
// n_deep (the grid's deep-hop rows, the D of the instantiation) is
// bounded by MAX_DEEP: chains of up to MAX_DEEP + 1 switches.  n_leaves
// (the grid's most fabric leaves) above 1 selects the FAB instantiation,
// which needs the spine's deep row.  n_epochs (the grid's most schedule
// epochs, at most MAX_EPOCHS) above 1 selects the EP instantiation, and
// macro the MAC one.
constexpr int MAX_DEEP = 3;

template <int SPL, int D, bool FAB, bool EP, bool MAC>
static int run_one(Args& a, int n_cells, size_t smem, cudaStream_t stream) {
  const auto kernel = cell_scan_kernel<SPL, D, FAB, EP, MAC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<n_cells, 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int SPL, int D, bool FAB, bool MAC>
static int run_ep(Args& a, int n_cells, bool ep, size_t smem,
                  cudaStream_t stream) {
  return ep ? run_one<SPL, D, FAB, true, MAC>(a, n_cells, smem, stream)
            : run_one<SPL, D, FAB, false, MAC>(a, n_cells, smem, stream);
}

template <int SPL, int D, bool MAC>
static int run_d(Args& a, int n_cells, bool fab, bool ep, size_t smem,
                 cudaStream_t stream) {
  return fab ? run_ep<SPL, D, true, MAC>(a, n_cells, ep, smem, stream)
             : run_ep<SPL, D, false, MAC>(a, n_cells, ep, smem, stream);
}

// The split build (kernels/_build.py, UNITS): unit (SPL, D, MAC) is this
// file compiled with CELL_SCAN_UNIT_SPL, CELL_SCAN_UNIT_D and
// CELL_SCAN_UNIT_MAC defined — the kernels of that triple, behind
// cell_scan_run_<SPL>_<D>_<MAC> (and, in the profile build,
// cell_scan_set_profile_<SPL>_<D>_<MAC>) — and the entry unit, compiled
// with CELL_SCAN_UNIT_ENTRY, holds cell_scan_launch and dispatches to
// them.  Without these macros the file builds every kernel and the entry
// point in one unit.  The units' list:
#define CELL_SCAN_UNITS(X)                                                \
  X(1, 0, 0) X(1, 1, 0) X(1, 2, 0) X(1, 3, 0) X(2, 0, 0) X(2, 1, 0)       \
  X(2, 2, 0) X(2, 3, 0) X(4, 0, 0) X(4, 1, 0) X(4, 2, 0) X(4, 3, 0)       \
  X(1, 0, 1) X(1, 1, 1) X(1, 2, 1) X(1, 3, 1) X(2, 0, 1) X(2, 1, 1)       \
  X(2, 2, 1) X(2, 3, 1) X(4, 0, 1) X(4, 1, 1) X(4, 2, 1) X(4, 3, 1)
#define CS_PASTE(pre, s, d, c) pre##s##_##d##_##c
#define CS_UNIT_NAME(pre, s, d, c) CS_PASTE(pre, s, d, c)

// The kernels of (SPL, D, MAC): FAB and EP both ways (D = 0: no fabric).
template <int SPL, int D, bool MAC>
static int run_sd(Args& a, int n_cells, bool fab, bool ep, size_t smem,
                  cudaStream_t stream) {
  if constexpr (D == 0)
    return run_ep<SPL, 0, false, MAC>(a, n_cells, ep, smem, stream);
  else
    return run_d<SPL, D, MAC>(a, n_cells, fab, ep, smem, stream);
}

#if defined(CELL_SCAN_UNIT_SPL)
extern "C" int CS_UNIT_NAME(cell_scan_run_, CELL_SCAN_UNIT_SPL,
                            CELL_SCAN_UNIT_D, CELL_SCAN_UNIT_MAC)(
    const void* args, int n_cells, int fab, int ep, size_t smem,
    cudaStream_t stream) {
  Args a;
  memcpy(&a, args, sizeof a);
  return run_sd<CELL_SCAN_UNIT_SPL, CELL_SCAN_UNIT_D,
                static_cast<bool>(CELL_SCAN_UNIT_MAC)>(a, n_cells, fab, ep,
                                                       smem, stream);
}
#ifdef CELL_SCAN_PROFILE
extern "C" int CS_UNIT_NAME(cell_scan_set_profile_, CELL_SCAN_UNIT_SPL,
                            CELL_SCAN_UNIT_D, CELL_SCAN_UNIT_MAC)(
    long long* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, &buf, sizeof(buf)));
}
#endif
#else
#ifdef CELL_SCAN_UNIT_ENTRY
#define CS_DECLARE(s, d, c)                                               \
  extern "C" int CS_UNIT_NAME(cell_scan_run_, s, d, c)(                   \
      const void*, int, int, int, size_t, cudaStream_t);                  \
  extern "C" int CS_UNIT_NAME(cell_scan_set_profile_, s, d, c)(long long*);
CELL_SCAN_UNITS(CS_DECLARE)
#undef CS_DECLARE
#endif

template <int SPL, bool MAC>
static int run_spl(Args& a, int n_cells, int n_deep, bool fab, bool ep,
                   size_t smem, cudaStream_t stream) {
#ifdef CELL_SCAN_UNIT_ENTRY
#define CS_RUN(s, d, c)                                                   \
  if (SPL == s && n_deep == d && MAC == static_cast<bool>(c))             \
    return CS_UNIT_NAME(cell_scan_run_, s, d, c)(&a, n_cells, fab, ep,    \
                                                 smem, stream);
  CELL_SCAN_UNITS(CS_RUN)
#undef CS_RUN
  return static_cast<int>(cudaErrorInvalidValue);
#else
  switch (n_deep) {
    case 0: return run_sd<SPL, 0, MAC>(a, n_cells, fab, ep, smem, stream);
    case 1: return run_sd<SPL, 1, MAC>(a, n_cells, fab, ep, smem, stream);
    case 2: return run_sd<SPL, 2, MAC>(a, n_cells, fab, ep, smem, stream);
    case 3: return run_sd<SPL, 3, MAC>(a, n_cells, fab, ep, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
}

template <bool MAC>
static int run_mac(Args& a, int n_cells, int n_deep, bool fab, bool ep,
                   size_t smem, cudaStream_t stream) {
  const int P = a.P;
  if (P <= 32) return run_spl<1, MAC>(a, n_cells, n_deep, fab, ep, smem, stream);
  if (P <= 64) return run_spl<2, MAC>(a, n_cells, n_deep, fab, ep, smem, stream);
  return run_spl<MAX_SPL, MAC>(a, n_cells, n_deep, fab, ep, smem, stream);
}

extern "C" int cell_scan_launch(
    const int* ops, const int* addrs, const float* gaps, const int* lengths,
    const int* cell_trace, const int* cell_cfg, const int* schemes,
    const double* sc_table, const double* ten_table,
    const double* lat_edges, double* runtime, double* stats,
    double* hop_stats, int* durable_ver, double* n_recov,
    double* recov_ns, double* recov_t, long long* steps, long long* lookups,
    int* aver, const double* chain_table, double* recov_h,
    const double* fab_table, double* recov_l, const double* ep_table,
    const double* ep_bounds, long long* macro_ops,
    long long* macro_aborts, int n_cells, int C, int L, int P, int B, int A,
    int T, int n_track, int n_deep, int n_leaves, int n_epochs, int macro,
    cudaStream_t stream) {
  const bool fab = n_leaves > 1;
  const bool ep = n_epochs > 1;
  const int NL = fab ? n_leaves : 1;
  Args a{ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
         sc_table, ten_table, lat_edges, runtime, stats, hop_stats,
         durable_ver, n_recov, recov_ns, recov_t, steps, lookups, aver,
         C, L, P, B, A, T, n_track, {}, chain_table, recov_h, {},
         fab_table, recov_l, {}, NL, ep_table, ep_bounds, n_epochs,
         macro_ops, macro_aborts, {}};
  if (n_deep < 0 || n_deep > MAX_DEEP || n_leaves < 1 ||
      n_leaves > MAX_LEAVES || (fab && n_deep < 1) || n_epochs < 1 ||
      n_epochs > MAX_EPOCHS)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = carve(a.lay, nullptr, C, P, B, T, NL);
  if (n_deep > 0) smem = carve_chain(a.clay, nullptr, smem, P, B, n_deep);
  if (fab) smem = carve_fab(a.flay, nullptr, smem, T);
  if (macro) smem = carve_mac(a.mlay, nullptr, smem, P);
  return macro ? run_mac<true>(a, n_cells, n_deep, fab, ep, smem, stream)
               : run_mac<false>(a, n_cells, n_deep, fab, ep, smem, stream);
}

#ifdef CELL_SCAN_PROFILE
// The profile's output: (n_cells, N_PROF) int64 on the device.
extern "C" int cell_scan_set_profile(long long* buf) {
#ifdef CELL_SCAN_UNIT_ENTRY
  int rc = 0;
#define CS_SET(s, d, c) \
  if (rc == 0) rc = CS_UNIT_NAME(cell_scan_set_profile_, s, d, c)(buf);
  CELL_SCAN_UNITS(CS_SET)
#undef CS_SET
  return rc;
#else
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, &buf, sizeof(buf)));
#endif
}
#endif
#endif  // CELL_SCAN_UNIT_SPL
