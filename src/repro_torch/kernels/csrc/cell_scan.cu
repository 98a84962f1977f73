// cell_scan: the timed PCS engine's issue-time merge loop on Hopper.
//
// Replaces repro/core/engine/step.py::scan_cell, the reference's
// lax.scan under jit(vmap(vmap)) (repro/core/engine/grid.py) — the TPU
// hot path of the simulator.  Its plain version is the eager torch
// repro_torch/core/engine/step.py::scan_cell; every expression below
// keeps that code's form and order (f64 adds, maxes and products, built
// with -fmad=false), so the two agree bit for bit.
//
// Scope: depth 1 (one switch), no fabric, one schedule epoch — the
// depth-1 handler and policy bodies with tenants, PBPolicy quotas and
// weighted victims, the SLO drain tightening, the crash gate and
// durability tracking.
//
// Design: one block of one warp per (trace, config) cell; every cell of
// a grid in one launch, with the scheme read per cell.  The machine
// state (clocks, cursors, PB tables, bank/PBC next-free times, barrier
// counts, stats) lives in shared memory; aver/pm_ver (durability
// tracking, A addresses) live in global memory.  Lanes own PBE slots
// (slot s = lane + 32 j, up to 128 slots) and keep the per-step derived
// slot columns in registers; every argmin is a warp reduction that
// breaks ties to the lowest index, as jnp.argmin does.  All lanes run
// the scalar part of a step redundantly (same inputs, same values);
// lane 0 alone writes scalar state.  Each step reads what it needs,
// __syncwarp(), then writes — lanes of a warp are not in lock step.
//
// What bounds it: each cell is a chain of dependent steps (379 029 for
// the paper's cholesky at persist_budget=100_000), one step a few
// dependent shared-memory round trips plus warp shuffles, so the kernel
// is latency bound; the paper grid's 21 cells keep at most 21 of the
// H100's 132 SMs busy.
#include <cuda_runtime.h>

#include "tat_match.cuh"

namespace {

constexpr double INF = 1e30;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SPL = 4;  // slots per lane: max_pbe <= 128

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
constexpr int H_FWD_SUM = 0, H_FWD_CNT = 1, H_COALESCES = 2,
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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// (key, idx) argmin over the warp, ties to the lowest index; every lane
// gets the result.
__device__ __forceinline__ void warp_argmin(double& key, int& idx) {
  for (int off = 16; off > 0; off >>= 1) {
    const double k2 = __shfl_xor_sync(FULL, key, off);
    const int i2 = __shfl_xor_sync(FULL, idx, off);
    if (k2 < key || (k2 == key && i2 < idx)) {
      key = k2;
      idx = i2;
    }
  }
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
};

// Shared-memory carve-up of one cell's carry and scratch.
struct Smem {
  double *clock, *lru, *dd, *pm_busy, *stats, *hop, *pbc, *sc, *ten, *occ,
      *key, *busy, *edges;
  int *ptr, *tag, *ver, *tids, *lpt, *rank, *bank;
  short* bcount;
  signed char *state, *owner, *blocked, *todrain;
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
  m.key = cv.take<double>(P);
  m.busy = cv.take<double>(P);
  m.edges = cv.take<double>(N_LAT_BINS - 1);
  m.ptr = cv.take<int>(C);
  m.tag = cv.take<int>(P);
  m.ver = cv.take<int>(P);
  m.tids = cv.take<int>(C);
  m.lpt = cv.take<int>(T);
  m.rank = cv.take<int>(P);
  m.bank = cv.take<int>(P);
  m.bcount = cv.take<short>(T);
  m.state = cv.take<signed char>(P);
  m.owner = cv.take<signed char>(P);
  m.blocked = cv.take<signed char>(C);
  m.todrain = cv.take<signed char>(P);
  return cv.off;
}

}  // namespace

__global__ void __launch_bounds__(32) cell_scan_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem m;
  carve(m, smem_raw, a.C, a.P, a.B, a.T);
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
  const double crash = sc[K_CRASH_AT];

  long long steps = 0, lookups = 0;
  for (;;) {
    // ---- issue-time merge: the core whose next op issues first ---------
    double best = INF;
    int bc = lane;
    bool any_active = false;
    for (int c = lane; c < C; c += 32) {
      const int p = m.ptr[c], len = lens[c];
      const bool act = p < len;
      any_active |= act;
      const int ix = min(p, max(len - 1, 0));
      const double key =
          (act && !m.blocked[c])
              ? m.clock[c] + static_cast<double>(gaps[static_cast<size_t>(c) * L + ix])
              : INF;
      if (key < best) {
        best = key;
        bc = c;
      }
    }
    warp_argmin(best, bc);
    any_active = __any_sync(FULL, any_active);
    // once no core can be selected every later step is a no-op
    if (!(any_active && best < INF * 0.5)) break;
    ++steps;
    const int c = bc;
    const int i = min(m.ptr[c], max(lens[c] - 1, 0));
    const size_t ci = static_cast<size_t>(c) * L + i;
    const double t_issue = best;
    // ops issuing after the power loss never happen (machine is off)
    const bool live = t_issue <= crash;
    const int op = live ? ops[ci] : OP_COMPUTE;
    const double t = live ? t_issue : m.clock[c];
    const int addr = addrs[ci];
    const int tid = m.tids[c];
    const int n_live_t = m.lpt[tid];
    double* st_row = stats + static_cast<size_t>(tid) * N_STATS;

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
      const double ow = sc[K_OW_CPU_PM];
      const int bank = floor_mod(addr, B);
      const double pm_start_dir = fmax(m.pm_busy[bank], t + ow);
      const double resp_dir = pm_start_dir + sc[K_NVM_READ] + ow;
      if (scheme == 0) {
        // NoPB: the volatile switch forwards every read to PM.
        __syncwarp();
        if (lane == 0) {
          st_row[S_READ_SUM] += resp_dir - t;
          st_row[S_READ_CNT] += 1.0;
          m.clock[c] = resp_dir;
          m.pm_busy[bank] = pm_start_dir + sc[K_NVM_R_OCC];
        }
      } else {
        // PB/PB_RF: read forwarding through the PI buffer.  state0 is
        // the lazily freed state at t (policy.lazy_free).
        auto st0 = [&](int s) {
          const int v = m.state[s];
          return (v == DRAIN && m.dd[s] <= t) ? EMPTY : v;
        };
        // policy.pb_lookup: the first Dirty match, else the first live
        // match, else slot 0 — two tat_match compositions
        int idx = tat_match(addr, m.tag, [&](int s) { return st0(s) == DIRTY; },
                            n_pbe);
        ++lookups;
        bool has = idx >= 0;
        if (!has) {
          idx = tat_match(addr, m.tag, [&](int s) { return st0(s) != EMPTY; },
                          n_pbe);
          ++lookups;
          has = idx >= 0;
          idx = has ? idx : 0;
        }
        const double arr = t + sc[K_OW_CPU_SW1];
        const double pbc_prev = m.pbc[0];
        const double pbc_start =
            fmax(pbc_prev, arr) + (sc[K_PBC_READ] + sc[K_TAG_NS]);
        const int st_i = st0(idx);
        const double dd_i = m.dd[idx];
        const bool served =
            (st_i == DIRTY) ||
            ((st_i == DRAIN) && (dd_i > pbc_start + sc[K_FWD_MARGIN]));
        const double resp_pb = pbc_start + sc[K_DATA_NS] + sc[K_OW_CPU_SW1];
        const double pm_start_fwd =
            fmax(m.pm_busy[bank],
                 pbc_start + sc[K_SWITCH_PIPE] + sc[K_OW_SW1_PM]);
        const double resp_fwd = pm_start_fwd + sc[K_NVM_READ] + ow;
        const bool hit = has && served;
        const double resp = has ? (served ? resp_pb : resp_fwd) : resp_dir;
        const double pmb = has ? (served ? m.pm_busy[bank]
                                         : pm_start_fwd + sc[K_NVM_R_OCC])
                               : pm_start_dir + sc[K_NVM_R_OCC];
        const double pbc_new =
            has ? fmax(pbc_prev, arr) + sc[K_PBC_READ_OCC] : pbc_prev;
        signed char s0[SPL];
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j;
          s0[j] = s < P ? static_cast<signed char>(st0(s)) : EMPTY;
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j;
          if (s < P) m.state[s] = s0[j];
        }
        if (lane == 0) {
          if (hit) m.lru[idx] = t;
          m.hop[H_READ_HITS] += hit ? 1.0 : 0.0;
          st_row[S_READ_SUM] += resp - t;
          st_row[S_READ_CNT] += 1.0;
          st_row[S_READ_HITS] += hit ? 1.0 : 0.0;
          st_row[S_PI_DETOURS] += has ? 1.0 : 0.0;
          m.clock[c] = resp;
          m.pm_busy[bank] = pmb;
          m.pbc[0] = pbc_new;
        }
      }
    } else if (op == OP_PERSIST) {
      const int bank = floor_mod(addr, B);
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
        auto st1f = [&](int s) {
          const int v = m.state[s];
          return (v == DRAIN && m.dd[s] <= pbc_start) ? EMPTY : v;
        };
        // policy.coalesce_lookup: the first Dirty match
        const int i_dirty = tat_match(
            addr, m.tag, [&](int s) { return st1f(s) == DIRTY; }, n_pbe);
        ++lookups;
        const bool has_dirty = i_dirty >= 0;
        const int idx = has_dirty ? i_dirty : 0;
        const bool is_coalesce = is_rf && has_dirty;

        signed char st1[SPL];
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int s = lane + 32 * j;
          st1[j] = s < P ? static_cast<signed char>(st1f(s)) : EMPTY;
        }
        // tenant_occupancy: live entries per owning tenant
        for (int tt = 0; tt < T; ++tt) {
          int cnt = 0;
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const int s = lane + 32 * j;
            cnt += (s < n_pbe) && st1[j] != EMPTY &&
                   clampi(m.owner[s], 0, T - 1) == tt;
          }
          cnt = warp_sum(cnt);
          if (lane == 0) m.occ[tt] = static_cast<double>(cnt);
        }
        __syncwarp();
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
        warp_argmin(ke, ie);
        warp_argmin(kv, iv);
        warp_argmin(kd, id);
        const int empty_idx = ie, victim_idx = iv, earliest_idx = id;

        // victim drain (only used when no Empty entry exists)
        const int vic_tag = m.tag[victim_idx];
        const int victim_bank = floor_mod(vic_tag, B);
        const double victim_pm_start =
            fmax(m.pm_busy[victim_bank], pbc_start + sc[K_OW_SW1_PM]);
        const double victim_dd =
            victim_pm_start + sc[K_NVM_WRITE] + sc[K_OW_SW1_PM];
        const bool needs_victim = !is_coalesce && !any_empty && any_dirty;
        const bool vic_ok = needs_victim && victim_dd <= crash &&
                            vic_tag >= 0 && vic_tag < n_track;
        const int vic_ver = m.ver[victim_idx];
        const bool vic_emit = needs_victim && pbc_start <= crash;
        const int slot =
            any_empty ? empty_idx : (any_dirty ? victim_idx : earliest_idx);
        const double ta =
            any_empty ? pbc_start
                      : (any_dirty ? victim_dd
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
          int dcnt = 0, ecnt = 0;
          bool dmask[SPL];
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const int s = lane + 32 * j;
            const bool act = s < n_pbe;
            const bool in_scope = scoped ? own3[j] == tid : true;
            dmask[j] = st3[j] == DIRTY && act && in_scope;
            dcnt += dmask[j];
            ecnt += st3[j] == EMPTY && act;
          }
          dcnt = warp_sum(dcnt);
          ecnt = warp_sum(ecnt);
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
          // stable-sort rank of the LRU key: #{j: key_j < key_i or
          // (key_j == key_i and j < i)}
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const int s = lane + 32 * j;
            if (s < P) {
              m.key[s] = dmask[j] ? lru3[j] : INF;
              m.bank[s] = floor_mod(tag3[j], B);
            }
          }
          __syncwarp();
          int rank[SPL];
          bool todo[SPL];
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const int s = lane + 32 * j;
            int r = 0;
            if (s < P) {
              const double ks = m.key[s];
              for (int q = 0; q < P; ++q) {
                const double kq = m.key[q];
                r += (kq < ks) || (kq == ks && q < s);
              }
              m.rank[s] = r;
            }
            rank[j] = r;
            todo[j] = s < P && static_cast<double>(r) < k && dmask[j];
            if (s < P) m.todrain[s] = todo[j];
          }
          __syncwarp();
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const int s = lane + 32 * j;
            st4[j] = st3[j];
            dd4[j] = dd2[j];
            if (s < P) {
              const int bs = m.bank[s];
              int rank_b = 0;
              for (int q = 0; q < P; ++q)
                rank_b += m.bank[q] == bs && m.rank[q] < rank[j] &&
                          m.todrain[q];
              const double start =
                  fmax(pmb1(bs), t_written + sc[K_OW_SW1_PM]) +
                  static_cast<double>(rank_b) * sc[K_NVM_W_OCC];
              const double dd_j = start + sc[K_NVM_WRITE] + sc[K_OW_SW1_PM];
              if (todo[j]) {
                st4[j] = DRAIN;
                dd4[j] = dd_j;
              }
              m.busy[s] = todo[j] ? start + sc[K_NVM_W_OCC] : 0.0;
            }
          }
          __syncwarp();
          if (lane < B) {
            double mx = 0.0;
            for (int q = 0; q < P; ++q)
              if (m.bank[q] == lane && m.todrain[q]) mx = fmax(mx, m.busy[q]);
            pmb2_mine = fmax(pmb1(lane), mx);
          }
          policy_writes = k;
        }
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
              if (drain_ok) atomicMax(&pm_ver[clampi(tag3[j], 0, A - 1)], ver3[j]);
              m.state[s] = st4[j];
              m.tag[s] = tag3[j];
              m.lru[s] = lru3[j];
              m.dd[s] = dd4[j];
              m.ver[s] = ver3[j];
              m.owner[s] = own3[j];
            } else {
              m.state[s] = vsl ? static_cast<signed char>(DRAIN) : st_o[j];
              m.dd[s] = vsl ? victim_dd : dd_o[j];
              m.tag[s] = tag_o[j];
              m.lru[s] = lru_o[j];
              m.ver[s] = ver_o[j];
              m.owner[s] = own_o[j];
            }
          }
        }
        if (lane < B) m.pm_busy[lane] = commit ? pmb2_mine : pmb1_mine;
        if (lane == 0) {
          if (vic_ok)
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
          st_row[S_PM_WRITES] += pm_writes_inc;
          st_row[S_STALL_TIME] += stall;
          st_row[S_ACKED] += ack <= crash ? 1.0 : 0.0;
          st_row[S_DURABLE] += commit ? 1.0 : 0.0;
          st_row[S_LAT_HIST0 + hist] += 1.0;
          m.pbc[0] = pbc_free;
          m.clock[c] = ack;
        }
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
    // cursor and crash-clock bookkeeping
    if (lane == 0) {
      m.ptr[c] += 1;
      if (!live) m.clock[c] = t_issue;
    }
    __syncwarp();
  }

  // ---- recovery snapshot + runtime ----------------------------------------
  double rt = 0.0;
  for (int k = lane; k < C; k += 32) {
    const double ck = m.clock[k];
    rt = fmax(rt, ck < INF * 0.5 ? fmin(ck, crash) : 0.0);
  }
  rt = warp_max(rt);
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
}

// ---- host entry point -------------------------------------------------
extern "C" int cell_scan_launch(
    const int* ops, const int* addrs, const float* gaps, const int* lengths,
    const int* cell_trace, const int* cell_cfg, const int* schemes,
    const double* sc_table, const double* ten_table,
    const double* lat_edges, double* runtime, double* stats,
    double* hop_stats, int* durable_ver, double* n_recov,
    double* recov_ns, double* recov_t, long long* steps, long long* lookups,
    int* aver, int n_cells, int C, int L, int P, int B, int A, int T,
    int n_track, cudaStream_t stream) {
  Args a{ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
         sc_table, ten_table, lat_edges, runtime, stats, hop_stats,
         durable_ver, n_recov, recov_ns, recov_t, steps, lookups, aver,
         C, L, P, B, A, T, n_track};
  Smem m;
  const size_t smem = carve(m, nullptr, C, P, B, T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cell_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cell_scan_kernel<<<n_cells, 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
