"""Splash-4-analogue trace generators (Section VI, Table II).

PyTorch-port copy of ``repro.core.traces`` (numpy only, byte-equal
output for equal seeds); :func:`trace_from_arrays` rebuilds a trace
from another package's arrays.

The paper evaluates seven Splash-4 benchmarks under the "efficient
checkpointing" persist discipline (every heap store is made durable with
clflush+mfence at loop-iteration granularity) with a 100k-persist ROI cap.
The binaries are not available offline, so each generator below emits the
LLC-miss-level memory-request stream *derived from the algorithm's loop
nest* (FFT, blocked LU) or from its published locality signature
(Cholesky/Radiosity/Raytrace/Volrend), at 64-byte line granularity.

Per-workload calibration targets (paper Figs. 5-7):
    workload     write-locality  read-after-persist  expected PB_RF
    radiosity    very high       ~51% hit            big win
    lu_cont      moderate        ~20% hit            win
    lu_non       moderate        ~20% hit            win (>20% PB)
    raytrace     moderate        ~20% hit            win
    fft          low (2.8%)      ~20% hit            small win / RF loss
    cholesky     ~1%             ~1% hit             slowdown
    volrend_npl  ~1%             ~1% hit             mild slowdown

Each trace is a per-core sequence of (op, addr, gap) where `gap` is the ns
of computation preceding the op.  An LRU filter models the private-L1 +
shared-L2 hierarchy (Table I: 32KB L1 / 256KB L2 -> ~4K lines visible per
core); persists always traverse to the switch (clflush forces write-back).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.params import Op

# Heap (persistent) lines live below this boundary; volatile above it.
PM_REGION_LINES = 1 << 22
DRAM_BASE = 1 << 24

# Paper ROI budget: "up-to 100,000 write operations to PM" (all cores).
DEFAULT_PERSIST_BUDGET = 100_000


class LLCFilter:
    """LRU filter approximating the per-core view of the cache hierarchy."""

    def __init__(self, capacity_lines: int = 4096):
        self.capacity = capacity_lines
        self._lru: "OrderedDict[int, None]" = OrderedDict()

    def access(self, line: int) -> bool:
        """Returns True when the access misses (must go to memory)."""
        if line in self._lru:
            self._lru.move_to_end(line)
            return False
        self._lru[line] = None
        if len(self._lru) > self.capacity:
            self._lru.popitem(last=False)
        return True

    def invalidate(self, line: int) -> None:
        self._lru.pop(line, None)


@dataclasses.dataclass
class Trace:
    """Padded per-core trace arrays consumed by the timed simulator."""

    ops: np.ndarray      # (C, L) int32
    addrs: np.ndarray    # (C, L) int32
    gaps: np.ndarray     # (C, L) float32 — compute ns preceding the op
    lengths: np.ndarray  # (C,) int32
    name: str = ""

    @property
    def n_cores(self) -> int:
        return self.ops.shape[0]

    @property
    def total_ops(self) -> int:
        return int(self.lengths.sum())

    def counts(self) -> Dict[str, int]:
        out = {}
        for op in Op:
            n = 0
            for c in range(self.n_cores):
                n += int((self.ops[c, : self.lengths[c]] == int(op)).sum())
            out[op.name.lower()] = n
        return out


class _CoreStream:
    """One core's op stream under construction, with an LLC filter."""

    def __init__(self, llc_lines: int = 4096):
        self.ops: List[int] = []
        self.addrs: List[int] = []
        self.gaps: List[float] = []
        self._pending_gap = 0.0
        self.llc = LLCFilter(llc_lines)
        self.persists = 0

    def compute(self, ns: float) -> None:
        self._pending_gap += ns

    def _emit(self, op: Op, addr: int) -> None:
        self.ops.append(int(op))
        self.addrs.append(int(addr))
        self.gaps.append(self._pending_gap)
        self._pending_gap = 0.0

    def read_pm(self, line: int) -> None:
        if self.llc.access(line):
            self._emit(Op.PM_READ, line)
        else:
            self.compute(1.0)  # L1/L2 hit cost

    def persist(self, line: int) -> None:
        # clflush evicts the line from the hierarchy and pushes it to PM.
        self.llc.invalidate(line)
        self._emit(Op.PERSIST, line)
        self.persists += 1

    def barrier(self) -> None:
        self._emit(Op.BARRIER, 0)

    def read_dram(self, line: int) -> None:
        if self.llc.access(DRAM_BASE + line):
            self._emit(Op.DRAM_READ, DRAM_BASE + line)
        else:
            self.compute(1.0)

    def write_dram(self, line: int) -> None:
        if self.llc.access(DRAM_BASE + line):
            self._emit(Op.DRAM_WRITE, DRAM_BASE + line)
        else:
            self.compute(1.0)


def _pack(streams: List[_CoreStream], name: str,
          barrier_groups: "List[range] | None" = None) -> Trace:
    # Barriers must be consistent across the cores that share them (one
    # group per tenant; barriers are tenant-local) or the simulation
    # deadlocks.
    groups = barrier_groups or [range(len(streams))]
    for g in groups:
        bar_counts = {sum(1 for o in streams[c].ops if o == int(Op.BARRIER))
                      for c in g}
        if len(bar_counts) > 1:
            raise ValueError(
                f"inconsistent barrier counts in {name}{list(g)}: "
                f"{bar_counts}")
    lengths = np.array([len(s.ops) for s in streams], dtype=np.int32)
    L = int(lengths.max()) if len(streams) else 0
    C = len(streams)
    ops = np.zeros((C, L), dtype=np.int32)
    addrs = np.zeros((C, L), dtype=np.int32)
    gaps = np.zeros((C, L), dtype=np.float32)
    for c, s in enumerate(streams):
        n = lengths[c]
        ops[c, :n] = s.ops
        addrs[c, :n] = s.addrs
        gaps[c, :n] = s.gaps
    return Trace(ops=ops, addrs=addrs, gaps=gaps, lengths=lengths, name=name)


def plan_runs(ops: np.ndarray, addrs: np.ndarray, gaps: np.ndarray,
              kmax: int = None) -> np.ndarray:
    """Trace-time macro-run planner (numpy pre-pass for engine.macro).

    ``mlen[c, i]`` is the length (1..kmax) of the longest *statically
    eligible* homogeneous run starting at op ``i`` of core ``c``: every
    op in the window is a PM_READ or PERSIST with a non-negative compute
    gap, and no two ops in the window share an address when either of
    the pair is a PERSIST (same-address pairs would coalesce in the PB /
    hit in the read path, which the engine's unrolled macro-step guards
    against dynamically anyway — the static filter just avoids paying
    for windows that would always abort).

    The value is only a *candidate*: the engine still evaluates its
    traced guard set (no cross-core interleaving, crash outside the
    window, depth-1, no PB hits, a free slot for every persist, ...) and
    falls back to slot-at-a-time handlers when any guard fails, so
    results are bit-exact by construction whether or not a run commits.

    Prefixes of eligible windows are eligible (the recurrence below is
    an all-pairs induction), so the engine may truncate a run at the
    stream tail without re-planning.
    """
    if kmax is None:
        from repro_torch.core.params import MACRO_KMAX
        kmax = MACRO_KMAX
    ops = np.asarray(ops)
    addrs = np.asarray(addrs)
    gaps = np.asarray(gaps)
    C, L = ops.shape
    is_p = ops == int(Op.PERSIST)
    valid = (is_p | (ops == int(Op.PM_READ))) & (gaps >= 0.0)
    mlen = np.ones((C, L), np.int8)
    for K in range(2, kmax + 1):
        d = K - 1
        if d >= L:
            break
        # valid_K[i] = valid_{K-1}[i] & valid_{K-1}[i+1] & pair_ok(i, i+d)
        pair_ok = ~((addrs[:, :L - d] == addrs[:, d:])
                    & (is_p[:, :L - d] | is_p[:, d:]))
        v_next = np.zeros((C, L), bool)
        v_next[:, :L - d] = valid[:, :L - d] & valid[:, 1:L - d + 1] & pair_ok
        if not v_next.any():
            break
        mlen[v_next] = K
        valid = v_next
    return mlen


# ===========================================================================
# Algorithm-derived generators
# ===========================================================================

def fft_trace(n_cores: int = 8, m: int = 12, seed: int = 0,
              persist_budget: int = DEFAULT_PERSIST_BUDGET) -> Trace:
    """Radix-2 FFT, -m12 (2^12 complex doubles), Splash-4 FFT kernel.

    Each of the log2(n) stages touches every point once; points are 16B so
    4 points share a line.  Following the efficient-checkpointing persist
    discipline, each core flushes the lines it modified at the end of every
    EPOCH butterflies (once per line per epoch), then all cores barrier at
    the stage boundary.  A line is re-persisted only one full stage later,
    giving FFT its low write-coalescing rate (~3%).  The inter-core
    exchange of the six-step FFT is modeled by each core reading two lines
    of its neighbour's just-flushed epoch — the read-after-persist traffic
    behind FFT's moderate RF hit rate and its PB read-latency increase.
    """
    del seed  # deterministic address stream
    n = 1 << m
    points_per_line = 4
    streams = [_CoreStream() for _ in range(n_cores)]
    budget = persist_budget
    epoch = 8  # butterflies between checkpoint flushes

    for stage in range(m):
        half = 1 << stage
        # pass 1: per-core epoch flush lists (address math only)
        flushes: List[List[List[int]]] = []
        spans = []
        for c in range(n_cores):
            lo = (n // 2) * c // n_cores
            hi = (n // 2) * (c + 1) // n_cores
            spans.append((lo, hi))
            eps: List[List[int]] = []
            dirty: "OrderedDict[int, None]" = OrderedDict()
            for j, b in enumerate(range(lo, hi)):
                top = (b // half) * (2 * half) + (b % half)
                bot = top + half
                dirty[top // points_per_line] = None
                dirty[bot // points_per_line] = None
                if (j + 1 + 3 * c) % epoch == 0:
                    eps.append(list(dirty))
                    dirty.clear()
            if dirty:
                eps.append(list(dirty))
            flushes.append(eps)
        # pass 2: emit ops; core c reads 2 lines of core c-1's same epoch
        for c in range(n_cores):
            s = streams[c]
            lo, hi = spans[c]
            e_idx = 0
            for j, b in enumerate(range(lo, hi)):
                top = (b // half) * (2 * half) + (b % half)
                bot = top + half
                l_top, l_bot = top // points_per_line, bot // points_per_line
                s.read_pm(l_top)
                if l_bot != l_top:
                    s.read_pm(l_bot)
                s.compute(3800.0)  # flops, twiddles, transposes, sync slack
                if (j + 1 + 3 * c) % epoch == 0 or b == hi - 1:
                    for ln in flushes[c][e_idx]:
                        if budget > 0:
                            s.persist(ln)
                            budget -= 1
                        s.compute(3.0)
                    # neighbour-boundary exchange reads
                    prev = flushes[(c - 1) % n_cores]
                    if e_idx < len(prev) and prev[e_idx]:
                        for ln in prev[e_idx][:2]:
                            s.read_pm(ln)
                    e_idx += 1
        for s in streams:
            s.barrier()
    return _pack(streams, "fft")


def _lu_trace(n_cores: int, n: int, block: int, contiguous: bool,
              seed: int, persist_budget: int, name: str) -> Trace:
    """Blocked right-looking LU, -n128 (Splash-4 LU kernel).

    Contiguous: blocks are stored contiguously (a 16x16 double block = 32
    consecutive lines).  Non-contiguous: row-major full matrix, so a block
    row (16 doubles = 128B) spans 2 lines and rows stride 16 lines, halving
    line-level write reuse — which is why Lu_non benefits more from the PB.

    Phases are separated by barriers (as in Splash-4): the owner factors
    and persists the pivot block, then every core's panel update re-reads
    the freshly flushed pivot lines — the cross-core read-after-persist
    pattern behind LU's ~20% RF hit rate.

    ``seed`` jitters the dgemm compute gaps (exponential multiplier,
    the same idiom as :func:`_signature_trace`), so ``lu_cont`` (seed 1)
    and ``lu_non`` (seed 2) genuinely differ in timing; the op/address
    stream itself is the deterministic loop nest.
    """
    rng = np.random.default_rng(seed)
    nb = n // block
    elems_per_line = 8
    streams = [_CoreStream() for _ in range(n_cores)]
    budget = persist_budget

    def block_lines(bi: int, bj: int) -> np.ndarray:
        if contiguous:
            base = (bi * nb + bj) * (block * block // elems_per_line)
            return np.arange(base, base + block * block // elems_per_line)
        # row-major n x n matrix of doubles
        rows = bi * block + np.arange(block)
        start = rows * (n // elems_per_line) + (bj * block) // elems_per_line
        width = max(block // elems_per_line, 1)  # lines per block row
        return (start[:, None] + np.arange(width)[None, :]).ravel()

    def persist_block(s: _CoreStream, lines: np.ndarray,
                      repeat: int = 1, group_sz: int = 2) -> None:
        # `repeat` models element-granularity flushing: clflush evicts the
        # line, the next element write re-fetches it (an RFO read that the
        # PB can serve — LU's RF hit source) and flushes it again while the
        # previous version is still Dirty (LU's coalescing source).
        nonlocal budget
        for group in np.array_split(lines, max(len(lines) // group_sz, 1)):
            for _ in range(repeat):
                for ln in group:
                    s.read_pm(int(ln))
                    s.compute(30.0)
                    if budget > 0:
                        s.persist(int(ln))
                        budget -= 1

    for k in range(nb):
        # 1. factor the diagonal block (owner core persists it)
        owner = k % n_cores
        persist_block(streams[owner], block_lines(k, k),
                      repeat=1 if contiguous else 2)
        for s in streams:
            s.barrier()
        # 2. panel updates: every panel task re-reads the pivot block
        panels = [(k, j) for j in range(k + 1, nb)] + \
                 [(i, k) for i in range(k + 1, nb)]
        for p_idx, (bi, bj) in enumerate(panels):
            s = streams[p_idx % n_cores]
            for ln in block_lines(k, k):      # freshly persisted pivot
                s.read_pm(int(ln))
                s.compute(4.0)
            persist_block(s, block_lines(bi, bj),
                          repeat=1 if contiguous else 2)
        for s in streams:
            s.barrier()
        # 3. trailing submatrix update (owner-computes by column block)
        trailing = [(i, j) for i in range(k + 1, nb) for j in range(k + 1, nb)]
        for t_i, (bi, bj) in enumerate(trailing):
            s = streams[bj % n_cores]
            s.compute((2800.0 if contiguous else 1500.0)
                      * float(rng.exponential(1.0)))  # dgemm arithmetic
            for ln in block_lines(bi, k):
                s.read_pm(int(ln))
            for ln in block_lines(k, bj):
                s.read_pm(int(ln))
            persist_block(s, block_lines(bi, bj),
                          repeat=2 if (t_i % 4 == 0 or not contiguous) else 1)
        for s in streams:
            s.barrier()
        if budget <= 0:
            break
    return _pack(streams, name)


def lu_cont_trace(n_cores: int = 8, seed: int = 1,
                  persist_budget: int = DEFAULT_PERSIST_BUDGET) -> Trace:
    return _lu_trace(n_cores, 128, 16, True, seed, persist_budget, "lu_cont")


def lu_non_trace(n_cores: int = 8, seed: int = 2,
                 persist_budget: int = DEFAULT_PERSIST_BUDGET) -> Trace:
    return _lu_trace(n_cores, 128, 16, False, seed, persist_budget, "lu_non")


# ===========================================================================
# Signature-derived generators
# ===========================================================================

def _signature_trace(name: str, n_cores: int, seed: int, *,
                     n_iters: int,
                     hot_lines: int,
                     cold_lines: int,
                     p_persist: float,
                     p_hot_write: float,
                     reads_per_iter: float,
                     p_read_recent: float,
                     compute_ns: float,
                     persist_budget: int,
                     recent_window: int = 8,
                     zipf_a: float = 1.4,
                     persist_burst: int = 1,
                     p_read_mid: float = 0.0,
                     mid_window: int = 256,
                     p_shared: float = 1.0,
                     recent_global: bool = False) -> Trace:
    """Stochastic generator parameterized by a workload's locality signature.

    p_hot_write    — probability a persist targets the small hot set, with
                     Zipf(zipf_a) concentration within it (drives the
                     write-coalescing rate of Fig 7b: a re-persist coalesces
                     only while the line is still Dirty in the 16-entry PB).
    p_read_recent  — probability a PM read targets one of the
                     `recent_window` most recently persisted lines on the
                     same core (the persist-A-then-load-A pattern of Fig 2;
                     drives the RF read-hit rate of Fig 7a).
    p_read_mid     — reads to mid-distance persisted lines (drained and
                     evicted from the 16-entry PB long ago; they go straight
                     to PM but land in the PM-channel shadow of drain
                     bursts — the Cholesky read-latency mechanism).
    p_shared       — fraction of hot persists to globally shared lines;
                     the rest hit a per-core partition of the hot set
                     (radiosity partitions patches among workers, so most
                     re-persists of a line come from one core).
    persist_burst  — lines persisted back-to-back (e.g. a sparse-Cholesky
                     column flush), which makes drain traffic bursty.
    """
    rng = np.random.default_rng(seed)
    streams = [_CoreStream() for _ in range(n_cores)]
    budget = persist_budget
    # recency: per-core (a core re-reads its own fresh writes) or global
    # (consumers chase other cores' freshly persisted data, e.g. the
    # left-looking Cholesky dependency pattern)
    shared_recent: List[int] = []
    recent: List[List[int]] = [shared_recent] * n_cores if recent_global \
        else [[] for _ in range(n_cores)]
    mid: List[int] = []  # global mid-distance window
    # Zipf ranks over the hot set, precomputed for sampling
    ranks = np.arange(1, hot_lines + 1, dtype=np.float64)
    zipf_p = ranks ** (-zipf_a)
    zipf_p /= zipf_p.sum()
    next_cold = hot_lines  # fresh cold lines for write-once streams

    slice_sz = max(hot_lines // n_cores, 1)

    def pick_persist_line(c: int) -> int:
        nonlocal next_cold
        if rng.random() < p_hot_write:
            z = int(rng.choice(hot_lines, p=zipf_p))
            if rng.random() < p_shared:
                return z
            return (c * slice_sz + z % slice_sz) % hot_lines
        next_cold += 1
        return hot_lines + (next_cold % cold_lines)

    for _ in range(n_iters):
        if budget <= 0:
            break
        for c in range(n_cores):
            s = streams[c]
            s.compute(compute_ns * float(rng.exponential(1.0)))
            # reads
            n_reads = rng.poisson(reads_per_iter)
            for _ in range(n_reads):
                r = recent[c]
                u = rng.random()
                if r and u < p_read_recent:
                    line = r[rng.integers(len(r))]
                elif mid and u < p_read_recent + p_read_mid:
                    line = mid[rng.integers(len(mid))]
                else:
                    line = hot_lines + int(rng.integers(cold_lines))
                s.read_pm(line)
            # persist burst
            if rng.random() < p_persist and budget > 0:
                for _ in range(persist_burst):
                    if budget <= 0:
                        break
                    line = pick_persist_line(c)
                    s.persist(line)
                    budget -= 1
                    recent[c].append(line)
                    if len(recent[c]) > recent_window:
                        mid.append(recent[c].pop(0))
                        if len(mid) > mid_window:
                            mid.pop(0)
    return _pack(streams, name)


def cholesky_trace(n_cores: int = 8, seed: int = 3,
                   persist_budget: int = DEFAULT_PERSIST_BUDGET) -> Trace:
    """Sparse left-looking Cholesky (tk18.O): read-dominated; each column
    is written once (coalescing ~1%) and read long after it was drained
    (RF hit ~1%), so PB's PI-buffer read detour costs dominate."""
    return _signature_trace(
        "cholesky", n_cores, seed,
        n_iters=5200, hot_lines=32, cold_lines=200_000,
        p_persist=0.030, p_hot_write=0.01,
        reads_per_iter=9.0, p_read_recent=0.10,
        compute_ns=150.0, persist_budget=persist_budget,
        recent_window=12, persist_burst=32,
        p_read_mid=0.25, mid_window=256, recent_global=True)


def radiosity_trace(n_cores: int = 8, seed: int = 4,
                    persist_budget: int = DEFAULT_PERSIST_BUDGET) -> Trace:
    """Radiosity (-ae 5000 -bf 0.1): the interaction loop re-persists a
    small set of patch accumulators at high frequency (coalescing ~50%)
    and immediately re-reads them (RF hit ~51%) — the paper's best case."""
    return _signature_trace(
        "radiosity", n_cores, seed,
        n_iters=4200, hot_lines=18, cold_lines=40_000,
        p_persist=0.85, p_hot_write=0.82,
        reads_per_iter=1.1, p_read_recent=0.75,
        compute_ns=240.0, persist_budget=persist_budget,
        recent_window=4, zipf_a=1.5, p_shared=0.3)


def raytrace_trace(n_cores: int = 8, seed: int = 5,
                   persist_budget: int = DEFAULT_PERSIST_BUDGET) -> Trace:
    """Raytrace (teapot.env): BVH reads with moderate reuse; irradiance /
    pixel accumulators give ~20% write locality and read-after-persist."""
    return _signature_trace(
        "raytrace", n_cores, seed,
        n_iters=4400, hot_lines=64, cold_lines=60_000,
        p_persist=0.45, p_hot_write=0.32,
        reads_per_iter=2.0, p_read_recent=0.30,
        compute_ns=120.0, persist_budget=persist_budget,
        recent_window=8)


def volrend_trace(n_cores: int = 8, seed: int = 6,
                  persist_budget: int = DEFAULT_PERSIST_BUDGET) -> Trace:
    """Volrend_npl (headscaleddown2): ray-cast reads over a large volume
    (low reuse); image writes are write-once (coalescing/hit ~1%)."""
    return _signature_trace(
        "volrend_npl", n_cores, seed,
        n_iters=4200, hot_lines=32, cold_lines=150_000,
        p_persist=0.025, p_hot_write=0.02,
        reads_per_iter=8.0, p_read_recent=0.06,
        compute_ns=140.0, persist_budget=persist_budget,
        recent_window=12, persist_burst=24,
        p_read_mid=0.22, mid_window=256, recent_global=True)


# ===========================================================================
# Multi-tenant composition (shared-switch scale-out)
# ===========================================================================

def tenant_ids(lengths, n_tenants: int) -> np.ndarray:
    """Per-core tenant ids: the numpy twin of the engine's mapping.

    The timed engine partitions the live cores into ``n_tenants``
    contiguous balanced groups — core ``c`` belongs to tenant
    ``floor(c * T / n_live)`` (``engine.step.scan_cell``).  Tests and
    the oracle replay must use THIS function rather than restating the
    formula, so the two layers cannot drift.
    """
    lengths = np.asarray(lengths)
    n_live = max(int((lengths > 0).sum()), 1)
    tid = (np.arange(len(lengths)) * int(n_tenants)) // n_live
    return np.minimum(tid, n_tenants - 1).astype(np.int32)


def leaf_placement(n_tenants: int, n_leaves: int,
                   mode: str = "packed") -> tuple:
    """Tenant -> leaf placement vector for a fan-out fabric.

    ``"packed"`` fills leaves with contiguous balanced tenant blocks
    (tenant ``t`` on leaf ``floor(t * n_leaves / n_tenants)``) —
    neighbours share a leaf switch, maximizing per-leaf contention and
    leaving far leaves idle.  ``"spread"`` round-robins tenants across
    the leaves — per-leaf load is even, spine fan-in pressure is
    maximal.  The two are the benchmark sweep's placement axis
    (``benchmarks/fig_fabric.py``); both are valid
    ``FabricTopology.placement`` values for any ``n_tenants >=
    n_leaves`` and degenerate to all-zeros at one leaf.
    """
    if n_tenants < 1 or n_leaves < 1:
        raise ValueError("leaf_placement wants n_tenants, n_leaves >= 1")
    if mode == "packed":
        return tuple((t * n_leaves) // n_tenants
                     for t in range(n_tenants))
    if mode == "spread":
        return tuple(t % n_leaves for t in range(n_tenants))
    raise ValueError(f"unknown placement mode: {mode!r}")


def compose_tenants(tenant_traces: List[Trace], *,
                    addr_stride: int | None = None,
                    shared_lines: int = 0,
                    name: str = "") -> Trace:
    """Stack per-tenant workload traces into one shared-switch trace.

    Each input trace is one tenant (an independent host); their cores
    are concatenated so the engine's balanced partition maps tenant
    ``t`` exactly onto input ``t`` (every tenant must contribute the
    same number of cores, all live).  PM addresses are relocated into
    disjoint per-tenant windows of ``addr_stride`` lines — independent
    address spaces — except the first ``shared_lines`` lines, which
    stay common to every tenant (the shared-hot-set contention
    variant).  DRAM addresses are host-private state and irrelevant to
    the shared switch; they are left untouched.

    Simulate the result with ``PCSConfig(n_tenants=len(tenant_traces),
    n_cores=<total cores>)``.
    """
    if not tenant_traces:
        raise ValueError("need at least one tenant trace")
    cores = {t.ops.shape[0] for t in tenant_traces}
    if len(cores) != 1:
        raise ValueError(
            "tenants must contribute equal core counts so the engine's "
            f"balanced partition lands on tenant boundaries; got {cores}")
    for t in tenant_traces:
        if np.any(t.lengths <= 0):
            raise ValueError(
                f"every core must be live (non-empty stream); {t.name!r} "
                "has an empty core, which would shift the partition")
    T = len(tenant_traces)
    pm_max = 0
    for t in tenant_traces:
        pm = (t.addrs < DRAM_BASE) & np.isin(
            t.ops, (int(Op.PM_READ), int(Op.PERSIST)))
        if np.any(pm):
            pm_max = max(pm_max, int(t.addrs[pm].max()) + 1)
    if addr_stride is None:
        addr_stride = max(pm_max, shared_lines + 1)
    elif addr_stride < pm_max:
        # a narrower stride would relocate different tenants onto the
        # same PM lines — silently breaking the promised disjointness
        raise ValueError(
            f"addr_stride={addr_stride} is smaller than the tenants' PM "
            f"footprint ({pm_max} lines): per-tenant windows would overlap")
    if not 0 <= shared_lines <= addr_stride:
        raise ValueError("require 0 <= shared_lines <= addr_stride")
    if shared_lines + T * (addr_stride - shared_lines) > PM_REGION_LINES:
        raise ValueError("tenant address windows exceed the PM region; "
                         "lower addr_stride or the tenant count")
    C = cores.pop()
    L = max(t.ops.shape[1] for t in tenant_traces)
    ops = np.zeros((T * C, L), np.int32)
    addrs = np.zeros((T * C, L), np.int32)
    gaps = np.zeros((T * C, L), np.float32)
    lengths = np.zeros((T * C,), np.int32)
    for t, tr in enumerate(tenant_traces):
        lo, l = t * C, tr.ops.shape[1]
        ops[lo:lo + C, :l] = tr.ops
        gaps[lo:lo + C, :l] = tr.gaps
        lengths[lo:lo + C] = tr.lengths
        a = tr.addrs.astype(np.int64)
        private = ((a < DRAM_BASE) & (a >= shared_lines)
                   & np.isin(tr.ops, (int(Op.PM_READ), int(Op.PERSIST))))
        a = np.where(private, a + t * (addr_stride - shared_lines), a)
        addrs[lo:lo + C, :l] = a[:, :l].astype(np.int32)
    name = name or ("+".join(t.name for t in tenant_traces) or "tenants")
    return Trace(ops=ops, addrs=addrs, gaps=gaps, lengths=lengths,
                 name=f"{name}[T={T}]")


def make_mixed_tenant_trace(specs: "List[Tuple[str, int]]",
                            cores_per_tenant: int = 2, *,
                            shared_lines: int = 0, seed: int = 0,
                            name: str = "", **kw) -> Trace:
    """Heterogeneous tenants on one shared switch — the quota-pressure
    composition behind the QoS policy sweeps.

    ``specs`` is one ``(workload, persist_budget)`` pair per tenant, so
    a *noisy* tenant (large budget, write-hot workload) can sit next to
    quiet ones: without per-tenant PBE quotas the noisy tenant's
    allocations and drain-downs monopolize the shared PB, which is
    exactly the skew ``benchmarks/fig_qos.py`` sweeps policies against.
    Each tenant gets a distinct seed (distinct streams) and the usual
    disjoint PM address window (``shared_lines`` keeps a common hot
    window, see :func:`compose_tenants`).
    """
    if not specs:
        raise ValueError("need at least one (workload, budget) spec")
    parts = [make_trace(w, n_cores=cores_per_tenant, seed=seed + 101 * t,
                        persist_budget=budget, **kw)
             for t, (w, budget) in enumerate(specs)]
    name = name or "+".join(f"{w}@{b}" for w, b in specs)
    return compose_tenants(parts, shared_lines=shared_lines, name=name)


def make_tenant_trace(workload: str, n_tenants: int,
                      cores_per_tenant: int = 2, *,
                      shared_lines: int = 0, seed: int = 0,
                      persist_budget: int = DEFAULT_PERSIST_BUDGET,
                      **kw) -> Trace:
    """``n_tenants`` independent instances of one workload on a shared
    switch: each tenant runs its own ``cores_per_tenant``-core copy
    (distinct seed, so distinct streams) with ``persist_budget`` persists
    *per tenant* — offered load scales with the tenant count, which is
    the scale-out contention axis of the tenant sweep."""
    parts = [make_trace(workload, n_cores=cores_per_tenant,
                        seed=seed + 101 * t, persist_budget=persist_budget,
                        **kw)
             for t in range(n_tenants)]
    return compose_tenants(parts, shared_lines=shared_lines,
                           name=workload)


# ===========================================================================
# Fuzzed conformance traces (crash-differential harness)
# ===========================================================================

# Slot spacing of fuzzed traces.  Each op occupies one global "slot" at
# nominal time slot*FUZZ_SLOT_GAP_NS; the gap dwarfs every service
# latency (persist ack, victim wait, drain burst are all < ~5 us), so
# (a) the engine's issue-time merge executes ops exactly in slot order,
# (b) every drain scheduled by slot k's op is acked before slot k+1
#     (the oracle's prompt-ack regime), and
# (c) a crash at fuzz_crash_ns(k) falls cleanly *between* slot k and
#     slot k+1 — the same logical point in both layers.
FUZZ_SLOT_GAP_NS = 1.0e6
# A core's clock drifts past its nominal slot time by the accumulated
# service latencies of its own ops (< ~1 us each in the uncongested
# regime); the slot-order and crash-boundary guarantees need the total
# drift to stay well under half a slot gap.
_FUZZ_MAX_SLOTS = 250


def fuzz_crash_ns(slot: int, slot_gap_ns: float = FUZZ_SLOT_GAP_NS) -> float:
    """Power-loss instant falling between slot ``slot`` and ``slot + 1``."""
    return (slot + 0.5) * slot_gap_ns


def fuzz_trace(seed: int, n_cores: int = 3, n_slots: int = 60,
               n_addrs: int = 8, p_persist: float = 0.55,
               p_barrier: float = 0.05,
               slot_gap_ns: float = FUZZ_SLOT_GAP_NS,
               n_tenants: int = 1
               ) -> Tuple[Trace, List[Tuple[int, int, int, int]]]:
    """Random multi-core persist/read/barrier interleaving for the
    crash-differential harness (beyond the 7 paper workloads).

    Returns ``(trace, schedule)`` where ``schedule`` is the global op
    order ``[(slot, core, op, addr), ...]``: the sequence the untimed
    oracle replays, and provably the order the timed engine executes
    (see ``FUZZ_SLOT_GAP_NS``).  Barriers occupy one slot per arriving
    core (consecutive, core order); persist/read slots go to a random
    core.  With ``n_tenants > 1`` the cores split into contiguous
    equal groups and a barrier event synchronizes ONE tenant's cores
    (matching the engine's per-tenant barriers); every tenant's first
    slots are round-robin ops so all cores are live and the engine's
    balanced partition maps group ``t`` to tenant ``t`` exactly.
    """
    if n_slots > _FUZZ_MAX_SLOTS:
        raise ValueError(f"n_slots > {_FUZZ_MAX_SLOTS} breaks the "
                         "slot-order guarantee (clock drift)")
    if n_cores % n_tenants != 0:
        raise ValueError("n_cores must divide evenly into n_tenants")
    cpt = n_cores // n_tenants     # cores per tenant
    rng = np.random.default_rng(seed)
    streams = [_CoreStream() for _ in range(n_cores)]
    nominal = [0] * n_cores        # last issue slot per core
    schedule: List[Tuple[int, int, int, int]] = []
    slot = 1
    # liveness preamble: one op per core, so lengths > 0 everywhere and
    # tenant_ids() is the identity partition on core groups
    warmup = list(range(n_cores)) if n_tenants > 1 else []
    while slot <= n_slots:
        if warmup:
            c = warmup.pop(0)
        elif n_cores > 1 and slot + cpt - 1 <= n_slots \
                and rng.random() < p_barrier:
            # barrier of ONE tenant: its cores arrive at consecutive
            # slots; the last arrival releases them, so each resumes
            # from its tenant's release slot
            t = int(rng.integers(n_tenants))
            for k, c in enumerate(range(t * cpt, (t + 1) * cpt)):
                s = streams[c]
                s.compute((slot + k - nominal[c]) * slot_gap_ns)
                s.barrier()
                schedule.append((slot + k, c, int(Op.BARRIER), 0))
            release = slot + cpt - 1
            for c in range(t * cpt, (t + 1) * cpt):
                nominal[c] = release
            slot += cpt
            continue
        else:
            c = int(rng.integers(n_cores))
        op = Op.PERSIST if rng.random() < p_persist else Op.PM_READ
        addr = int(rng.integers(n_addrs))
        streams[c].compute((slot - nominal[c]) * slot_gap_ns)
        # bypass the LLC filter: conformance traces are switch-level op
        # streams, every op must reach the simulated switch
        streams[c]._emit(op, addr)
        schedule.append((slot, c, int(op), addr))
        nominal[c] = slot
        slot += 1
    groups = [range(t * cpt, (t + 1) * cpt) for t in range(n_tenants)]
    return _pack(streams, f"fuzz{seed}", barrier_groups=groups), schedule


WORKLOADS: Dict[str, Callable[..., Trace]] = {
    "fft": fft_trace,
    "lu_cont": lu_cont_trace,
    "lu_non": lu_non_trace,
    "cholesky": cholesky_trace,
    "radiosity": radiosity_trace,
    "raytrace": raytrace_trace,
    "volrend_npl": volrend_trace,
}


def trace_from_arrays(name: str, ops, addrs, gaps, lengths) -> Trace:
    """Rebuild a :class:`Trace` from the arrays of another package's
    trace (same dtypes as :func:`_pack`: int32 ops/addrs, float32 gaps,
    int32 lengths)."""
    return Trace(ops=np.array(ops, np.int32), addrs=np.array(addrs, np.int32),
                 gaps=np.array(gaps, np.float32),
                 lengths=np.array(lengths, np.int32), name=name)


def make_trace(name: str, n_cores: int = 8, **kw) -> Trace:
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; have {sorted(WORKLOADS)}")
    return WORKLOADS[name](n_cores=n_cores, **kw)


# ===========================================================================
# Serving-style offered load (open-loop arrival processes)
# ===========================================================================
# The workload generators above are *closed-loop*: each core computes,
# then issues, so the issue rate adapts to service latency and a
# saturated switch simply slows the workload down.  Serving traffic is
# the opposite — requests arrive at an *offered* rate regardless of how
# the system is doing, and the experienced tail latency explodes at the
# saturation knee.  An :class:`ArrivalProcess` re-times an existing
# workload trace: every compute gap is replaced by an interarrival
# sample ``E * 1000 / rate(t)`` ns with ``E ~ Exp(1)`` and ``rate`` in
# Mops/s per core, evaluated at the core's *nominal* arrival clock (the
# open-loop schedule, independent of service times).  The result is
# semi-open: arrivals pace the think time, but a core still blocks on
# its in-flight persist, so the queue lives in the switch/PM resources
# — exactly where the knee forms as the offered interarrival gap drops
# below the persist service time.  Offered load thereby becomes a
# sweepable *trace* axis of ``simulate_grid``, like ``crash_at_ns`` is
# a config axis.

@dataclasses.dataclass(frozen=True)
class PoissonArrivals:
    """Open-loop Poisson arrivals at a constant per-core offered load."""

    rate_mops: float                 # million ops/s per core

    def __post_init__(self) -> None:
        if not self.rate_mops > 0:
            raise ValueError("rate_mops must be > 0")

    @property
    def label(self) -> str:
        return f"poisson{self.rate_mops:g}"

    def rate_at(self, t_ns: float) -> float:
        return self.rate_mops

    def sample_gaps(self, n: int, rng: np.random.Generator) -> np.ndarray:
        # constant rate: the sequential loop in _sample_gaps reduces to
        # e[i] * (1000 / rate) elementwise — vectorize it
        return rng.exponential(1.0, n) * (1000.0 / self.rate_mops)


@dataclasses.dataclass(frozen=True)
class BurstyArrivals:
    """On-off (bursty) arrivals: rate ``burst``x higher during the on
    phase, scaled so the *time-average* offered load is ``rate_mops``."""

    rate_mops: float                 # time-average load, Mops/s per core
    burst: float = 8.0               # on-phase / off-phase rate ratio
    on_fraction: float = 0.25        # fraction of each period spent on
    period_ns: float = 200_000.0
    phase_ns: float = 0.0

    def __post_init__(self) -> None:
        if not self.rate_mops > 0:
            raise ValueError("rate_mops must be > 0")
        if not self.burst >= 1.0:
            raise ValueError("burst must be >= 1")
        if not 0.0 < self.on_fraction <= 1.0:
            raise ValueError("on_fraction must be in (0, 1]")
        if not self.period_ns > 0:
            raise ValueError("period_ns must be > 0")

    @property
    def label(self) -> str:
        return f"bursty{self.rate_mops:g}x{self.burst:g}"

    def rate_at(self, t_ns: float) -> float:
        f = self.on_fraction
        # r_on * f + (r_on / burst) * (1 - f) == rate_mops
        r_on = self.rate_mops * self.burst / (f * self.burst + (1.0 - f))
        on = ((t_ns + self.phase_ns) % self.period_ns) < f * self.period_ns
        return r_on if on else r_on / self.burst

    def sample_gaps(self, n: int, rng: np.random.Generator) -> np.ndarray:
        return _sample_gaps(self, n, rng)


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals:
    """Sinusoidal rate profile (a compressed day): ``rate_mops * (1 +
    amplitude * sin(2*pi*t/period))``, time-average ``rate_mops``."""

    rate_mops: float                 # time-average load, Mops/s per core
    amplitude: float = 0.5           # peak-to-mean swing, < 1
    period_ns: float = 2_000_000.0
    phase_ns: float = 0.0

    def __post_init__(self) -> None:
        if not self.rate_mops > 0:
            raise ValueError("rate_mops must be > 0")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")
        if not self.period_ns > 0:
            raise ValueError("period_ns must be > 0")

    @property
    def label(self) -> str:
        return f"diurnal{self.rate_mops:g}a{self.amplitude:g}"

    def rate_at(self, t_ns: float) -> float:
        w = 2.0 * np.pi * (t_ns + self.phase_ns) / self.period_ns
        return self.rate_mops * (1.0 + self.amplitude * float(np.sin(w)))

    def sample_gaps(self, n: int, rng: np.random.Generator) -> np.ndarray:
        return _sample_gaps(self, n, rng)


def _sample_gaps(proc, n: int, rng: np.random.Generator) -> np.ndarray:
    """Sequential interarrival sampling under a time-varying rate: each
    gap is an Exp(1) draw scaled by the instantaneous rate at the
    *nominal* arrival time (the open-loop clock the gaps themselves
    accumulate — service times never feed back into it)."""
    e = rng.exponential(1.0, n)
    out = np.empty((n,), np.float64)
    t = 0.0
    for i in range(n):
        g = e[i] * 1000.0 / proc.rate_at(t)
        out[i] = g
        t += g
    return out


def apply_arrivals(trace: Trace, arrivals, *, seed: int = 0,
                   n_tenants: int = 1) -> Trace:
    """Re-time ``trace`` under open-loop arrival processes.

    Ops, addresses and lengths are untouched — only the compute gaps
    are replaced, per core, by interarrival samples from the core's
    tenant's :class:`ArrivalProcess`.  ``arrivals`` is one process (or
    a bare rate in Mops/s per core, promoted to Poisson) applied to
    every tenant, or a sequence of ``n_tenants`` processes mapped onto
    cores via :func:`tenant_ids` — per-tenant rate profiles on a shared
    switch.  Deterministic in ``seed`` (one substream per core).
    """
    procs = arrivals if isinstance(arrivals, (list, tuple)) else [arrivals]
    procs = [PoissonArrivals(p) if isinstance(p, (int, float)) else p
             for p in procs]
    if len(procs) not in (1, n_tenants):
        raise ValueError(f"need 1 or n_tenants={n_tenants} arrival "
                         f"processes, got {len(procs)}")
    tid = tenant_ids(trace.lengths, n_tenants)
    gaps = np.array(trace.gaps, np.float32, copy=True)
    for c in range(trace.n_cores):
        n = int(trace.lengths[c])
        if n <= 0:
            continue
        rng = np.random.default_rng([seed, c])
        proc = procs[0] if len(procs) == 1 else procs[int(tid[c])]
        gaps[c, :n] = proc.sample_gaps(n, rng).astype(np.float32)
    label = "+".join(p.label for p in procs)
    return Trace(ops=trace.ops, addrs=trace.addrs, gaps=gaps,
                 lengths=trace.lengths, name=f"{trace.name}@{label}")


def make_offered_load_trace(workload: str, arrivals, *, n_cores: int = 8,
                            seed: int = 0,
                            persist_budget: int = DEFAULT_PERSIST_BUDGET,
                            n_tenants: int = 1, **kw) -> Trace:
    """One-call serving composition: build ``workload``'s op/address
    stream, then re-time it under ``arrivals`` (a process, a bare
    Mops/s rate, or one process per tenant) — the offered-load axis of
    ``benchmarks/fig_slo.py``."""
    base = make_trace(workload, n_cores=n_cores,
                      persist_budget=persist_budget, **kw)
    return apply_arrivals(base, arrivals, seed=seed, n_tenants=n_tenants)
