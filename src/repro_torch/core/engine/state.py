"""Machine state, statistics layout and config lowering (torch port).

Port of ``repro.core.engine.state``.  The scan carry of the timed
engine is one :class:`MachineState` of tensors: per-core clocks and
trace cursors, the PB tables (TAT tags, ST states, LRU stamps, in-flight
drain-ack times), the deep-hop PB tables of a switch chain, the resource
next-free times (PM banks, PBC, deep-hop PBCs, the leaf switches' PBCs
of a fan-out fabric) and the statistics accumulators behind Figs. 1 and
5-8.

Every latency parameter, the live PBE bound, the drain thresholds, the
scheme id, the tenant count, the switch-chain depth with its per-hop
capacities and the fabric's leaf windows are per-config scalars/vectors
(:func:`scalars_from_config`),
so one grid of mixed configs runs through one cell-scan kernel launch.
Statistics are accumulated per tenant — ``stats`` is ``(T, N_STATS)`` —
and the global :class:`SimResult` is the sum over tenants, bit-exact for
single-tenant configs.

The fabric's per-leaf PBC clocks (``lpbc``) carry ``NL`` entries, ``NL =
n_leaves_max`` when the grid holds a multi-leaf fabric, else 0 (no
fabric branch runs).  A grid that holds a ``Schedule`` lowers every
:data:`EPOCH_KEYS` row with a leading epoch axis and one
``epoch_bounds`` vector; the step loop resolves them per op
(``step.resolve_epoch_sc``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core.params import (PBEState, PCSConfig, epoch_value,
                                     hop_drain_counts, preset_count,
                                     resolve_epoch, tenant_drain_counts,
                                     threshold_count)

INF = 1e30

# Epoched-schedule lowering (DESIGN §7): the sc keys that gain a leading
# (E,) epoch axis when any config in the grid carries a Schedule.
EPOCH_KEYS = ("threshold_count", "preset_count", "quota", "share",
              "t_threshold", "t_preset", "deep_thr", "deep_pre",
              "lat_target", "leaf_of_t")

# statistics vector layout
S_PERSIST_SUM = 0
S_PERSIST_CNT = 1
S_READ_SUM = 2
S_READ_CNT = 3
S_READ_HITS = 4
S_COALESCES = 5
S_PM_WRITES = 6
S_STALL_TIME = 7
S_PI_DETOURS = 8
S_DRAM_READS = 9
S_VICTIM_CNT = 10    # persists that took the no-Empty victim path
S_PBCQ_SUM = 11      # total PBC queueing wait (arrival -> service start)
S_ACKED = 12         # persists whose ack reached the core before the crash
S_DURABLE = 13       # persists whose payload survives crash + recovery
S_SLO_OVER = 14      # persists whose ack latency exceeded lat_target
# Fixed-bin log-spaced per-persist ack-latency histogram: columns
# S_LAT_HIST0 .. S_LAT_HIST0+N_LAT_BINS-1 of every per-tenant stats row.
# Bin 0 is the underflow bin (lat < LAT_HIST_MIN_NS); bin k >= 1 holds
# MIN*r^(k-1) <= lat < MIN*r^k with r = LAT_HIST_RATIO; the last bin is
# open above.
S_LAT_HIST0 = 15
N_LAT_BINS = 28
N_STATS = S_LAT_HIST0 + N_LAT_BINS

LAT_HIST_MIN_NS = 256.0
LAT_HIST_RATIO = float(np.sqrt(2.0))

# per-switch (hop) statistics row layout — ``MachineState.hop_stats`` is
# ``(Hmax, N_HOP_STATS)`` with row h = switch h+1 of the chain
H_FWD_SUM = 0        # total commit latency of packets written into this hop
H_FWD_CNT = 1        # packets committed into this hop's PB (alloc+coalesce)
H_COALESCES = 2      # arrivals absorbed into an existing Dirty entry
H_BYPASS = 3         # arrivals that found the hop full and travelled deeper
H_READ_HITS = 4      # reads served from this hop's PB (read forwarding)
N_HOP_STATS = 5

EMPTY = int(PBEState.EMPTY)
DIRTY = int(PBEState.DIRTY)
DRAIN = int(PBEState.DRAIN)


# Lower bound of bins 1..N_LAT_BINS-1 as the reference computes them.
# The reference bins with ``floor(2 * log2(max(lat, 1) / 256)) + 1``,
# and its ``log2`` is ``log(x) / log(2)`` in the JAX CPU backend, which
# puts 23 of the 27 edges 1 to 5 ulps off the exact ``256 * sqrt(2)**k``
# (2048.0 itself lands in bin 6, not 7).  torch's ``log`` rounds
# differently, and CUDA's is another implementation again, so the port
# bins by comparing against this table: the smallest f64 the reference
# puts in bin k+1, found by bisection over the f64 line
# (tests/test_torch_policy.py holds every edge +-3000 ulps against the
# reference).  The cell-scan kernel's wrapper hands it this table.
LAT_BIN_EDGES = tuple(float.fromhex(h) for h in (
    "0x1.0000000000000p+8", "0x1.6a09e667f3bcdp+8", "0x1.0000000000000p+9",
    "0x1.6a09e667f3bcdp+9", "0x1.fffffffffffffp+9", "0x1.6a09e667f3bccp+10",
    "0x1.0000000000001p+11", "0x1.6a09e667f3bcep+11", "0x1.ffffffffffffep+11",
    "0x1.6a09e667f3bcbp+12", "0x1.ffffffffffffep+12", "0x1.6a09e667f3bccp+13",
    "0x1.0000000000001p+14", "0x1.6a09e667f3bcep+14", "0x1.0000000000001p+15",
    "0x1.6a09e667f3bc9p+15", "0x1.ffffffffffffbp+15", "0x1.6a09e667f3bc9p+16",
    "0x1.ffffffffffffcp+16", "0x1.6a09e667f3bcap+17", "0x1.ffffffffffffcp+17",
    "0x1.6a09e667f3bcap+18", "0x1.ffffffffffffdp+18", "0x1.6a09e667f3bcbp+19",
    "0x1.0000000000001p+20", "0x1.6a09e667f3bc9p+20", "0x1.0000000000002p+21",
))


def lat_bin(lat_ns: torch.Tensor) -> torch.Tensor:
    """Histogram bin index of one persist latency (0-d f64 -> int64).

    ``#{k : lat >= LAT_BIN_EDGES[k]}``: the reference's
    ``clip(floor(2 * log2(max(lat, 1) / 256)) + 1, 0, N_LAT_BINS - 1)``,
    edge for edge.
    """
    edges = torch.tensor(LAT_BIN_EDGES, dtype=torch.float64,
                         device=lat_ns.device)
    return (lat_ns.unsqueeze(-1) >= edges).sum(-1)


def lat_hist_edges() -> np.ndarray:
    """Upper bin edges: ``edges[k]`` closes bin k (k = 0..N_LAT_BINS-2).

    Bin 0 spans (0, edges[0]); bin k spans [edges[k-1], edges[k]); the
    last bin is open above edges[-1].
    """
    return LAT_HIST_MIN_NS * LAT_HIST_RATIO ** np.arange(N_LAT_BINS - 1)


def lat_hist_percentile(hist, q: float) -> float:
    """Latency at quantile ``q`` (0..1) from one histogram row.

    Linear interpolation inside the covering bin (bin 0's lower edge is
    0; the open last bin extends one more ratio step).  NaN when the
    histogram is empty — a zero-traffic cell has *no* P99, not a 0 ns
    one (same convention as :func:`_mean`).
    """
    hist = np.asarray(hist, np.float64)
    total = float(hist.sum())
    if not total > 0:
        return float("nan")
    target = q * total
    c = np.cumsum(hist)
    b = min(int(np.searchsorted(c, target, side="left")), N_LAT_BINS - 1)
    edges = lat_hist_edges()
    lo = 0.0 if b == 0 else float(edges[b - 1])
    hi = (float(edges[b]) if b < N_LAT_BINS - 1
          else float(edges[-1] * LAT_HIST_RATIO))
    prev = float(c[b - 1]) if b > 0 else 0.0
    frac = (target - prev) / hist[b] if hist[b] > 0 else 1.0
    return lo + frac * (hi - lo)


def lat_hist_mean(hist) -> float:
    """Mean latency reconstructed from the histogram (geometric-mid
    representatives; agrees with S_PERSIST_SUM/CNT to bin resolution)."""
    hist = np.asarray(hist, np.float64)
    total = float(hist.sum())
    if not total > 0:
        return float("nan")
    edges = lat_hist_edges()
    half = np.sqrt(LAT_HIST_RATIO)
    reps = np.concatenate([
        [edges[0] / half],                       # underflow bin
        np.sqrt(edges[:-1] * edges[1:]),         # interior geometric mids
        [edges[-1] * half],                      # open last bin
    ])
    return float((hist * reps).sum() / total)


class MachineState(NamedTuple):
    """The scan carry: the entire machine at one instant.

    ``ver``/``aver``/``pm_ver`` are the durability-tracking arrays behind
    the crash model: per-PBE held version, per-address issue counter, and
    the newest version whose PM write-ack landed *before the crash point*.
    Addresses ``>= n_track`` are not tracked (A = max(n_track, 1)).

    Packing contract as in the reference: categorical columns
    (``state``/``owner`` and their deep-hop twins) are int8, barrier
    counts int16, tags and version counters int32, and every *time*
    column float64.
    """

    clock: torch.Tensor     # (C,)  f64  per-core clocks
    ptr: torch.Tensor       # (C,)  i32  per-core trace cursors
    tag: torch.Tensor       # (P,)  i32  TAT tags (P = max_pbe)
    state: torch.Tensor     # (P,)  i8   ST states (Empty/Dirty/Drain)
    lru: torch.Tensor       # (P,)  f64  LRU stamps
    dd: torch.Tensor        # (P,)  f64  in-flight drain-ack times
    ver: torch.Tensor       # (P,)  i32  per-entry persist version
    owner: torch.Tensor     # (P,)  i8   tenant that last wrote each entry
    aver: torch.Tensor      # (A,)  i32  per-address issued-version counter
    pm_ver: torch.Tensor    # (A,)  i32  newest version durable at PM
    pm_busy: torch.Tensor   # (B,)  f64  PM bank next-free times
    pbc_busy: torch.Tensor  # ()    f64  PBC next-free time
    blocked: torch.Tensor   # (C,)  bool blocked at barrier
    bcount: torch.Tensor    # (T,)  i16  per-tenant barrier arrival counts
    stats: torch.Tensor     # (T, N_STATS) f64 per-tenant accumulators
    # ---- deep-hop PB columns (the switch-level axis, D = n_deep_max) ----
    # Switch j+2 of the chain owns row j of each array; the flat columns
    # above stay the first (tenant-facing) switch, and D == 0 carries no
    # deep row at all (the depth-1 machine).
    dtag: torch.Tensor      # (D, P) i32  deep-hop TAT tags
    dstate: torch.Tensor    # (D, P) i8   deep-hop ST states
    dlru: torch.Tensor      # (D, P) f64  deep-hop LRU stamps
    ddd: torch.Tensor       # (D, P) f64  deep-hop in-flight forward-ack times
    dver: torch.Tensor      # (D, P) i32  deep-hop held persist versions
    downer: torch.Tensor    # (D, P) i8   owning tenant (recovery attribution)
    dwt: torch.Tensor       # (D, P) f64  commit time into this hop's cells
                            #             (crash gate + read visibility)
    hpbc: torch.Tensor      # (D,)   f64  deep-hop PBC next-free times
    hop_stats: torch.Tensor  # (D + 1, N_HOP_STATS) f64 per-switch telemetry
    # ---- fabric (fan-out) columns, NL = n_leaves_max when > 1 else 0 ----
    # Each leaf switch owns its own PBC front; NL == 0 (no multi-leaf
    # fabric in the grid) keeps the single ``pbc_busy`` clock.
    lpbc: torch.Tensor      # (NL,)  f64  per-leaf PBC next-free times


_STATE_DTYPES = dict(
    clock=torch.float64, ptr=torch.int32, tag=torch.int32,
    state=torch.int8, lru=torch.float64, dd=torch.float64,
    ver=torch.int32, owner=torch.int8, aver=torch.int32,
    pm_ver=torch.int32, pm_busy=torch.float64, pbc_busy=torch.float64,
    blocked=torch.bool, bcount=torch.int16, stats=torch.float64,
    dtag=torch.int32, dstate=torch.int8, dlru=torch.float64,
    ddd=torch.float64, dver=torch.int32, downer=torch.int8,
    dwt=torch.float64, hpbc=torch.float64, hop_stats=torch.float64,
    lpbc=torch.float64)
DEEP_FIELDS = ("dtag", "dstate", "dlru", "ddd", "dver", "downer", "dwt")


def init_state(n_cores: int, max_pbe: int, pm_banks: int,
               n_track: int = 0, n_tenants_max: int = 1,
               n_deep_max: int = 0, n_leaves_max: int = 1, *,
               device="cpu") -> MachineState:
    A = max(n_track, 1)
    T = max(n_tenants_max, 1)
    D = max(n_deep_max, 0)
    NL = n_leaves_max if n_leaves_max > 1 else 0
    if T > 127:
        raise ValueError("n_tenants_max exceeds the int8 owner column")
    shapes = dict(clock=(n_cores,), ptr=(n_cores,), tag=(max_pbe,),
                  state=(max_pbe,), lru=(max_pbe,), dd=(max_pbe,),
                  ver=(max_pbe,), owner=(max_pbe,), aver=(A,), pm_ver=(A,),
                  pm_busy=(pm_banks,), pbc_busy=(), blocked=(n_cores,),
                  bcount=(T,), stats=(T, N_STATS), hpbc=(D,),
                  hop_stats=(D + 1, N_HOP_STATS), lpbc=(NL,),
                  **{k: (D, max_pbe) for k in DEEP_FIELDS})
    st = {k: torch.zeros(shapes[k], dtype=_STATE_DTYPES[k], device=device)
          for k in MachineState._fields}
    st["tag"].fill_(-1)
    st["state"].fill_(EMPTY)
    st["dtag"].fill_(-1)
    st["dstate"].fill_(EMPTY)
    return MachineState(**st)


def state_from_numpy(*, device="cpu", **arrays) -> MachineState:
    """Build a :class:`MachineState` from numpy arrays (one per field),
    cast to the packing contract's dtypes.  The deep-hop and fabric
    columns may be left out: they then default to a chain-free,
    fabric-free machine (no deep row, no leaf clock)."""
    P = np.asarray(arrays.get("tag", ())).shape[0]
    defaults = {k: np.zeros((0, P)) for k in DEEP_FIELDS}
    defaults["hpbc"] = np.zeros((0,))
    defaults["lpbc"] = np.zeros((0,))
    arrays = {**defaults, **arrays}
    missing = set(MachineState._fields) - set(arrays)
    if missing:
        raise ValueError(f"state_from_numpy: missing fields {sorted(missing)}")
    return MachineState(**{
        k: torch.as_tensor(np.asarray(arrays[k]), device=device).to(
            _STATE_DTYPES[k]) for k in MachineState._fields})


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Aggregate metrics of one simulated run.

    The durability snapshot (``acked_persists``, ``durable_persists``,
    ``recovery_*``, ``durable_ver`` under address tracking) describes a
    power loss at ``crash_at_ns`` — or, when no crash is configured
    (``inf``), a hypothetical loss right after the last op: persists all
    acked/durable, and ``recovery_entries``/``recovery_ns`` report the
    Section V-D4 drain-all cost of the Dirty entries still buffered at
    the end of the run (zero for NoPB, which buffers nothing).

    Multi-tenant runs additionally carry the raw per-tenant stats matrix
    (``tenant_stats``, ``(n_tenants, N_STATS)``); the scalar fields above
    are always the sum over tenants (bit-exact for ``n_tenants == 1``),
    and :meth:`tenant_results` rebuilds one :class:`SimResult` per tenant
    for fairness analysis.  Mean latencies are ``NaN`` (not ``0.0``) when
    the corresponding count is zero — e.g. a run crashed at t=0 has no
    persist latency, not an infinitely fast one.
    """

    runtime_ns: float
    persist_lat_ns: float       # mean persist latency (fence round trip)
    read_lat_ns: float          # mean PM-read latency (from LLC)
    persists: int
    pm_reads: int
    read_hits: int              # reads served from the PB
    coalesces: int              # persists absorbed into a Dirty entry
    pm_writes: int              # write packets that reached the PM device
    stall_ns: float             # PBC time spent waiting for Empty entries
    pi_detours: int             # reads routed through the PI buffer
    victim_drains: int = 0      # persists that took the no-Empty victim path
    crash_at_ns: float = float("inf")
    acked_persists: int = 0     # acked at the core before the crash point
    durable_persists: int = 0   # payload survives crash + recovery
    recovery_entries: int = 0   # surviving Dirty/Drain PBEs re-drained
    recovery_ns: float = 0.0    # modeled drain-all latency of recovery
    durable_ver: "np.ndarray | None" = None  # (track_addrs,) i32 or None
    n_tenants: int = 1
    tenant_stats: "np.ndarray | None" = None  # (n_tenants, N_STATS) f64
    # Surviving Dirty/Drain PBEs per owning tenant at the crash instant
    # (row sum == recovery_entries); recovery latency stays global (the
    # drain-all pass is one shared burst over the whole PB).
    tenant_recovery: "np.ndarray | None" = None  # (n_tenants,) i64 or None
    # ---- switch-chain telemetry (pooling topologies) -------------------
    # ``hop_stats`` row h = switch h+1 (N_HOP_STATS columns: commit
    # latency sum/count, coalesces, bypasses, read hits); ``hop_recovery``
    # = surviving PBEs per switch at the crash instant (sum over hops ==
    # recovery_entries).  ``None`` for NoPB / depth-0 runs, which have no
    # persistent hops.
    n_hops: int = 0
    hop_stats: "np.ndarray | None" = None     # (n_hops, N_HOP_STATS) f64
    hop_recovery: "np.ndarray | None" = None  # (n_hops,) i64 or None
    # ---- serving / SLO telemetry (tail-latency distribution) -----------
    # ``lat_hist`` is the fixed-bin log-spaced per-persist ack-latency
    # histogram (N_LAT_BINS columns of the stats block, summed over
    # tenants here; per-tenant rows come back via tenant_results()).
    # ``slo_violations`` counts persists over DrainPolicy.latency_target_ns
    # (0 when no target is set — nothing is ever over +inf).
    lat_hist: "np.ndarray | None" = None      # (N_LAT_BINS,) f64 or None
    slo_violations: int = 0
    # ---- fabric telemetry (fan-out topologies) -------------------------
    # Surviving hop-1 PBEs per *leaf switch* at the crash instant (the
    # per-node attribution of a fan-out recovery; the spine's survivors
    # are ``hop_recovery[1]``).  ``None`` for chains / 1-leaf fabrics —
    # so a 1-leaf fabric's SimResult is field-identical to the chain's.
    leaf_recovery: "np.ndarray | None" = None  # (n_leaves,) i64 or None

    def persist_lat_pct(self, q: float) -> float:
        """Persist ack-latency quantile from the histogram (NaN when the
        cell saw no persists or carries no histogram)."""
        if self.lat_hist is None:
            return float("nan")
        return lat_hist_percentile(self.lat_hist, q)

    @property
    def persist_lat_p50(self) -> float:
        return self.persist_lat_pct(0.50)

    @property
    def persist_lat_p95(self) -> float:
        return self.persist_lat_pct(0.95)

    @property
    def persist_lat_p99(self) -> float:
        return self.persist_lat_pct(0.99)

    @property
    def read_hit_rate(self) -> float:
        return self.read_hits / max(self.pm_reads, 1)

    @property
    def coalesce_rate(self) -> float:
        return self.coalesces / max(self.persists, 1)

    @property
    def persisted_fraction(self) -> float:
        """Fraction of issued persists durable after crash + recovery."""
        return self.durable_persists / max(self.persists, 1)

    def hop_results(self) -> "list[dict]":
        """Per-switch view of the chain: one dict per hop.

        ``fwd_lat_ns`` (mean commit latency into the hop) follows the
        NaN convention: a hop that saw zero traffic has *no* mean
        latency, not a 0.0 ns one — figure scripts must skip NaN rows.
        """
        if self.hop_stats is None:
            return []
        recov = self.hop_recovery
        return [dict(
                    hop=h + 1,
                    fwd_lat_ns=_mean(row[H_FWD_SUM], row[H_FWD_CNT]),
                    commits=int(row[H_FWD_CNT]),
                    coalesces=int(row[H_COALESCES]),
                    bypasses=int(row[H_BYPASS]),
                    read_hits=int(row[H_READ_HITS]),
                    recovered=(int(recov[h]) if recov is not None else 0))
                for h, row in enumerate(np.asarray(self.hop_stats))]

    def tenant_results(self) -> "list[SimResult]":
        """Per-tenant view: one SimResult built from each stats row.

        ``runtime_ns`` and ``crash_at_ns`` are machine-global and shared.
        ``recovery_entries`` is attributed to the tenant *owning* each
        surviving PBE (``tenant_recovery``); the drain-all recovery
        latency stays global (one shared burst over the whole PB), so
        per-tenant ``recovery_ns`` is 0.  Each row's durable fraction is
        ``persisted_fraction`` as usual (per-tenant S_DURABLE counts).
        """
        if self.tenant_stats is None:
            return [self]
        recov = self.tenant_recovery
        return [result_from_stats(
                    self.runtime_ns, row, crash_at_ns=self.crash_at_ns,
                    recovery_entries=(int(recov[t]) if recov is not None
                                      else 0))
                for t, row in enumerate(np.asarray(self.tenant_stats))]


def _mean(total: float, count: float) -> float:
    """NaN for empty means: a cell with no persists/reads has *no* mean
    latency, not a 0.0 ns one (which plots as infinitely fast)."""
    return float(total / count) if count > 0 else float("nan")


def result_from_stats(runtime: float, stats: np.ndarray, *,
                      crash_at_ns: float = float("inf"),
                      recovery_entries: int = 0,
                      recovery_ns: float = 0.0,
                      durable_ver: "np.ndarray | None" = None,
                      n_tenants: int = 1,
                      tenant_recovery: "np.ndarray | None" = None,
                      n_hops: int = 0,
                      hop_stats: "np.ndarray | None" = None,
                      hop_recovery: "np.ndarray | None" = None,
                      n_leaves: int = 1,
                      leaf_recovery: "np.ndarray | None" = None
                      ) -> SimResult:
    """Build a SimResult from a stats vector or per-tenant stats matrix.

    ``stats`` is ``(N_STATS,)`` or ``(T, N_STATS)`` with ``T >=
    n_tenants``; rows beyond the config's tenant count are structural
    padding (shared static shape of a mixed-tenant grid) and provably
    all-zero, so the global sum over rows is bit-exact for ``T == 1``.
    """
    stats = np.asarray(stats, np.float64)
    if stats.ndim == 1:
        stats = stats[None, :]
    tot = stats.sum(axis=0)
    return SimResult(
        runtime_ns=runtime,
        persist_lat_ns=_mean(tot[S_PERSIST_SUM], tot[S_PERSIST_CNT]),
        read_lat_ns=_mean(tot[S_READ_SUM], tot[S_READ_CNT]),
        persists=int(tot[S_PERSIST_CNT]),
        pm_reads=int(tot[S_READ_CNT]),
        read_hits=int(tot[S_READ_HITS]),
        coalesces=int(tot[S_COALESCES]),
        pm_writes=int(tot[S_PM_WRITES]),
        stall_ns=float(tot[S_STALL_TIME]),
        pi_detours=int(tot[S_PI_DETOURS]),
        victim_drains=int(tot[S_VICTIM_CNT]),
        crash_at_ns=crash_at_ns,
        acked_persists=int(tot[S_ACKED]),
        durable_persists=int(tot[S_DURABLE]),
        recovery_entries=int(recovery_entries),
        recovery_ns=float(recovery_ns),
        durable_ver=durable_ver,
        n_tenants=n_tenants,
        tenant_stats=(stats[:n_tenants].copy() if n_tenants > 1 else None),
        tenant_recovery=(
            np.asarray(tenant_recovery, np.int64)[:n_tenants].copy()
            if n_tenants > 1 and tenant_recovery is not None else None),
        n_hops=n_hops,
        hop_stats=(np.asarray(hop_stats, np.float64)[:n_hops].copy()
                   if n_hops > 0 and hop_stats is not None else None),
        hop_recovery=(np.asarray(hop_recovery, np.int64)[:n_hops].copy()
                      if n_hops > 0 and hop_recovery is not None else None),
        lat_hist=tot[S_LAT_HIST0:S_LAT_HIST0 + N_LAT_BINS].copy(),
        slo_violations=int(tot[S_SLO_OVER]),
        leaf_recovery=(
            np.asarray(leaf_recovery, np.int64)[:n_leaves].copy()
            if n_leaves > 1 and leaf_recovery is not None else None),
    )


def _scalars_numpy(cfg: PCSConfig,
                        n_tenants_max: int | None = None,
                        n_deep_max: int = 0,
                        n_leaves_max: int = 1,
                        n_epochs_max: int = 1
                        ) -> Dict[str, "float | np.ndarray"]:
    """Lower one config to the dict of latency/policy scalars (numpy).

    The :class:`~repro.core.params.PBPolicy` on the config lowers here
    exactly like ``crash_at_ns`` / ``n_tenants`` do — to per-config scalars
    (victim mode, drain scope, keep-one-free knobs) and per-tenant
    per-tenant *vectors* of static length ``n_tenants_max`` (quotas, shares,
    tenant-scoped drain counts) — so a mixed {workload x scheme x
    policy} sweep stays one grid.  Rows past the config's own
    tenant count are padding: quota/share are INF (never over) and the
    drain counts fall back to the global values (never selected).

    Epoched schedules (DESIGN §7): when the grid-wide epoch bound
    ``n_epochs_max`` is > 1, every :data:`EPOCH_KEYS` entry gains a
    leading ``(E,)`` axis — row ``e`` is the knob resolved during epoch
    ``e`` (``params.resolve_epoch``; static knobs broadcast, schedules
    shorter than the bound hold their final value) — plus the config's
    shared ``epoch_bounds`` vector, INF-padded like ``leaf_base`` so a
    static config inside a scheduled grid never leaves epoch 0.  At the
    default bound of 1 the dict is byte-identical to the pre-schedule
    lowering (no ``epoch_bounds`` key, no epoch axes), so existing
    grids recompile nothing.
    """
    lat = cfg.latency
    pol = cfg.policy
    T = max(n_tenants_max or cfg.n_tenants, 1)
    E1 = max(n_epochs_max, 1)
    if cfg.n_epochs > E1:
        # silently clamping epochs would run a scheduled config under a
        # truncated schedule — right-shaped, quietly wrong results
        raise ValueError(
            f"config has {cfg.n_epochs} epochs but the grid's static "
            f"epoch bound is {E1} (n_epochs_max={n_epochs_max}); "
            "stack the grid with the true max epoch count")
    # per-hop chain lowering: row j describes switch j+2 (deep hops only;
    # hop 1 keeps the legacy scalars).  Rows past the config's own depth
    # lower to size 0 — structurally inactive in a mixed-depth grid.
    D1 = max(n_deep_max, 1)
    hop_pbes = cfg.hop_pbes
    if len(hop_pbes) - 1 > D1:
        # silently truncating deep rows would lower a depth-N chain as a
        # shallower one — right-shaped, quietly wrong results
        raise ValueError(
            f"config has {len(hop_pbes) - 1} deep hops but the grid's "
            f"static deep-row bound is {D1} (n_deep_max={n_deep_max}); "
            "stack the grid with the true max depth")
    deep_pbe = np.zeros((D1,), np.float64)
    # per-hop CACTI-scaled tag/data lookup latencies: a small deep hop
    # must not be billed at hop 1's capacity-scaled cost (rows past the
    # config's depth keep a finite filler; they are never selected)
    deep_tag = np.full((D1,), lat.pb_tag_ns, np.float64)
    deep_data = np.full((D1,), lat.pb_data_ns, np.float64)
    for j, n_h in enumerate(hop_pbes[1:]):
        deep_pbe[j] = float(n_h)
        deep_tag[j] = lat.pb_tag_ns_for(n_h)
        deep_data[j] = lat.pb_data_ns_for(n_h)
    # ---- fabric (fan-out) lowering -----------------------------------
    # The tree descriptor lowers to a scalar leaf count, a per-tenant
    # leaf map and the per-leaf slot-window bases.  Non-fabric configs
    # lower to the degenerate values (1 leaf, everyone on leaf 0, base
    # vector [0, INF, ...] so every slot maps to leaf 0, bp_high = INF),
    # which the leaf masks neutralize — a chain cell inside a fabric
    # grid runs the global hop-1 behaviour bit-exactly.
    NL1 = max(n_leaves_max, 1)
    fab = cfg.fabric
    if fab is not None and fab.n_leaves > NL1:
        raise ValueError(
            f"config has {fab.n_leaves} leaves but the grid's static "
            f"leaf bound is {NL1} (n_leaves_max={n_leaves_max}); "
            "stack the grid with the true max leaf count")
    leaf_base = np.full((NL1,), INF, np.float64)
    leaf_base[0] = 0.0
    bp_high = INF
    if fab is not None:
        for i, b in enumerate(fab.leaf_bases()):
            leaf_base[i] = float(b)
        if fab.bp_high is not None:
            bp_high = min(float(fab.bp_high), INF)

    def rows_at(epoch: int) -> Dict[str, "float | np.ndarray"]:
        """The epoch-dependent operand rows (every :data:`EPOCH_KEYS`
        entry), resolved during ``epoch``.  Epoch 0 of a static config
        reproduces the pre-schedule lowering bit-for-bit."""
        pol_e = resolve_epoch(pol, epoch)
        thr_cnt = float(threshold_count(cfg.n_pbe, pol_e.drain.threshold))
        pre_cnt = float(preset_count(cfg.n_pbe, pol_e.drain.preset))
        deep_thr = np.ones((D1,), np.float64)
        deep_pre = np.zeros((D1,), np.float64)
        for j, (thr_h, pre_h) in enumerate(
                hop_drain_counts(pol_e, hop_pbes)[1:]):
            deep_thr[j], deep_pre[j] = float(thr_h), float(pre_h)
        leaf_of_t = np.zeros((T,), np.float64)
        if fab is not None:
            for t, lf in enumerate(epoch_value(fab.placement, epoch)):
                leaf_of_t[t] = float(lf)
        quota = np.full((T,), INF, np.float64)
        share = np.full((T,), INF, np.float64)
        t_thr = np.full((T,), thr_cnt, np.float64)
        t_pre = np.full((T,), pre_cnt, np.float64)
        for t, (thr, pre) in enumerate(
                tenant_drain_counts(pol_e, cfg.n_pbe, cfg.n_tenants)):
            quota[t] = min(pol_e.alloc.quota_of(t), INF)
            share[t] = min(pol_e.alloc.share_of(t, cfg.n_pbe,
                                                cfg.n_tenants), INF)
            t_thr[t], t_pre[t] = float(thr), float(pre)
        lt = pol_e.drain.latency_target_ns
        return dict(
            threshold_count=thr_cnt,
            preset_count=pre_cnt,
            quota=quota,
            share=share,
            t_threshold=t_thr,
            t_preset=t_pre,
            deep_thr=deep_thr,        # (D1,) switch j+2's threshold count
            deep_pre=deep_pre,        # (D1,) switch j+2's preset count
            # None lowers to INF: no persist latency ever exceeds it,
            # the running-over counter stays 0 and the tight predicate
            # is always false — bit-exact with the default policy.
            lat_target=min(lt if lt is not None else INF, INF),
            leaf_of_t=leaf_of_t,      # (T,)   tenant t's leaf switch
        )

    ep0 = rows_at(0)
    sc = dict(
        n_pbe=float(cfg.n_pbe),
        n_tenants=float(cfg.n_tenants),
        threshold_count=ep0["threshold_count"],
        preset_count=ep0["preset_count"],
        # declarative PBPolicy lowering (scalars + per-tenant vectors)
        quota=ep0["quota"],
        share=ep0["share"],
        t_threshold=ep0["t_threshold"],
        t_preset=ep0["t_preset"],
        drain_scope=1.0 if pol.drain.per_tenant else 0.0,
        victim_weighted=1.0 if pol.alloc.victim == "weighted" else 0.0,
        low_water=float(pol.drain.low_water_drains),
        empty_slack=float(pol.drain.empty_slack),
        tag_ns=lat.pb_tag_ns_for(cfg.n_pbe),
        data_ns=lat.pb_data_ns_for(cfg.n_pbe),
        pbc_proc_ns=lat.pbc_proc_ns,
        pbc_occ_ns=lat.pbc_occ_ns,
        pbc_read_ns=lat.pbc_read_ns,
        pbc_read_occ=lat.pbc_read_occ_ns,
        nvm_read=lat.nvm_read_ns,
        nvm_write=lat.nvm_write_ns,
        nvm_r_occ=lat.nvm_read_occ_ns,
        nvm_w_occ=lat.nvm_write_occ_ns,
        dram_ns=lat.dram_ns,
        fwd_margin=lat.fwd_margin_ns,
        switch_pipe=lat.switch_pipe_ns,
        ow_cpu_pm=lat.oneway_cpu_pm(cfg.n_switches),
        # the path helpers are total in the depth (0 included), so no
        # special-casing: at depth 0 (NOPB direct attach — PCSConfig
        # rejects a PB with no switch to live in) the "first hop" is the
        # CPU link and the drain path is 0, keeping the never-selected
        # PB branch finite.
        ow_cpu_sw1=lat.oneway_cpu_sw1(cfg.n_switches),
        ow_sw1_pm=lat.oneway_sw1_pm(cfg.n_switches),
        # ---- switch-chain lowering (per-switch persistent buffers) ----
        n_switches=float(cfg.n_switches),
        hop_ns=lat.hop_ns(),
        link_ns=lat.link_ns,
        deep_pbe=deep_pbe,        # (D1,) switch j+2's PBE capacity
        deep_thr=ep0["deep_thr"],
        deep_pre=ep0["deep_pre"],
        deep_tag=deep_tag,        # (D1,) switch j+2's tag lookup latency
        deep_data=deep_data,      # (D1,) switch j+2's data access latency
        # ---- fabric lowering (fan-out trees over the chain) -----------
        n_leaves=float(fab.n_leaves) if fab is not None else 1.0,
        leaf_of_t=ep0["leaf_of_t"],
        leaf_base=leaf_base,      # (NL1,) first hop-1 slot of each leaf
        bp_high=bp_high,          # spine Dirty occupancy that defers
                                  # leaf drain-down (INF = never)
        # ---- serving-SLO drain tightening (DrainPolicy.latency_target_ns)
        lat_target=ep0["lat_target"],
        lat_tol=float(pol.drain.latency_tol),
        # power-loss instant; INF (the engine's finite infinity) = never
        crash_at=min(cfg.crash_at_ns, INF),
    )
    if E1 == 1:
        # static grid: byte-identical to the pre-schedule lowering — no
        # epoch axes, no epoch_bounds operand, nothing recompiles
        return sc
    # ---- epoched-schedule lowering (DESIGN §7) -----------------------
    # Every EPOCH_KEYS entry gains a leading (E,) axis; the config's
    # shared boundary vector is INF-padded to the grid bound, so a
    # static (or shorter-schedule) config can never be selected past
    # its real epochs — INF <= t_issue is false for every finite clock.
    rows = [ep0] + [rows_at(e) for e in range(1, E1)]
    for k in EPOCH_KEYS:
        sc[k] = np.stack([np.asarray(r[k], np.float64) for r in rows])
    eb = np.full((E1 - 1,), INF, np.float64)
    for i, b in enumerate(cfg.epoch_boundaries):
        eb[i] = min(float(b), INF)
    sc.update(
        epoch_bounds=eb,          # (E-1,) shared epoch-boundary vector
    )
    return sc


def epoch_rows(sc: dict, e: int) -> dict:
    """``sc`` with every :data:`EPOCH_KEYS` row indexed at epoch ``e``
    and ``epoch_bounds`` left out; a schedule-free ``sc`` (no
    ``epoch_bounds`` key) as it is."""
    if "epoch_bounds" not in sc:
        return sc
    return {k: (v[e] if k in EPOCH_KEYS else v) for k, v in sc.items()
            if k != "epoch_bounds"}


def scalars_from_config(cfg: PCSConfig,
                        n_tenants_max: int | None = None,
                        n_deep_max: int = 0,
                        n_leaves_max: int = 1,
                        n_epochs_max: int = 1, *,
                        device="cpu") -> Dict[str, torch.Tensor]:
    """Lower one config to a dict of f64 tensors on ``device``.

    Same keys, shapes and values as the reference's
    ``scalars_from_config`` (scalars become 0-d tensors, per-tenant /
    per-hop / per-epoch rows 1-d or 2-d tensors).
    """
    sc = _scalars_numpy(cfg, n_tenants_max, n_deep_max, n_leaves_max,
                        n_epochs_max)
    return {k: torch.as_tensor(np.asarray(v, np.float64), device=device)
            for k, v in sc.items()}
