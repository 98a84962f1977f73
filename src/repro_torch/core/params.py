"""Parameters for the Persistent CXL Switch (PCS) model.

PyTorch-port copy of ``repro.core.params`` (the JAX package's jax-free
parameter leaf): the port keeps its own copy so that it never imports
the reference package.  :func:`config_from_fields` rebuilds a config
from ``dataclasses.asdict`` of a reference config.

Latency numbers follow the paper's experimental setup (Table I) where the
paper gives them directly (NVM 100ns read / 200ns write, PB tag/data access
from CACTI at 22nm, 4-stage switch pipeline with the Pond latency profile)
and are otherwise calibrated so the *composition* matches the paper's cited
envelope: local DRAM ~85ns, CXL-attached memory +170..400ns, Fig-1 persist
ratio ~2.5x for a single switch once fence serialization and PM queueing are
included.

Everything is expressed in nanoseconds as float64.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Optional, Tuple


class Scheme(enum.IntEnum):
    """Persistence scheme evaluated in the paper (Section VI).

    The integer values are load-bearing: the timed engine and the
    cell-scan kernel dispatch their persist/read handlers on a per-cell
    scheme scalar carrying exactly these values (see
    ``core.engine.handlers``).
    """

    NOPB = 0   # volatile switch: every persist round-trips to PM
    PB = 1     # persistent buffer, drain-immediately (ack at switch)
    PB_RF = 2  # persistent buffer + read forwarding / write coalescing


# Canonical scalar drain policy (paper Section V-D1).  This module is the
# dependency leaf (no torch), so the untimed oracle and the checkpoint tier
# read the shared policy from here; ``core.engine.policy`` re-exports it
# next to the tensor twin used by the timed engine.
DEFAULT_DRAIN_THRESHOLD = 0.8  # start draining above this fill fraction
DEFAULT_DRAIN_PRESET = 0.6     # drain down to this fill fraction

# Scheme <-> wire-name mapping shared with the checkpoint tier / CLIs.
SCHEME_NAMES = {s: s.name.lower() for s in Scheme}


def threshold_count(n_pbe: "int | float",
                    threshold: float = DEFAULT_DRAIN_THRESHOLD) -> int:
    """Entry count at which the PB_RF drain-down engages.

    ``n_pbe`` may be fractional: a tenant-scoped policy anchors the
    fraction on the tenant's quota or its fair share ``n_pbe / T``.
    """
    return max(1, int(math.ceil(threshold * n_pbe)))


def preset_count(n_pbe: "int | float",
                 preset: float = DEFAULT_DRAIN_PRESET) -> int:
    """Entry count the PB_RF drain-down drains down to."""
    return max(0, int(math.floor(preset * n_pbe)))


# PB_RF keep-one-free heuristic: when the Empty pool is down to
# RF_EMPTY_SLACK entries, drain up to RF_LOW_WATER_DRAINS LRU Dirty
# entries pre-emptively so the PI front cannot cascade into head-of-line
# victim stalls.
RF_EMPTY_SLACK = 1
RF_LOW_WATER_DRAINS = 2

# Macro-stepping window bound (engine.macro): the trace-time pre-pass
# (``core.traces.plan_runs``) caps eligible homogeneous runs at this many
# ops, and the engine's guarded macro-step unrolls exactly this many
# iterations.  The grid stacker pads every trace row by MACRO_KMAX extra
# slots so the engine's dynamic window slice never reads out of bounds.
MACRO_KMAX = 8


def rf_drain_count(dirty: int, empty: int, threshold: int, preset: int,
                   low_water: int = RF_LOW_WATER_DRAINS,
                   empty_slack: int = RF_EMPTY_SLACK) -> int:
    """How many LRU Dirty entries the PB_RF policy drains right now.

    Pure-scalar twin of ``engine.policy.drain_threshold_preset``'s ``k``
    (same sub-expressions, Python ints instead of f64 tensors).  The
    untimed oracle calls this directly; the engine-vs-oracle
    cross-validation test (tests/test_engine_oracle.py) is the drift
    guard between the two forms.  Under a tenant-scoped
    :class:`DrainPolicy` the caller passes the *tenant's* Dirty count
    and the *global* Empty count (the keep-one-free heuristic protects
    the shared PI front, but may only drain the tenant's own entries).
    """
    k_thresh = dirty - preset if dirty >= threshold else 0
    k_low = min(low_water, dirty) if empty <= empty_slack else 0
    return max(k_thresh, k_low)


# ---------------------------------------------------------------------------
# Epoched schedules (DESIGN.md §7)
# ---------------------------------------------------------------------------
# A production pool serves *shifting* load: tenants heat up, leaves
# saturate, and a quota/placement chosen at t=0 leaves tail latency on
# the table.  ``Schedule`` makes a sweepable knob *piecewise-constant in
# time*: ``values[e]`` is active during epoch ``e``, and the active
# epoch at time ``t`` is ``#{b in boundaries_ns : b <= t}`` — resolved
# from each op's issue clock in the timed engine (crash-style gating,
# ``engine.step``) and from the replay clock in the untimed oracle
# (``PersistentBuffer.epoch_at``).  Every scheduled knob of one config
# must share ONE boundary vector (the engine lowers a single epoch
# axis); ``PCSConfig.epoch_boundaries`` enforces it.

@dataclasses.dataclass(frozen=True)
class Schedule:
    """Piecewise-constant time schedule for a sweepable config knob.

    ``len(values) == len(boundaries_ns) + 1``: ``values[0]`` is active
    from t=0 until ``boundaries_ns[0]``, ``values[e]`` from
    ``boundaries_ns[e-1]`` (inclusive) until ``boundaries_ns[e]``.
    Accepted by ``DrainPolicy.threshold`` / ``preset`` /
    ``latency_target_ns``, ``AllocPolicy.tenant_quota`` and
    ``FabricTopology.placement``; lowers to ``(E,)`` / ``(E, T)``
    operand rows plus one shared ``epoch_bounds`` vector
    (``engine.state.scalars_from_config``), so a mixed
    {static x scheduled} sweep stays ONE grid and a single-epoch
    schedule is bit-identical to the plain value.
    """

    boundaries_ns: Tuple[float, ...]
    values: Tuple[object, ...]

    def __post_init__(self) -> None:
        b = tuple(float(x) for x in self.boundaries_ns)
        v = tuple(self.values)
        if len(v) != len(b) + 1:
            raise ValueError(
                f"Schedule needs exactly one value per epoch: "
                f"{len(b)} boundaries define {len(b) + 1} epochs, "
                f"got {len(v)} values")
        if any(not math.isfinite(x) or x <= 0.0 for x in b):
            raise ValueError(
                f"Schedule boundaries must be positive finite ns; got {b}")
        if any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(
                f"Schedule boundaries must be strictly increasing; got {b}")
        object.__setattr__(self, "boundaries_ns", b)
        object.__setattr__(self, "values", v)

    @property
    def n_epochs(self) -> int:
        return len(self.values)

    def epoch_of(self, t_ns: float) -> int:
        """Active epoch at ``t_ns`` (scalar twin of the engine's
        ``sum(epoch_bounds <= t_issue)`` gate)."""
        return epoch_index(self.boundaries_ns, t_ns)

    def value_at(self, t_ns: float):
        return self.values[self.epoch_of(t_ns)]


def epoch_index(boundaries: Tuple[float, ...], x: float) -> int:
    """Active epoch at position ``x``: ``#{b : b <= x}``.

    Single home of the boundary comparison (``<=``, not ``<``) — the
    engine's gate, the oracle's replay clock and the checkpoint
    tier's persist-index schedule all use this rule, so the layers
    cannot drift on whether a boundary instant belongs to the new epoch
    (it does, exactly like ``crash_at`` gating).
    """
    return sum(1 for b in boundaries if b <= x)


def epoch_value(v, epoch: int):
    """Value of knob ``v`` during ``epoch``; plain values pass through.

    Epochs past the schedule's last value clamp to it (a config with
    fewer epochs than the grid-wide bound holds its final value).
    """
    if isinstance(v, Schedule):
        return v.values[min(int(epoch), len(v.values) - 1)]
    return v


def n_epochs_of(*knobs) -> int:
    """Epoch count implied by the scheduled knobs (1 = all static)."""
    return max((v.n_epochs for v in knobs if isinstance(v, Schedule)),
               default=1)


def shared_boundaries(*knobs) -> Tuple[float, ...]:
    """The ONE epoch-boundary vector shared by every scheduled knob.

    Raises when two schedules disagree — the engine lowers a single
    epoch axis per config, so every ``Schedule`` in one ``PCSConfig``
    must carry identical ``boundaries_ns``.  Returns ``()`` when
    nothing is scheduled.
    """
    bounds = None
    for v in knobs:
        if not isinstance(v, Schedule):
            continue
        if bounds is None:
            bounds = v.boundaries_ns
        elif v.boundaries_ns != bounds:
            raise ValueError(
                f"scheduled knobs disagree on epoch boundaries: "
                f"{v.boundaries_ns} vs {bounds}; every Schedule in one "
                "config must share one boundary vector (the engine "
                "lowers a single shared epoch axis)")
    return bounds if bounds is not None else ()


# ---------------------------------------------------------------------------
# Declarative persistence-policy API (QoS / drain policy, ROADMAP fairness)
# ---------------------------------------------------------------------------
# ``PBPolicy`` replaces the two global floats that used to live on
# ``PCSConfig`` plus the constants baked into this module: every knob of
# the PB's drain-down and allocation behaviour is a field of a frozen
# dataclass, and every field lowers to a per-config scalar or a per-tenant
# vector (``engine.state.scalars_from_config``) exactly like
# ``crash_at_ns`` and ``n_tenants`` do — so a {workload x scheme x
# policy} sweep stays ONE grid.  The untimed oracle
# (``core.semantics``) and the checkpoint tier (``persistence.manager``)
# consume the *same* policy objects through their pure-scalar helpers.

@dataclasses.dataclass(frozen=True)
class DrainPolicy:
    """PB_RF drain-down policy (paper Section V-D1) as data.

    ``threshold`` / ``preset`` are fill fractions; ``per_tenant=True``
    scopes the drain-down to the issuing tenant: its Dirty count is
    compared against *its own* threshold (anchored on its quota, or its
    fair share ``n_pbe / T`` when no quota is set) and only *its own*
    LRU Dirty entries are drained — a noisy tenant's drain-down can no
    longer evict a quiet tenant's Dirty entries.  ``low_water_drains`` /
    ``empty_slack`` are the keep-one-free heuristic knobs that used to
    be module constants (``RF_LOW_WATER_DRAINS`` / ``RF_EMPTY_SLACK``).

    ``latency_target_ns`` is the serving-SLO closing of the loop: when
    set, each tenant tracks the running fraction of its persists whose
    ack latency exceeded the target, and while that fraction exceeds
    ``latency_tol`` the tenant's drain-down runs *tight* — threshold 1,
    preset 0 (drain everything ASAP), so a backed-up PB empties instead
    of queueing the next tail persist behind a drain burst.  The running
    fraction includes the persist being decided (a first persist over
    target immediately tightens).  Lowers to two per-config scalars
    (``lat_target`` / ``lat_tol``); ``None`` lowers to the engine's
    finite infinity and is bit-exact with the default policy.
    """

    threshold: float = DEFAULT_DRAIN_THRESHOLD
    preset: float = DEFAULT_DRAIN_PRESET
    per_tenant: bool = False
    low_water_drains: int = RF_LOW_WATER_DRAINS
    empty_slack: int = RF_EMPTY_SLACK
    latency_target_ns: Optional[float] = None
    latency_tol: float = 0.05

    def __post_init__(self) -> None:
        # ``threshold`` / ``preset`` / ``latency_target_ns`` accept a
        # :class:`Schedule` (DESIGN §7): validation then runs per epoch
        # with the same rules a plain value obeys.
        for e in range(n_epochs_of(self.threshold, self.preset)):
            thr = epoch_value(self.threshold, e)
            pre = epoch_value(self.preset, e)
            if not (0.0 < pre <= thr <= 1.0):
                raise ValueError("require 0 < preset <= threshold <= 1")
        if self.low_water_drains < 0 or self.empty_slack < 0:
            raise ValueError("low_water_drains / empty_slack must be >= 0")
        for e in range(n_epochs_of(self.latency_target_ns)):
            lt = epoch_value(self.latency_target_ns, e)
            if lt is not None and not lt > 0:
                raise ValueError("latency_target_ns must be > 0 (or None)")
        if not 0.0 <= self.latency_tol < 1.0:
            raise ValueError("latency_tol must be in [0, 1)")


@dataclasses.dataclass(frozen=True)
class AllocPolicy:
    """PBE allocation / victim-selection policy.

    ``tenant_quota`` caps each tenant's live (Dirty+Drain) PBE
    occupancy: a tenant at its quota may not take an Empty slot — it
    must victim-drain (and reuse) one of its *own* LRU Dirty entries,
    or wait for its own earliest in-flight drain.  Write coalescing is
    exempt (it reuses an existing entry; a cross-tenant coalesce
    takeover can therefore push a tenant transiently over quota — the
    next allocation self-corrects).  ``victim="weighted"`` makes the
    shared no-Empty victim path prefer the LRU Dirty entry of a tenant
    at/over its share (its quota, or ``n_pbe / T`` without quotas),
    falling back to the global LRU Dirty entry.
    """

    victim: str = "lru"                              # "lru" | "weighted"
    tenant_quota: Optional[Tuple[int, ...]] = None   # live-PBE cap / tenant

    def __post_init__(self) -> None:
        if self.victim not in ("lru", "weighted"):
            raise ValueError(f"unknown victim policy {self.victim!r}; "
                             "have 'lru' | 'weighted'")
        if isinstance(self.tenant_quota, Schedule):
            # epoched quota (DESIGN §7): coerce/validate every epoch's
            # tuple with the same rules a plain quota obeys (``None``
            # epochs = uncapped); consumers resolve via
            # ``resolve_epoch`` before calling quota_of / share_of
            sch = self.tenant_quota
            vals = []
            for q0 in sch.values:
                if q0 is None:
                    vals.append(None)
                    continue
                q = tuple(int(x) for x in q0)
                if not q or any(x < 1 for x in q):
                    raise ValueError("tenant_quota entries must be >= 1")
                vals.append(q)
            object.__setattr__(self, "tenant_quota",
                               dataclasses.replace(sch, values=tuple(vals)))
        elif self.tenant_quota is not None:
            q = tuple(int(x) for x in self.tenant_quota)
            if not q or any(x < 1 for x in q):
                raise ValueError("tenant_quota entries must be >= 1")
            object.__setattr__(self, "tenant_quota", q)

    def quota_of(self, tenant: int) -> float:
        """Occupancy cap for ``tenant`` (``inf`` = unlimited).

        Requires an epoch-resolved policy (``resolve_epoch``) when the
        quota is scheduled — a ``Schedule`` is not subscriptable.
        """
        if self.tenant_quota is None:
            return math.inf
        return float(self.tenant_quota[tenant])

    def share_of(self, tenant: int, n_pbe: int, n_tenants: int) -> float:
        """Over-share boundary of the weighted victim policy."""
        if self.tenant_quota is not None:
            return float(self.tenant_quota[tenant])
        return n_pbe / max(n_tenants, 1)


@dataclasses.dataclass(frozen=True)
class PBPolicy:
    """The full persistence policy: drain-down x allocation.

    Composes with :class:`PCSConfig` (``PCSConfig(policy=...)``); the
    legacy ``drain_threshold`` / ``drain_preset`` floats forward into a
    default ``PBPolicy`` (compat shim, see DESIGN.md "Policy API").
    """

    drain: DrainPolicy = dataclasses.field(default_factory=DrainPolicy)
    alloc: AllocPolicy = dataclasses.field(default_factory=AllocPolicy)

    def validate_for(self, n_pbe: int, n_tenants: int) -> None:
        """Config-dependent validation, called by PCSConfig.__post_init__.

        A scheduled quota validates every epoch's tuple — each epoch
        must be a quota the shared buffer could honour on its own.
        """
        for e in range(n_epochs_of(self.alloc.tenant_quota)):
            q = epoch_value(self.alloc.tenant_quota, e)
            if q is None:
                continue
            if len(q) != n_tenants:
                raise ValueError(
                    f"tenant_quota has {len(q)} entries for "
                    f"n_tenants={n_tenants}; need exactly one per tenant")
            if sum(q) > n_pbe:
                raise ValueError(
                    f"tenant quotas sum to {sum(q)} > n_pbe={n_pbe}: the "
                    "shared buffer cannot honour them")


def resolve_epoch(policy: PBPolicy, epoch: int) -> PBPolicy:
    """Epoch-resolved twin of ``policy``: every scheduled field collapsed
    to its value during ``epoch`` (plain fields pass through untouched).

    Single home of the policy epoch-resolution rule: the engine lowering
    (``engine.state.scalars_from_config``) resolves each epoch's operand
    row through it, the untimed oracle (``semantics.PersistentBuffer
    .set_epoch``) re-derives its cached policy values through it, and
    the checkpoint tier (``persistence.manager``) resolves its
    persist-indexed quota steps through it — so the three layers cannot
    drift on what a schedule means.  Re-runs the dataclass validation,
    so every resolved epoch is a policy that would have been legal
    standalone.
    """
    d, a = policy.drain, policy.alloc
    return PBPolicy(
        drain=DrainPolicy(
            threshold=epoch_value(d.threshold, epoch),
            preset=epoch_value(d.preset, epoch),
            per_tenant=d.per_tenant,
            low_water_drains=d.low_water_drains,
            empty_slack=d.empty_slack,
            latency_target_ns=epoch_value(d.latency_target_ns, epoch),
            latency_tol=d.latency_tol),
        alloc=AllocPolicy(
            victim=a.victim,
            tenant_quota=epoch_value(a.tenant_quota, epoch)))


def hop_drain_counts(policy: PBPolicy,
                     hop_pbes: Tuple[int, ...]) -> List[Tuple[int, int]]:
    """Per-hop (threshold_count, preset_count) of a chained PB_RF drain.

    Hop ``h``'s drain-down anchors on *its own* PBE capacity with the
    policy's global fill fractions.  Single home of the per-hop count
    rule: the engine lowering (``engine.state.scalars_from_config``) and
    the untimed oracle (``semantics.PersistentBuffer``) both call it, so
    the tensor and scalar forms cannot drift.  Deep hops (h >= 2) run
    the pure threshold/preset rule — the keep-one-free low-water
    heuristic stays at hop 1, where it protects the tenant-facing PI
    front.
    """
    return [(threshold_count(n, policy.drain.threshold),
             preset_count(n, policy.drain.preset)) for n in hop_pbes]


def tenant_drain_counts(policy: PBPolicy, n_pbe: int,
                        n_tenants: int) -> List[Tuple[int, int]]:
    """Per-tenant (threshold_count, preset_count) of a tenant-scoped drain.

    Tenant ``t``'s drain-down anchors on its quota when one is set, else
    on its fair share ``n_pbe / T``.  This is the single home of the
    per-tenant count rule: the engine lowering
    (``engine.state.scalars_from_config``) and the untimed oracle
    (``semantics.PersistentBuffer``) both call it, so the tensor and
    scalar forms cannot drift.
    """
    out = []
    for t in range(n_tenants):
        base = policy.alloc.quota_of(t)
        if not math.isfinite(base):
            base = n_pbe / max(n_tenants, 1)
        out.append((threshold_count(base, policy.drain.threshold),
                    preset_count(base, policy.drain.preset)))
    return out


@dataclasses.dataclass(frozen=True)
class FabricTopology:
    """Two-level fan-out fabric: leaf switches sharing one spine.

    Real CXL pooling deployments are trees, not chains: many leaf
    switches (each the ack point for its own hosts) fan into a shared
    spine switch in front of the PM banks.  The descriptor is frozen
    data, and — like :class:`PBPolicy` and ``crash_at_ns`` — lowers to
    per-config scalars/vectors (``engine.state.scalars_from_config``):
    ``n_leaves`` + the per-tenant ``placement`` map + the per-leaf slot
    partition + ``bp_high`` all reach the compiled program as operands,
    so a {workload x scheme x topology x placement} sweep stays ONE
    grid; only the grid-wide ``n_leaves`` maximum is a static shape.

    ``leaf_pbe[i]`` is leaf ``i``'s PBE capacity; the leaves partition
    one hop-1 slot axis (leaf ``i`` owns the contiguous slot window
    starting at ``leaf_bases()[i]``), so the 1-leaf fabric is *exactly*
    the linear chain.  ``spine_pbe`` is the spine switch's PB capacity
    (hop 2 of the lowered chain).  ``placement[t]`` is tenant ``t``'s
    leaf: a tenant's persists allocate/coalesce/victim/drain only
    within its own leaf's slot window, and drains from all leaves merge
    into the spine's occupancy-serialized FIFO (fan-in contention).

    ``bp_high`` is the backpressure-aware drain-scheduling knob: when
    the spine PB's live (Dirty) occupancy is at/above ``bp_high``
    entries, every leaf's PB_RF threshold/low-water drain-down is
    *deferred* (``spine_defer``) — leaves hold their Dirty entries
    instead of piling more fan-in onto a congested spine.  Victim
    drains (forward progress) and the PB scheme's drain-immediate are
    exempt.  ``None`` lowers to the engine's finite infinity (never
    defer) and requires nothing; a finite ``bp_high`` requires
    ``n_leaves >= 2`` so a 1-leaf fabric is bit-identical to the chain
    in every grid composition.
    """

    n_leaves: int = 1
    leaf_pbe: Tuple[int, ...] = (16,)
    spine_pbe: int = 16
    placement: Tuple[int, ...] = (0,)   # tenant -> leaf
    bp_high: Optional[float] = None     # spine Dirty occupancy, entries

    def __post_init__(self) -> None:
        if self.n_leaves < 1:
            raise ValueError("n_leaves must be >= 1")
        q = tuple(int(x) for x in self.leaf_pbe)
        if len(q) != self.n_leaves:
            raise ValueError(
                f"leaf_pbe has {len(q)} entries for "
                f"n_leaves={self.n_leaves}; need one per leaf")
        if any(x < 1 for x in q):
            raise ValueError("leaf_pbe entries must be >= 1")
        object.__setattr__(self, "leaf_pbe", q)
        if self.spine_pbe < 1:
            raise ValueError("spine_pbe must be >= 1")
        if isinstance(self.placement, Schedule):
            # epoched placement (DESIGN §7) = mid-run tenant migration:
            # each epoch's map validates like a plain placement, and
            # every epoch must place every tenant on a real leaf
            sch = self.placement
            vals = []
            for p0 in sch.values:
                p = tuple(int(x) for x in p0)
                if not p:
                    raise ValueError(
                        "placement needs at least one tenant entry")
                if any(not 0 <= x < self.n_leaves for x in p):
                    raise ValueError(
                        f"placement entries must be leaf ids in [0, "
                        f"{self.n_leaves}); got {p}")
                vals.append(p)
            object.__setattr__(self, "placement",
                               dataclasses.replace(sch, values=tuple(vals)))
        else:
            p = tuple(int(x) for x in self.placement)
            if not p:
                raise ValueError("placement needs at least one tenant entry")
            if any(not 0 <= x < self.n_leaves for x in p):
                raise ValueError(
                    f"placement entries must be leaf ids in [0, "
                    f"{self.n_leaves}); got {p}")
            object.__setattr__(self, "placement", p)
        if self.bp_high is not None:
            if not self.bp_high > 0:
                raise ValueError("bp_high must be > 0 (or None)")
            if self.n_leaves < 2:
                # a 1-leaf fabric must be bit-identical to the linear
                # chain regardless of what else shares the grid
                raise ValueError(
                    "bp_high requires n_leaves >= 2: backpressure on a "
                    "1-leaf fabric would diverge from the chain path")

    def leaf_bases(self) -> Tuple[int, ...]:
        """First hop-1 slot of each leaf's window (cumulative offsets)."""
        bases, acc = [], 0
        for n in self.leaf_pbe:
            bases.append(acc)
            acc += n
        return tuple(bases)


def spine_defer(spine_live, bp_high):
    """Backpressure contract: leaf threshold/low-water drain-down defers
    while the spine PB's live (Dirty) occupancy has reached ``bp_high``.

    Single home of the comparison — the timed engine calls it with
    f64 tensors, the untimed oracle with Python scalars — so
    the two layers cannot drift on the boundary (``>=``, not ``>``).
    """
    return spine_live >= bp_high


class PBEState(enum.IntEnum):
    """Persistent Buffer Entry states (Section V-A)."""

    EMPTY = 0  # drained & acknowledged by PM; slot reusable
    DIRTY = 1  # latest & only copy lives in the PB
    DRAIN = 2  # a copy is in flight to PM; entry pinned until PM ack


class Op(enum.IntEnum):
    """Trace operation kinds consumed by the simulator."""

    COMPUTE = 0     # advance core clock by `gap` ns (no memory traffic)
    DRAM_READ = 1   # volatile read (blocking, local DRAM latency)
    DRAM_WRITE = 2  # volatile write (posted, ~free)
    PM_READ = 3     # load of persistent heap data (blocking, LLC miss)
    PERSIST = 4     # clflush+mfence pair: blocking store to PM
    BARRIER = 5     # synchronize all cores (Splash-4 phase barriers)


@dataclasses.dataclass(frozen=True)
class LatencyProfile:
    """One-way / device latencies (ns). See module docstring for calibration."""

    cpu_link_ns: float = 42.5     # CPU LLC <-> local controller / root port
    link_ns: float = 50.0         # one CXL link segment, one way
    switch_pipe_ns: float = 50.0  # 4-stage switch pipeline traversal
    nvm_read_ns: float = 100.0    # paper Table I
    nvm_write_ns: float = 200.0   # paper Table I
    # Channel occupancy per request (device-internal pipelining lets a PM
    # device sustain more than 1/latency requests per second; latency above
    # is what the *requester* observes, occupancy is when the channel can
    # accept the next request).
    nvm_read_occ_ns: float = 50.0
    nvm_write_occ_ns: float = 60.0
    dram_ns: float = 85.0         # volatile round trip (local DDR4-2400)
    pb_tag_ns: float = 0.388      # CACTI 22nm, 16 entries (paper Table I)
    pb_data_ns: float = 0.785     # CACTI 22nm, 16 entries (paper Table I)
    pbc_proc_ns: float = 60.0     # PBC packet handling + 64B commit into
                                  # persistent cells (the 0.785ns CACTI data
                                  # latency is the SRAM-style array access;
                                  # persisting the block costs tens of ns)
    pbc_occ_ns: float = 20.0      # PBC issue interval (pipelined FIFO
                                  # service of the PI front)
    pbc_read_ns: float = 12.0     # PBC service latency for a READ (header
                                  # decode + tag + data array read -- no
                                  # persistent-cell commit)
    pbc_read_occ_ns: float = 12.0
    # Staleness window between PBCS classification and PBC processing: a
    # Drain entry whose PM ack lands within this window of the PBC service
    # time is treated as already drained-and-replaced (Section V-D3), so
    # the read is forwarded to PM through the PO buffer.
    fwd_margin_ns: float = 150.0

    def pb_tag_ns_for(self, n_pbe: int) -> float:
        """CACTI-style growth of tag access latency with entry count.

        The paper recomputes tag latency per PBE count with CACTI; published
        CACTI fits grow ~ sqrt(capacity) for small fully-associative arrays.
        Anchored at the paper's 16-entry / 0.388 ns point.
        """
        return self.pb_tag_ns * math.sqrt(max(n_pbe, 1) / 16.0)

    def pb_data_ns_for(self, n_pbe: int) -> float:
        return self.pb_data_ns * math.sqrt(max(n_pbe, 1) / 16.0)

    # -- path helpers (chain of `n_sw` switches between CPU and PM) --------
    # All three are total functions of the depth, well-defined at n_sw == 0
    # (direct-attached PM): the first "hop" degenerates to the CPU link and
    # the drain path to nothing, so the composition identity
    # ``oneway_cpu_pm(n) == oneway_cpu_sw1(n) + oneway_sw1_pm(n)`` holds for
    # EVERY n >= 0 (tests/test_latency_profile.py pins it) and the engine
    # lowering needs no depth special-casing.
    def oneway_cpu_pm(self, n_sw: int) -> float:
        """CPU -> PM through a chain of n_sw switches (n_sw may be 0)."""
        if n_sw == 0:
            return self.cpu_link_ns
        return (n_sw + 1) * self.link_ns + n_sw * self.switch_pipe_ns

    def oneway_cpu_sw1(self, n_sw: int = 1) -> float:
        """CPU -> through the first switch (where the PB lives).

        At depth 0 there is no switch: the "first hop" is the direct CPU
        link to the PM controller, and :meth:`oneway_sw1_pm` is 0.
        """
        if n_sw == 0:
            return self.cpu_link_ns
        return self.link_ns + self.switch_pipe_ns

    def oneway_sw1_pm(self, n_sw: int) -> float:
        """First switch -> PM (the single-PB drain path); 0 at depth 0."""
        if n_sw == 0:
            return 0.0
        return n_sw * self.link_ns + (n_sw - 1) * self.switch_pipe_ns

    def hop_ns(self) -> float:
        """One inter-switch segment, one way (switch h -> switch h+1).

        The chained-PB forward path: a drain from hop h's PB travels one
        link plus one switch-pipeline traversal to reach hop h+1's PBC.
        ``oneway_sw1_pm(n) == (n-1) * hop_ns() + link_ns`` for n >= 1 —
        the chain decomposition of the drain path.
        """
        return self.link_ns + self.switch_pipe_ns


@dataclasses.dataclass(frozen=True)
class PCSConfig:
    """Full configuration of one simulated system."""

    scheme: Scheme = Scheme.PB
    n_pbe: int = 16              # persistent buffer entries (paper Table I)
    n_switches: int = 1          # CXL switches between CPU and PM
    # Per-switch PBE capacities of the chained pooling topology: entry h
    # is the PB size of switch h+1 (hop 1 = the tenant-facing ack point,
    # deeper hops = the pooling chain).  ``None`` = ``n_pbe`` at every
    # hop.  When set, ``n_pbe`` is synced from entry 0 (one source of
    # truth, like the policy <-> legacy-float shim).  Lowered to a
    # per-config per-hop vector, so a mixed-depth / mixed-capacity chain
    # sweep stays one grid; only the grid-wide max hop count and
    # max capacity are static shapes.
    pbe_per_hop: Optional[Tuple[int, ...]] = None
    n_cores: int = 8             # paper: 8-core OoO
    # Independent hosts (tenants) sharing the switch's persistence domain:
    # the trace's live cores are partitioned into ``n_tenants`` contiguous
    # groups (tenant t owns cores {c : floor(c*T/n_live) == t}) that share
    # the PB slots, the PBC FIFO and the PM banks.  Lowered to a per-config
    # scalar, so a {workload x scheme x tenant-count} grid is one
    # grid; only the per-tenant stats row count is a static shape.
    n_tenants: int = 1
    # Declarative persistence policy (drain-down x allocation).  ``None``
    # builds a default ``PBPolicy`` from the two legacy floats below —
    # the compatibility shim for pre-policy callers; passing ``policy=``
    # wins and the floats are synced from it (one source of truth).
    # Every policy field lowers to a scalar / per-tenant vector,
    # so a {workload x scheme x policy} sweep is one grid.
    policy: Optional[PBPolicy] = None
    drain_threshold: float = DEFAULT_DRAIN_THRESHOLD
    drain_preset: float = DEFAULT_DRAIN_PRESET
    pm_banks: int = 4             # independent PM device banks (the single
                                  # NVM device of Table I pipelines requests
                                  # across internal banks)
    # Power-loss instant (ns since simulation start).  ``inf`` = no crash.
    # Lowered to a per-config scalar (engine.state.scalars_from_config), so
    # a crash-point sweep is just another stacked config axis: a
    # {workload x scheme x crash-point} sweep stays one grid.
    crash_at_ns: float = math.inf
    # Fan-out fabric topology (leaf switches sharing one spine).  ``None``
    # keeps the linear chain.  When set, the tree lowers onto the chain
    # machinery: ``n_switches`` is forced to 2 (leaves are hop 1, the
    # spine is hop 2) and ``pbe_per_hop`` to ``(sum(leaf_pbe),
    # spine_pbe)`` — the leaves partition the hop-1 slot axis.  The
    # descriptor itself lowers to per-config scalars/vectors
    # (``n_leaves`` / ``leaf_of_t`` / ``leaf_base`` / ``bp_high``), so a
    # mixed {chain x fabric x placement} sweep stays one grid.
    fabric: Optional[FabricTopology] = None
    latency: LatencyProfile = dataclasses.field(default_factory=LatencyProfile)

    def __post_init__(self) -> None:
        if self.fabric is not None:
            # Lower the tree onto the chain machinery BEFORE the chain
            # checks below, so they validate the derived values.
            if self.scheme == Scheme.NOPB:
                raise ValueError(
                    "fabric is meaningless under NOPB: a volatile "
                    "fabric has no persistent buffers to place")
            for e in range(n_epochs_of(self.fabric.placement)):
                p = epoch_value(self.fabric.placement, e)
                if len(p) != self.n_tenants:
                    raise ValueError(
                        f"fabric.placement has {len(p)} "
                        f"entries for n_tenants={self.n_tenants}; need "
                        "exactly one leaf id per tenant")
            derived = (sum(self.fabric.leaf_pbe), self.fabric.spine_pbe)
            if self.n_switches not in (1, 2):
                raise ValueError(
                    "a fabric is a two-level tree (leaves + spine, "
                    "n_switches=2); leave n_switches at its default")
            object.__setattr__(self, "n_switches", 2)
            if self.pbe_per_hop is not None and \
                    tuple(int(x) for x in self.pbe_per_hop) != derived:
                raise ValueError(
                    f"pbe_per_hop={self.pbe_per_hop} disagrees with the "
                    f"fabric's derived {derived} (sum of leaf_pbe, "
                    "spine_pbe); drop pbe_per_hop — the fabric owns it")
            object.__setattr__(self, "pbe_per_hop", derived)
        if self.n_pbe < 1:
            raise ValueError("n_pbe must be >= 1")
        if self.n_switches < 0:
            raise ValueError("n_switches must be >= 0")
        if self.n_switches == 0 and self.scheme != Scheme.NOPB:
            # The persistent buffer lives inside the first switch; with no
            # switch in the chain there is nowhere for it to exist, and
            # lowering the drain path to 0 ns would silently simulate a
            # free PB (the old behaviour of scalars_from_config).
            raise ValueError(
                f"scheme {self.scheme.name} requires n_switches >= 1: the "
                "persistent buffer lives in the first CXL switch (use "
                "Scheme.NOPB for the switchless direct-attach baseline)")
        if self.pbe_per_hop is not None:
            if self.scheme == Scheme.NOPB:
                raise ValueError(
                    "pbe_per_hop is meaningless under NOPB: a volatile "
                    "switch chain has no persistent buffers")
            q = tuple(int(x) for x in self.pbe_per_hop)
            if len(q) != self.n_switches:
                raise ValueError(
                    f"pbe_per_hop has {len(q)} entries for "
                    f"n_switches={self.n_switches}; need one per switch")
            if any(x < 1 for x in q):
                raise ValueError("pbe_per_hop entries must be >= 1")
            object.__setattr__(self, "pbe_per_hop", q)
            # hop 1's capacity is the legacy n_pbe (one source of truth)
            object.__setattr__(self, "n_pbe", q[0])
        if not 1 <= self.n_tenants <= self.n_cores:
            raise ValueError("require 1 <= n_tenants <= n_cores")
        if not (0.0 < self.drain_preset <= self.drain_threshold <= 1.0):
            raise ValueError("require 0 < preset <= threshold <= 1")
        if self.policy is None:
            # compat shim: the legacy float knobs forward into a default
            # PBPolicy (DESIGN.md "Policy API"); bit-identical lowering
            object.__setattr__(self, "policy", PBPolicy(
                drain=DrainPolicy(threshold=self.drain_threshold,
                                  preset=self.drain_preset)))
        else:
            # policy wins: sync the legacy floats so threshold_count /
            # preset_count and telemetry read one source of truth (a
            # scheduled threshold/preset syncs its epoch-0 value — the
            # per-epoch counts are lowered from the schedule itself)
            object.__setattr__(self, "drain_threshold",
                               epoch_value(self.policy.drain.threshold, 0))
            object.__setattr__(self, "drain_preset",
                               epoch_value(self.policy.drain.preset, 0))
        self.policy.validate_for(self.n_pbe, self.n_tenants)
        if self.crash_at_ns < 0.0:
            raise ValueError("crash_at_ns must be >= 0 (or inf for no crash)")
        # force the shared-boundary validation at construction time: every
        # scheduled knob of this config must agree on ONE epoch-boundary
        # vector (the engine lowers a single shared epoch axis)
        _ = self.epoch_boundaries

    def with_crash(self, crash_at_ns: float) -> "PCSConfig":
        """Same system, power lost at ``crash_at_ns`` (Section V-D4)."""
        return dataclasses.replace(self, crash_at_ns=crash_at_ns)

    @property
    def epoch_boundaries(self) -> Tuple[float, ...]:
        """The config's shared epoch-boundary vector (``()`` = static).

        Collected across every schedule-capable knob and validated to
        be ONE vector (``shared_boundaries`` raises on disagreement) —
        the engine lowers a single ``epoch_bounds`` operand per config.
        """
        return shared_boundaries(
            self.policy.drain.threshold,
            self.policy.drain.preset,
            self.policy.drain.latency_target_ns,
            self.policy.alloc.tenant_quota,
            self.fabric.placement if self.fabric is not None else None)

    @property
    def n_epochs(self) -> int:
        """Number of schedule epochs (1 = fully static config)."""
        return len(self.epoch_boundaries) + 1

    @property
    def hop_pbes(self) -> Tuple[int, ...]:
        """PBE capacity per switch of the chain (empty for NOPB/depth 0)."""
        if self.scheme == Scheme.NOPB or self.n_switches == 0:
            return ()
        if self.pbe_per_hop is not None:
            return self.pbe_per_hop
        return (self.n_pbe,) * self.n_switches

    @property
    def max_hop_pbe(self) -> int:
        """Largest PB array anywhere in the chain (static shape bound)."""
        return max(self.hop_pbes, default=self.n_pbe)

    @property
    def threshold_count(self) -> int:
        return threshold_count(self.n_pbe, self.drain_threshold)

    @property
    def preset_count(self) -> int:
        return preset_count(self.n_pbe, self.drain_preset)


# ---------------------------------------------------------------------------
# Carrying configs across packages
# ---------------------------------------------------------------------------

def _schedule_or(v, build):
    """A ``Schedule`` field dict rebuilds as a Schedule; else ``build``."""
    if isinstance(v, dict) and set(v) == {"boundaries_ns", "values"}:
        return Schedule(tuple(v["boundaries_ns"]),
                        tuple(build(x) for x in v["values"]))
    return build(v)


def _tuple_or_none(v):
    return None if v is None else tuple(v)


def config_from_fields(d: dict) -> PCSConfig:
    """Rebuild a :class:`PCSConfig` from ``dataclasses.asdict(cfg)``.

    ``asdict`` flattens the nested :class:`PBPolicy`,
    :class:`LatencyProfile`, :class:`FabricTopology` and
    :class:`Schedule` dataclasses to dicts (and the scheme to its int);
    this rebuilds each of them, so a config built by another package
    with the same field names — the JAX reference — crosses over with
    every field, validation rule and derived value intact.
    """
    d = dict(d)
    pol = d.get("policy")
    if pol is not None:
        dr, al = pol["drain"], pol["alloc"]
        drain = DrainPolicy(
            threshold=_schedule_or(dr["threshold"], float),
            preset=_schedule_or(dr["preset"], float),
            per_tenant=dr["per_tenant"],
            low_water_drains=dr["low_water_drains"],
            empty_slack=dr["empty_slack"],
            latency_target_ns=_schedule_or(
                dr["latency_target_ns"],
                lambda x: None if x is None else float(x)),
            latency_tol=dr["latency_tol"])
        alloc = AllocPolicy(
            victim=al["victim"],
            tenant_quota=_schedule_or(al["tenant_quota"], _tuple_or_none))
        d["policy"] = PBPolicy(drain=drain, alloc=alloc)
    fab = d.get("fabric")
    if fab is not None:
        d["fabric"] = FabricTopology(
            n_leaves=fab["n_leaves"], leaf_pbe=tuple(fab["leaf_pbe"]),
            spine_pbe=fab["spine_pbe"],
            placement=_schedule_or(fab["placement"], tuple),
            bp_high=fab["bp_high"])
    if d.get("latency") is not None:
        d["latency"] = LatencyProfile(**d["latency"])
    if d.get("pbe_per_hop") is not None:
        d["pbe_per_hop"] = tuple(d["pbe_per_hop"])
    d["scheme"] = Scheme(int(d["scheme"]))
    return PCSConfig(**d)
