"""Exact (untimed) semantics of the Persistent Buffer state machine.

Port of ``repro.core.semantics``: plain Python, no tensors, the same
classes, events and decisions line for line.

This module is the *correctness oracle* for the PCS design of Section V:
it implements the PB/PBC/PBCS state machine verbatim — Empty/Dirty/Drain
entry states, LRU victim selection among Dirty entries, the PB scheme's
drain-immediately policy, the PB_RF threshold/preset drain policy, write
coalescing, read forwarding, the write-ack fast path, and the crash /
recovery procedure of Section V-D4.

It is used by the port's property tests (tests/test_torch_semantics.py)
and by the crash differential of the port's timed engine and its
cell-scan kernel (tests/test_torch_crash_differential.py,
``chip_smoke.py``).

The model is event-explicit: every externally visible action (ack to the
CPU, drain packet to PM, read response and its source) is returned as an
Event so tests can assert ordering properties.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

from repro_torch.core.params import (PBEState, PCSConfig, Scheme,
                                     epoch_index, epoch_value,
                                     hop_drain_counts, preset_count,
                                     resolve_epoch, rf_drain_count,
                                     tenant_drain_counts, threshold_count)


class EventKind(enum.Enum):
    PERSIST_ACK = "persist_ack"        # switch acked a persist to the CPU
    DRAIN_SENT = "drain_sent"          # PB emitted a write packet toward PM
    DRAIN_ACKED = "drain_acked"        # PM confirmed a drain (entry freed)
    READ_FROM_PB = "read_from_pb"      # read forwarded from the buffer
    READ_FROM_PM = "read_from_pm"      # read served by the endpoint
    COALESCED = "coalesced"            # write absorbed into a Dirty entry
    STALLED = "stalled"                # PBC had to wait for an Empty entry


@dataclasses.dataclass
class Event:
    kind: EventKind
    addr: int
    version: int
    seq: int  # global monotone sequence number of the event


@dataclasses.dataclass
class PBEntry:
    addr: int
    version: int
    data: object
    state: PBEState
    lru: int  # stamp of last use (higher = more recent)
    tenant: int = 0  # last tenant (host) that wrote this entry
    leaf: int = 0  # owning leaf switch (fan-out fabric; 0 for chains)


class PersistentMemory:
    """The PM endpoint: a versioned store with in-order write application.

    Enforces the paper's *write order* criterion at the device: a write
    carrying an older version than the stored one must never overwrite a
    newer one.  The device accepts writes and produces acks; delivery of
    acks back to the switch is controlled by the caller (tests delay /
    reorder them to probe the protocol).
    """

    def __init__(self) -> None:
        self.store: Dict[int, Tuple[int, object]] = {}
        self.writes_applied = 0

    def write(self, addr: int, version: int, data: object) -> bool:
        """Apply a write; returns False (and drops it) if it is stale."""
        cur = self.store.get(addr)
        if cur is not None and cur[0] > version:
            return False  # stale drain: must not overwrite newer data
        self.store[addr] = (version, data)
        self.writes_applied += 1
        return True

    def read(self, addr: int) -> Optional[Tuple[int, object]]:
        return self.store.get(addr)


class PersistentBuffer:
    """The PB + PBC + PBCS state machine (Section V), untimed.

    Usage protocol (mirrors packet arrival order at the switch):
        ack? = pb.persist(addr, data)    -> list of Events (incl. PERSIST_ACK)
        pb.pm_ack(addr, version)         -> PM write-ack arrived at switch
        src = pb.read(addr)              -> READ_FROM_PB / READ_FROM_PM event
        pb.crash(); pb.recover()         -> Section V-D4

    The NoPB scheme is represented by constructing with scheme=NOPB, in
    which case persists bypass the buffer entirely.
    """

    def __init__(self, config: PCSConfig, pm: Optional[PersistentMemory] = None):
        self.config = config
        # Serving-SLO drain tightening (DrainPolicy.latency_target_ns):
        # the untimed oracle cannot compute persist latencies, so the
        # driver passes a per-persist ``lat_over`` hint; the per-tenant
        # running counters here are the engine's S_PERSIST_CNT /
        # S_SLO_OVER twins, updated at persist *completion* (a stalled
        # packet is counted once, when its retry lands — net of the
        # stall decrement, exactly like the "persists" counter).
        self._slo_cnt: Dict[int, int] = {}
        self.pm = pm if pm is not None else PersistentMemory()
        self.entries: List[PBEntry] = []
        # Switch chain (pooling topologies): ``entries`` is hop 1, the
        # tenant-facing ack point; every deeper switch owns one list in
        # ``hops`` (switch s = ``hops[s - 2]``), with its own capacity
        # and threshold/preset drain counts — the untimed twin of the
        # engine's deep-hop columns.  A hop-1 drain forwards its payload
        # into hop 2 synchronously (:meth:`_forward_batch`); the
        # DRAIN_SENT/pm_ack event protocol is unchanged and models the
        # downstream ack that frees the hop-1 entry.
        self._hop_pbes = config.hop_pbes
        self.n_hops = len(self._hop_pbes)
        self.hops: List[List[PBEntry]] = [
            [] for _ in self._hop_pbes[1:]]
        # Fan-out fabric (FabricTopology): hop 1 splits into per-leaf
        # switch pools — each tenant's persists/reads see only its
        # leaf's entries and capacity — while every leaf's drains merge
        # into the shared hop-2 spine (``hops[0]``), the fan-in point.
        # ``bp_high`` is the spine's Dirty-occupancy watermark: at/over
        # it, leaf drain-downs defer (victim drains are exempt — they
        # make room for an ack the CPU is already waiting on).  Without
        # a fabric everything lives on leaf 0 with the full n_pbe, so
        # every scoped path degenerates to the chain behaviour.
        fab = config.fabric
        self._n_leaves = fab.n_leaves if fab is not None else 1
        self._leaf_pbe = fab.leaf_pbe if fab is not None else (config.n_pbe,)
        self._bp_high = fab.bp_high if fab is not None else None
        # Epoched schedules: the declarative QoS policy / placement views
        # below (`self.policy`, `self._tenant_counts`, ...) are caches of
        # the *current epoch's* resolved values, derived by `set_epoch`
        # from the same `params.resolve_epoch` the engine lowering uses
        # (PCSConfig normalizes the legacy float knobs into a default
        # PBPolicy, so config.policy is always set; a schedule-free
        # config resolves identically at every epoch).  The driver
        # advances the epoch between slots via `set_epoch(epoch_at(t))`.
        self.set_epoch(0)
        # per-switch telemetry rows (engine twin: MachineState.hop_stats)
        self.hop_counts: List[Dict[str, int]] = [
            {"commits": 0, "coalesces": 0, "bypasses": 0, "read_hits": 0}
            for _ in self._hop_pbes]
        self._lru_clock = 0
        self._seq = 0
        self._version_clock = 0
        # Writes stalled at the PI buffer waiting for an Empty entry:
        # (addr, data, tenant, claim_below, lat_over) — `claim_below`
        # (non-None for quota-parked packets) gates the claim on the
        # tenant's own footprint shrinking below its park-time
        # occupancy; `lat_over` preserves the driver's SLO hint across
        # the re-park/replay cycle.
        self.pi_stalled: List[
            Tuple[int, object, int, Optional[int], Optional[bool]]] = []
        # Drains in flight: addr -> version sent (ack frees the entry).
        self.in_flight: Dict[int, int] = {}
        self.stats = {
            "persists": 0,
            "acks": 0,
            "drains": 0,       # hop-1 drain emissions (DRAIN_SENT events)
            "pm_writes": 0,    # write packets that reached the PM device
            "coalesces": 0,
            "read_hits": 0,
            "read_misses": 0,
            "stalls": 0,
            "slo_over": 0,     # persists over DrainPolicy.latency_target_ns
        }
        # Per-tenant accounting over the shared buffer: every event is
        # attributed to the tenant whose request triggered it (a policy
        # drain evicting another tenant's entry bills the *trigger*,
        # mirroring the timed engine's ctx.tenant attribution).
        self.tenant_stats: Dict[int, Dict[str, int]] = {}

    def _tstats(self, tenant: int) -> Dict[str, int]:
        if tenant not in self.tenant_stats:
            self.tenant_stats[tenant] = {k: 0 for k in self.stats}
        return self.tenant_stats[tenant]

    # -------------------------------------------------------------- epochs
    def set_epoch(self, epoch: int) -> None:
        """Re-derive every policy/placement cache for ``epoch``.

        The untimed twin of the engine's per-op operand selection
        (``engine.step.resolve_epoch_sc``): quota/share, the
        threshold/preset drain counts (global, per-tenant and per-hop),
        the serving-SLO target, and the tenant->leaf placement all come
        from ``params.resolve_epoch`` / ``params.epoch_value`` at the
        given epoch index.  Buffered entries are untouched — a placement
        flip migrates no entries (``_alloc_slot`` never moves an entry
        between leaves), so in-flight lines keep draining under their
        issue-time leaf exactly like the engine's slot-resident state.
        Idempotent; schedule-free configs resolve identically at every
        epoch.
        """
        self.epoch = int(epoch)
        cfg = self.config
        self.policy = resolve_epoch(cfg.policy, self.epoch)
        self._tenant_counts = (
            tenant_drain_counts(self.policy, cfg.n_pbe, cfg.n_tenants)
            if self.policy.drain.per_tenant else None)
        self._lat_target = self.policy.drain.latency_target_ns
        self._lat_tol = self.policy.drain.latency_tol
        self._thr_cnt = threshold_count(cfg.n_pbe,
                                        self.policy.drain.threshold)
        self._pre_cnt = preset_count(cfg.n_pbe, self.policy.drain.preset)
        fab = cfg.fabric
        self._placement = (epoch_value(fab.placement, self.epoch)
                           if fab is not None else None)
        self._hop_drain = (hop_drain_counts(self.policy, self._hop_pbes)
                           if self.n_hops else [])

    def epoch_at(self, t_ns: float) -> int:
        """Epoch index active at ``t_ns`` (boundary instants belong to
        the *new* epoch — ``params.epoch_index`` is the single home of
        that rule, shared with the engine's issue-time gate)."""
        return epoch_index(self.config.epoch_boundaries, t_ns)

    # ------------------------------------------------------------- helpers
    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _touch(self, e: PBEntry) -> None:
        self._lru_clock += 1
        e.lru = self._lru_clock

    def _leaf_of(self, tenant: int) -> int:
        """Leaf switch serving ``tenant`` (0 without a fabric)."""
        if self._placement is None:
            return 0
        return (self._placement[tenant]
                if 0 <= tenant < len(self._placement) else 0)

    def _find(self, addr: int, leaf: int = 0) -> Optional[PBEntry]:
        """Newest live entry for addr on ``leaf`` (Dirty supersedes
        Drain).  Leaves are physically separate switches, so a lookup
        never sees another leaf's entries."""
        best: Optional[PBEntry] = None
        for e in self.entries:
            if (e.addr == addr and e.state != PBEState.EMPTY
                    and e.leaf == leaf):
                if best is None or e.version > best.version:
                    best = e
        return best

    def _count(self, state: PBEState) -> int:
        return sum(1 for e in self.entries if e.state == state)

    def _alloc_slot(self, leaf: int = 0) -> Optional[PBEntry]:
        """Return an Empty entry of ``leaf``, materializing the leaf's
        fixed capacity lazily (entries never migrate between leaves —
        the engine's slot windows are a static partition)."""
        for e in self.entries:
            if e.state == PBEState.EMPTY and e.leaf == leaf:
                return e
        if (sum(1 for e in self.entries if e.leaf == leaf)
                < self._leaf_pbe[leaf]):
            e = PBEntry(addr=-1, version=-1, data=None,
                        state=PBEState.EMPTY, lru=0, leaf=leaf)
            self.entries.append(e)
            return e
        return None

    def _lru_dirty(self, owner: Optional[int] = None,
                   leaf: Optional[int] = None) -> Optional[PBEntry]:
        dirty = [e for e in self.entries if e.state == PBEState.DIRTY
                 and (owner is None or e.tenant == owner)
                 and (leaf is None or e.leaf == leaf)]
        if not dirty:
            return None
        return min(dirty, key=lambda e: e.lru)

    def _occupancy(self, tenant: int) -> int:
        """Live (Dirty+Drain) entries owned by ``tenant`` — the quota /
        share accounting base (engine twin: ``policy.tenant_occupancy``)."""
        return sum(1 for e in self.entries
                   if e.state != PBEState.EMPTY and e.tenant == tenant)

    def _pick_victim(self, tenant: int,
                     leaf: int = 0) -> Optional[PBEntry]:
        """No-Empty victim under the AllocPolicy (engine twin:
        ``engine.policy.select_slot``'s dirty mask).

        ``victim="weighted"`` prefers the LRU Dirty entry of a tenant
        at/over its share; falls back to the LRU Dirty entry.  Both
        searches see only ``leaf``'s entries (the engine scopes the
        dirty mask with ``fabric.leaf_mask``); the share accounting
        stays global, like the engine's ``tenant_occupancy``.
        """
        pol = self.policy.alloc
        if pol.victim == "weighted":
            occ: Dict[int, int] = {}
            for e in self.entries:
                if e.state != PBEState.EMPTY:
                    occ[e.tenant] = occ.get(e.tenant, 0) + 1
            hot = [e for e in self.entries if e.state == PBEState.DIRTY
                   and e.leaf == leaf
                   and occ.get(e.tenant, 0) >= pol.share_of(
                       e.tenant, self.config.n_pbe, self.config.n_tenants)]
            if hot:
                return min(hot, key=lambda e: e.lru)
        return self._lru_dirty(leaf=leaf)

    # --------------------------------------------------------------- drain
    def _start_drain(self, e: PBEntry, events: List[Event],
                     tenant: int = 0, *, forward: bool = True) -> tuple:
        """Dirty -> Drain; emit the write packet downstream (Section V-B).

        ``tenant`` is the tenant whose request *triggered* the drain
        (victim eviction / policy drain-down) — the one billed for it.
        With a single switch (or ``forward=False``, the recovery
        drain-all) the payload goes straight to PM; in a chain the
        caller forwards the returned packet into hop 2 via
        :meth:`_forward_batch` — batched with the other drains of the
        same trigger, mirroring the engine's cascade batches.  Either
        way the entry is freed by the downstream ack the driver delivers
        through :meth:`pm_ack`.
        """
        assert e.state == PBEState.DIRTY
        e.state = PBEState.DRAIN
        self.in_flight[(e.addr, e.version)] = True
        self.stats["drains"] += 1
        self._tstats(tenant)["drains"] += 1
        events.append(Event(EventKind.DRAIN_SENT, e.addr, e.version,
                            self._next_seq()))
        if self.config.n_switches <= 1 or not forward:
            # The PM device receives the write; its ack is delivered
            # later by the caller via pm_ack() (possibly delayed).
            self.pm.write(e.addr, e.version, e.data)
            self.stats["pm_writes"] += 1
            self._tstats(tenant)["pm_writes"] += 1
        return (e.addr, e.version, e.data, e.tenant)

    def _forward_batch(self, packets: List[tuple], s: int,
                       tenant: int) -> None:
        """Commit a drain batch into switch ``s``'s PB, then run its drain.

        The untimed twin of ``engine.chain._place``: packets (all with
        distinct addresses) coalesce into a live Dirty entry, else take
        an Empty slot, else *bypass* the full hop and continue toward
        PM; afterwards the hop's own drain policy runs once over the
        settled table (PB forwards everything, PB_RF drains LRU Dirty
        entries down to its per-hop preset).  Chain-internal acks are
        synchronous in the untimed model, so a forwarded entry frees
        immediately — matching the engine at slot boundaries, where
        every cascade ack has long landed.  ``tenant`` is the trigger
        billed for PM writes (engine twin: ``ctx.tenant``).
        """
        if not packets:
            return
        if s > self.config.n_switches:
            ts = self._tstats(tenant)
            for (addr, ver, data, _owner) in packets:
                self.pm.write(addr, ver, data)
                self.stats["pm_writes"] += 1
                ts["pm_writes"] += 1
            return
        hop = self.hops[s - 2]
        cap = self._hop_pbes[s - 1]
        hc = self.hop_counts[s - 1]
        bypass: List[tuple] = []
        for (addr, ver, data, owner) in packets:
            e = next((x for x in hop
                      if x.addr == addr and x.state == PBEState.DIRTY),
                     None)
            if e is not None:
                # fan-in max-version coalesce: within one leaf (and in a
                # linear chain) same-line versions travel in order, so
                # the arriving packet always wins; across leaves an
                # older version can arrive *after* a newer one already
                # sitting in the spine, and must not roll it back — the
                # resident copy keeps its version/data/owner (engine
                # twin: ``chain._place``'s max-version rule)
                if ver >= e.version:
                    e.version, e.data, e.tenant = ver, data, owner
                self._touch(e)
                hc["commits"] += 1
                hc["coalesces"] += 1
                continue
            slot = next((x for x in hop if x.state == PBEState.EMPTY),
                        None)
            if slot is None and len(hop) < cap:
                slot = PBEntry(addr=-1, version=-1, data=None,
                               state=PBEState.EMPTY, lru=0)
                hop.append(slot)
            if slot is None:
                hc["bypasses"] += 1
                bypass.append((addr, ver, data, owner))
                continue
            slot.addr, slot.version, slot.data = addr, ver, data
            slot.state, slot.tenant = PBEState.DIRTY, owner
            self._touch(slot)
            hc["commits"] += 1
        # the hop's own drain-down, once per batch (engine lockstep)
        dirty = [x for x in hop if x.state == PBEState.DIRTY]
        if self.config.scheme == Scheme.PB:
            k = len(dirty)          # drain-immediate: store and forward
        else:
            thr, pre = self._hop_drain[s - 1]
            # deep hops run the pure threshold/preset rule — no
            # keep-one-free heuristic (it protects the hop-1 PI front)
            k = rf_drain_count(len(dirty), 0, thr, pre,
                               low_water=0, empty_slack=-1)
        out: List[tuple] = []
        for victim in sorted(dirty, key=lambda x: x.lru)[:k]:
            out.append((victim.addr, victim.version, victim.data,
                        victim.tenant))
            victim.state = PBEState.EMPTY     # synchronous downstream ack
        self._forward_batch(bypass + out, s + 1, tenant)

    def _rf_drain_down(self, events: List[Event], tenant: int = 0) -> None:
        """PB_RF drain policy, shared with the timed engine.

        The decision (threshold/preset drain-down plus the keep-one-free
        low-water heuristic) lives in ``params.rf_drain_count`` (the
        shared policy scalar, re-exported by ``engine.policy``); this
        method only supplies the counts and drains the LRU Dirty victims
        it asks for.
        """
        if self.config.scheme != Scheme.PB_RF:
            return
        # backpressure-aware scheduling (FabricTopology.bp_high): while
        # the downstream spine FIFO sits at/over its Dirty watermark,
        # the whole leaf drain-down — threshold and low-water legs —
        # defers; the Dirty entries stay put and the next persist
        # re-evaluates (engine twin: the ``defer`` override in
        # ``engine.policy.drain_threshold_preset``)
        if (self._bp_high is not None and self.hops
                and sum(1 for e in self.hops[0]
                        if e.state == PBEState.DIRTY) >= self._bp_high):
            return
        pol = self.policy.drain
        leaf = self._leaf_of(tenant)
        # the drain-down runs on the trigger tenant's *leaf* switch: it
        # sees that leaf's Dirty entries and Empty pool only (engine
        # twin: ``leaf_act`` as the policy's slot mask)
        empty = self._leaf_pbe[leaf] - sum(
            1 for e in self.entries
            if e.state != PBEState.EMPTY and e.leaf == leaf)
        if pol.per_tenant:
            # tenant-scoped drain-down: the trigger's Dirty count against
            # *its* counts (quota / fair-share anchored), draining only
            # its own LRU Dirty entries — a noisy tenant can no longer
            # evict a quiet tenant's Dirty entries.  The keep-one-free
            # heuristic still watches the leaf's Empty pool.
            scope = tenant
            dirty = sum(1 for e in self.entries
                        if e.state == PBEState.DIRTY and e.tenant == tenant)
            thr, pre = self._tenant_counts[tenant]
        else:
            scope = None
            dirty = sum(1 for e in self.entries
                        if e.state == PBEState.DIRTY and e.leaf == leaf)
            thr, pre = self._thr_cnt, self._pre_cnt
        # serving-SLO tightening (engine twin: the ``tight`` override in
        # ``engine.policy.drain_threshold_preset``): while the trigger
        # tenant's observed over-target fraction exceeds its tolerance,
        # drain every in-scope Dirty entry ASAP (threshold 1, preset 0)
        if (self._lat_target is not None
                and self._tstats(tenant)["slo_over"]
                > self._lat_tol * self._slo_cnt.get(tenant, 0)):
            thr, pre = 1, 0
        k = rf_drain_count(dirty, empty, thr, pre,
                           pol.low_water_drains, pol.empty_slack)
        packets = []
        for _ in range(k):
            victim = self._lru_dirty(owner=scope, leaf=leaf)
            if victim is None:
                break
            packets.append(self._start_drain(victim, events, tenant))
        # chain: the drain-down set travels to hop 2 as ONE batch (the
        # engine's policy-drain leg); no-op with a single switch
        if self.config.n_switches >= 2:
            self._forward_batch(packets, 2, tenant)

    def _slo_note(self, tenant: int, lat_over: Optional[bool]) -> None:
        """Record one *completed* persist's SLO outcome.

        ``lat_over`` is the driver's timing hint (ack latency over
        ``DrainPolicy.latency_target_ns``); the untimed oracle cannot
        compute latencies itself.  The counters feed the tight override
        in :meth:`_rf_drain_down` and the engine differential
        (``S_PERSIST_CNT`` / ``S_SLO_OVER`` twins).
        """
        self._slo_cnt[tenant] = self._slo_cnt.get(tenant, 0) + 1
        if lat_over:
            self.stats["slo_over"] += 1
            self._tstats(tenant)["slo_over"] += 1

    def _stall(self, addr: int, data: object, tenant: int, version: int,
               events: List[Event], retry: bool,
               claim_below: Optional[int],
               lat_over: Optional[bool] = None) -> List[Event]:
        """Park the write at the PI buffer until an entry frees (V-D1).

        A *retry* (a previously stalled packet replayed by
        :meth:`pm_ack`) is re-parked without re-billing: the engine
        counts one victim/stall event per original packet no matter how
        long it waits, so only the packet's first stall emits STALLED
        and bumps the stall counters.  ``claim_below`` (non-None for
        quota-parked packets) is the tenant's occupancy at park time:
        the packet may only claim a slot once its tenant's footprint
        shrank below it — i.e. once one of its *own* entries freed — so
        the recycle restores exactly the park-time occupancy, like the
        engine's over-quota victim path (see :meth:`persist`).
        """
        ts = self._tstats(tenant)
        self.pi_stalled.append((addr, data, tenant, claim_below, lat_over))
        self.stats["persists"] -= 1
        ts["persists"] -= 1
        self._version_clock -= 1
        if not retry:
            self.stats["stalls"] += 1
            ts["stalls"] += 1
            events.append(Event(EventKind.STALLED, addr, version,
                                self._next_seq()))
        return events

    # ------------------------------------------------------------- persist
    def persist(self, addr: int, data: object,
                tenant: int = 0, *, _retry: bool = False,
                _claim_below: Optional[int] = None,
                lat_over: Optional[bool] = None) -> List[Event]:
        """A persist (flush+fence) packet reaches the switch.

        ``tenant`` tags which host issued it (multi-tenant sharing of
        the switch); all events it triggers are billed to that tenant.
        ``lat_over`` is the driver's SLO hint: whether this persist's
        *timed* ack latency exceeded ``DrainPolicy.latency_target_ns``
        (ignored — and irrelevant — when no target is set); it feeds the
        tight drain-down override via :meth:`_slo_note` and is counted
        once, at completion.
        ``_retry`` marks the replay of a stalled packet (internal, from
        :meth:`pm_ack`): it re-attempts allocation but neither starts
        another victim drain nor re-counts the stall.  ``_claim_below``
        marks the replay of a quota-parked packet: it *recycles* the
        slot one of its own entries (typically its victim drain) freed,
        claiming only once its tenant's occupancy drops below the
        park-time value and bypassing the quota gate for that claim —
        occupancy is restored to the park-time level, exactly the timed
        engine's over-quota victim path (which writes into its victim's
        slot at the drain-ack time).  Without the exemption a tenant
        pushed *over* quota by a cross-tenant coalesce takeover could
        park a packet forever; without the own-entry gate the claim
        could transiently grow the footprint past the quota.
        """
        events: List[Event] = []
        ts = self._tstats(tenant)
        self.stats["persists"] += 1
        ts["persists"] += 1
        self._version_clock += 1
        version = self._version_clock

        if self.config.scheme == Scheme.NOPB:
            # Volatile switch: the persist round-trips to PM.
            self.pm.write(addr, version, data)
            self._slo_note(tenant, lat_over)
            self.stats["acks"] += 1
            self.stats["pm_writes"] += 1
            ts["acks"] += 1
            ts["pm_writes"] += 1
            events.append(Event(EventKind.PERSIST_ACK, addr, version,
                                self._next_seq()))
            return events

        leaf = self._leaf_of(tenant)
        existing = self._find(addr, leaf)
        if existing is not None and existing.state == PBEState.DIRTY:
            if self.config.scheme == Scheme.PB_RF:
                # Write coalescing: newer version absorbs the older one.
                existing.version = version
                existing.data = data
                existing.tenant = tenant
                self._touch(existing)
                self._slo_note(tenant, lat_over)
                self.stats["coalesces"] += 1
                self.stats["acks"] += 1
                ts["coalesces"] += 1
                ts["acks"] += 1
                self.hop_counts[0]["commits"] += 1
                self.hop_counts[0]["coalesces"] += 1
                events.append(Event(EventKind.COALESCED, addr, version,
                                    self._next_seq()))
                events.append(Event(EventKind.PERSIST_ACK, addr, version,
                                    self._next_seq()))
                # The drain-down policy is evaluated on every persist,
                # coalesces included (the engine's drain_threshold_preset
                # runs unconditionally).  Under the global policy a
                # coalesce never changes the Dirty count so this is
                # unreachable work, but a cross-tenant coalesce takeover
                # *does* move the owning tenant's Dirty count across its
                # scoped threshold.
                self._rf_drain_down(events, tenant)
                return events
            # PB scheme never observes Dirty (drain-immediately), but the
            # state machine stays safe if it does: fall through to stall.

        # Per-tenant PBE quota (AllocPolicy): a tenant at/over its cap
        # may not grow its footprint with an Empty slot — it recycles it
        # instead: drain its own LRU Dirty entry (none if all already in
        # flight) and wait at the PI buffer for one of its own entries
        # to free; the claim then restores the park-time occupancy (see
        # the docstring).  Coalescing above is exempt (reuses an entry).
        occ = self._occupancy(tenant)
        if _claim_below is not None:
            if occ >= _claim_below:
                # no own entry freed yet: keep waiting (silent re-park)
                return self._stall(addr, data, tenant, version, events,
                                   _retry, claim_below=_claim_below,
                                   lat_over=lat_over)
        elif occ >= self.policy.alloc.quota_of(tenant):
            if not _retry:
                victim = self._lru_dirty(owner=tenant, leaf=leaf)
                if victim is not None:
                    pkt = self._start_drain(victim, events, tenant)
                    # chain: the victim leg travels ahead of the entry
                    # write (engine lockstep: a one-packet batch)
                    if self.config.n_switches >= 2:
                        self._forward_batch([pkt], 2, tenant)
            return self._stall(addr, data, tenant, version, events,
                               _retry, claim_below=occ, lat_over=lat_over)

        # An in-flight (Drain) older version does NOT block the new persist:
        # the new version gets its own entry; the switch->PM path is FIFO,
        # so same-address drains reach PM in version order (Section IV-A
        # write order without blocking the ack).
        slot = self._alloc_slot(leaf)
        if slot is None:
            if not _retry:
                victim = self._pick_victim(tenant, leaf)
                if victim is not None:
                    pkt = self._start_drain(victim, events, tenant)
                    if self.config.n_switches >= 2:
                        self._forward_batch([pkt], 2, tenant)
            # Whether we drained a victim or everything is already Drain,
            # the write must wait for an Empty entry (Section V-D1).
            return self._stall(addr, data, tenant, version, events,
                               _retry, claim_below=_claim_below,
                               lat_over=lat_over)

        slot.addr = addr
        slot.version = version
        slot.data = data
        slot.state = PBEState.DIRTY
        slot.tenant = tenant
        self._touch(slot)
        self._slo_note(tenant, lat_over)
        self.stats["acks"] += 1
        ts["acks"] += 1
        self.hop_counts[0]["commits"] += 1
        events.append(Event(EventKind.PERSIST_ACK, addr, version,
                            self._next_seq()))

        if self.config.scheme == Scheme.PB:
            # Drain as soon as acked, to keep Empty entries available.
            pkt = self._start_drain(slot, events, tenant)
            if self.config.n_switches >= 2:
                self._forward_batch([pkt], 2, tenant)
        else:
            self._rf_drain_down(events, tenant)
        return events

    # -------------------------------------------------------------- pm ack
    def pm_ack(self, addr: int, version: int) -> List[Event]:
        """A PM write-ack packet reaches the switch (PI-front priority)."""
        events: List[Event] = []
        if (addr, version) not in self.in_flight:
            return events  # stale/unknown ack: ignore
        del self.in_flight[(addr, version)]
        for e in self.entries:
            if (e.addr == addr and e.state == PBEState.DRAIN
                    and e.version == version):
                e.state = PBEState.EMPTY
                events.append(Event(EventKind.DRAIN_ACKED, addr, version,
                                    self._next_seq()))
                break
        # Retry stalled writes now that an entry may be Empty.  Acks were
        # prioritized to the PI front precisely to enable this (V-D2).
        # Replays are marked _retry: a packet still blocked (no Empty /
        # still over quota) re-parks silently — one stall event and at
        # most one victim drain per original packet, like the engine.
        retries, self.pi_stalled = self.pi_stalled, []
        for (a, d, tn, cb, lo) in retries:
            events.extend(self.persist(a, d, tn, _retry=True,
                                       _claim_below=cb, lat_over=lo))
        return events

    # ---------------------------------------------------------------- read
    def read(self, addr: int,
             tenant: int = 0) -> Tuple[Optional[object], Event]:
        """A read request reaches the switch; returns (data, event)."""
        ts = self._tstats(tenant)
        e = self._find(addr, self._leaf_of(tenant))
        if e is not None and e.state in (PBEState.DIRTY, PBEState.DRAIN):
            # PBCS routes to PI; PBC serves from the buffer (V-D3).  Under
            # PB the entry is in Drain: serving from PB is still correct
            # (same bytes as the in-flight drain) and preserves write-read
            # order because the drain was emitted before this response.
            # A forwarded read refreshes the entry's LRU stamp, matching
            # the timed engine's victim-selection discipline.
            self._touch(e)
            self.stats["read_hits"] += 1
            ts["read_hits"] += 1
            self.hop_counts[0]["read_hits"] += 1
            return e.data, Event(EventKind.READ_FROM_PB, addr, e.version,
                                 self._next_seq())
        # chain read forwarding: the miss travels toward PM past every
        # deeper switch's PBCS — the shallowest hop holding a live entry
        # serves it (shallower always holds the newer version); NOPB has
        # no persistent hops (n_hops == 0)
        for s in range(2, self.n_hops + 1):
            d_e = next((x for x in self.hops[s - 2]
                        if x.addr == addr and x.state == PBEState.DIRTY),
                       None)
            if d_e is not None:
                self._touch(d_e)
                self.stats["read_hits"] += 1
                ts["read_hits"] += 1
                self.hop_counts[s - 1]["read_hits"] += 1
                return d_e.data, Event(EventKind.READ_FROM_PB, addr,
                                       d_e.version, self._next_seq())
        self.stats["read_misses"] += 1
        ts["read_misses"] += 1
        rec = self.pm.read(addr)
        data = rec[1] if rec is not None else None
        ver = rec[0] if rec is not None else -1
        return data, Event(EventKind.READ_FROM_PM, addr, ver,
                           self._next_seq())

    # ----------------------------------------------------- crash / recover
    def crash(self) -> None:
        """Power loss: routing state (PI/PO, in-flight acks) is lost; the
        PB tables survive (non-volatile cells / battery), Section V-D4."""
        self.pi_stalled.clear()
        self.in_flight.clear()
        # Entries survive with their states; nothing else to do.

    def recover(self) -> List[Event]:
        """Reboot: treat every non-Empty entry — at every hop — as Dirty
        and drain the union straight to PM (the device rejects stale
        versions, so duplicate addresses across hops resolve to the
        newest surviving copy regardless of drain order)."""
        events: List[Event] = []
        for e in self.entries:
            if e.state in (PBEState.DIRTY, PBEState.DRAIN):
                e.state = PBEState.DIRTY
                # recovery drains belong to the entry's owning tenant;
                # forward=False: drain-all bypasses the (rebooting) chain
                self._start_drain(e, events, e.tenant, forward=False)
        for hop in self.hops:
            for e in hop:
                if e.state in (PBEState.DIRTY, PBEState.DRAIN):
                    # deep entries sit outside the hop-1 ack protocol:
                    # their recovery drain completes synchronously
                    self.pm.write(e.addr, e.version, e.data)
                    self.stats["drains"] += 1
                    self.stats["pm_writes"] += 1
                    self._tstats(e.tenant)["drains"] += 1
                    self._tstats(e.tenant)["pm_writes"] += 1
                    events.append(Event(EventKind.DRAIN_SENT, e.addr,
                                        e.version, self._next_seq()))
                    events.append(Event(EventKind.DRAIN_ACKED, e.addr,
                                        e.version, self._next_seq()))
                    e.state = PBEState.EMPTY
        # Recovery drains are immediately acked in this untimed model.
        for e in self.entries:
            if e.state == PBEState.DRAIN:
                events.extend(self.pm_ack(e.addr, e.version))
        return events

    # ----------------------------------------------------- durable snapshot
    def snapshot_durable(self) -> Dict[int, Tuple[int, object]]:
        """What a crash-now + recovery would preserve, without mutating.

        The durable domain is PM plus the PB's persistent cells: for
        every address, the newest version between the PM store and any
        live (Dirty/Drain) entry — exactly what ``crash(); recover()``
        leaves in PM, since recovery re-drains every live entry and the
        device rejects stale writes.  ``tests/test_semantics.py`` pins
        this equivalence; the crash-differential harness uses it to
        read the oracle's durable state at arbitrary crash points.
        """
        durable: Dict[int, Tuple[int, object]] = dict(self.pm.store)
        for hop in [self.entries, *self.hops]:
            for e in hop:
                if e.state == PBEState.EMPTY:
                    continue
                cur = durable.get(e.addr)
                if cur is None or e.version > cur[0]:
                    durable[e.addr] = (e.version, e.data)
        return durable

    def hop_surviving(self) -> List[int]:
        """Live (non-Empty) PBEs per switch — what a crash right now
        would leave for the per-hop recovery drain-all (engine twin:
        ``SimResult.hop_recovery``)."""
        return [sum(1 for e in hop if e.state != PBEState.EMPTY)
                for hop in [self.entries, *self.hops]][:self.n_hops]

    def leaf_surviving(self) -> List[int]:
        """Live (non-Empty) hop-1 PBEs per leaf switch — the fabric's
        per-leaf crash attribution (engine twin:
        ``SimResult.leaf_recovery``).  Sums to ``hop_surviving()[0]``;
        spine survivors are ``hop_surviving()[1]``."""
        out = [0] * self._n_leaves
        for e in self.entries:
            if e.state != PBEState.EMPTY:
                out[e.leaf] += 1
        return out

    # ------------------------------------------------------------ invariant
    def check_invariants(self) -> None:
        """The paper's three correctness criteria, checkable at any time.

        Under a multi-leaf fabric the *global-ordering* forms are
        genuinely weaker — two leaves are independent switches, so a
        newer version can reach PM through one leaf while an older copy
        of the same line is still live on another — and the affected
        checks scope to a leaf (or are skipped where no leaf-local form
        exists).  End-to-end safety then rests on the PM device's
        stale-write rejection, which the property tests pin.
        """
        multi_leaf = self._n_leaves >= 2
        # (c) crash consistency, internal form: a Dirty entry is by
        #     definition the latest-and-only copy, so PM must never hold a
        #     version newer than a live Dirty entry.  (An older *Drain*
        #     entry may coexist with a newer PM version when acks return
        #     out of order; recovery re-drains it and PM rejects the stale
        #     write, so nothing is lost.)  The external form — "no acked
        #     version is ever lost" — is asserted by the property tests,
        #     which track acks outside the buffer.  With >= 2 leaves
        #     another leaf's drain may legitimately land a newer version
        #     in PM, so the check has no leaf-local form and is skipped.
        if not multi_leaf:
            for e in self.entries:
                if e.state != PBEState.DIRTY:
                    continue
                rec = self.pm.read(e.addr)
                if rec is not None and rec[0] > e.version:
                    raise AssertionError(
                        f"PM holds newer version than live Dirty PB entry "
                        f"for addr={e.addr}: pm={rec[0]} pb={e.version}")
        # (b) write order: at most one Dirty entry per (leaf, address),
        #     and every Drain entry for an address is strictly older than
        #     its *same-leaf* Dirty entry (versions drain toward PM in
        #     order within each leaf's FIFO; across leaves no order is
        #     promised).
        dirty = [(e.leaf, e.addr) for e in self.entries
                 if e.state == PBEState.DIRTY]
        if len(dirty) != len(set(dirty)):
            raise AssertionError(
                "duplicate Dirty PB entries for one (leaf, address)")
        newest_dirty = {(e.leaf, e.addr): e.version for e in self.entries
                        if e.state == PBEState.DIRTY}
        for e in self.entries:
            if (e.state == PBEState.DRAIN
                    and (e.leaf, e.addr) in newest_dirty
                    and e.version >= newest_dirty[(e.leaf, e.addr)]):
                raise AssertionError(
                    f"Drain entry not older than Dirty for addr={e.addr} "
                    f"on leaf {e.leaf}")
        # Switch-chain forms of (b) and (c): per hop at most one Dirty
        # entry per address; versions strictly decrease with depth (an
        # entry only moves down the chain, and coalescing keeps the
        # newest at the shallowest hop holding the line); PM never holds
        # a version newer than any live Dirty entry at any hop.  The
        # per-hop uniqueness holds under fan-in too (the spine's
        # max-version coalesce keeps one Dirty per address), but the
        # cross-layer orderings do not — a slow leaf's old Dirty line
        # may coexist with a newer spine/PM copy — so those scope to
        # single-leaf topologies.
        newest_by_addr: Dict[int, int] = {
            a: v for (_lf, a), v in newest_dirty.items()}
        for s, hop in enumerate(self.hops, start=2):
            hop_dirty = [e.addr for e in hop if e.state == PBEState.DIRTY]
            if len(hop_dirty) != len(set(hop_dirty)):
                raise AssertionError(
                    f"duplicate Dirty entries for one address at hop {s}")
            if multi_leaf:
                continue
            for e in hop:
                if e.state != PBEState.DIRTY:
                    continue
                if (e.addr in newest_by_addr
                        and e.version >= newest_by_addr[e.addr]):
                    raise AssertionError(
                        f"hop {s} holds a version not older than a "
                        f"shallower hop's for addr={e.addr}")
                newest_by_addr[e.addr] = e.version
                rec = self.pm.read(e.addr)
                if rec is not None and rec[0] > e.version:
                    raise AssertionError(
                        f"PM holds newer version than hop-{s} Dirty entry "
                        f"for addr={e.addr}: pm={rec[0]} pb={e.version}")
