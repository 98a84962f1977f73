"""Differential crash-point conformance driver for the port: the
port's timed engine <-> the port's untimed oracle.

A copy of ``tests/_crash_driver.py`` on ``repro_torch.core.semantics``
(that module imports ``repro.core`` when it is loaded, so the port's
tests cannot use it as it is).

The fuzzer (``core.traces.fuzz_trace``) emits slot-spaced multi-core
persist/read/barrier interleavings whose engine execution order provably
equals the slot order, with every drain acked inside its slot (the
prompt-ack regime).  Crashing the timed engine at ``fuzz_crash_ns(k)``
and the untimed oracle after replaying slots ``<= k`` is therefore the
*same logical point*, and the paper's correctness argument requires the
two layers to agree exactly on the durable state that recovery
(Section V-D4) reconstructs:

  * no acked version is lost — every persist acked before the crash is
    durable after recovery;
  * no unacked version is resurrected — recovery preserves exactly the
    newest pre-crash version per address, never a fabricated one;
  * read forwarding never returns a value recovery would discard.

``oracle_replay`` returns the oracle's view; ``assert_cell_matches``
pins the engine's ``SimResult`` (run with ``track_addrs`` and a
``crash_at_ns`` config) against it.
"""
import collections

from repro_torch.core import Op, PCSConfig, Scheme
from repro_torch.core.semantics import EventKind, PersistentBuffer
from repro_torch.core.traces import FUZZ_SLOT_GAP_NS


def _counts_from(stats, scheme, victim_stalls):
    return dict(
        persists=stats["persists"],
        coalesces=stats["coalesces"],
        read_hits=stats["read_hits"],
        pm_reads=stats["read_hits"] + stats["read_misses"],
        # writes that reached the PM device: under a switch chain the
        # hop-1 drain count is NOT the PM write count (deep hops retain
        # and coalesce), so the oracle tracks device arrivals explicitly
        pm_writes=stats["pm_writes"],
        victim_drains=victim_stalls,
        slo_violations=stats.get("slo_over", 0),
    )


def oracle_replay(schedule, crash_slot, scheme, n_pbe, core_tenant=None,
                  n_tenants=1, policy=None, n_switches=1,
                  pbe_per_hop=None, fabric=None):
    """Replay schedule slots ``<= crash_slot``, then crash + recover.

    Acks are delivered promptly (all in-flight drains complete between
    slots, FIFO in emission order), mirroring the fuzzed traces' timing.
    Returns a dict with the durable per-address versions, the pre-crash
    event counts the engine must reproduce, and the read log.

    ``core_tenant`` (from ``core.traces.tenant_ids``) maps each core to
    the tenant the shared switch bills its requests to; the returned
    ``tenant_counts`` row per tenant must match the engine's per-tenant
    stats rows exactly.  ``policy`` (a ``PBPolicy``) drives the oracle's
    quota / victim / drain-scope decisions — the engine cell must be run
    with the *same* policy on its config.  ``n_switches`` /
    ``pbe_per_hop`` select a chained pooling topology: the returned
    ``hop_surviving`` / ``hop_counts`` rows must match the engine's
    per-hop recovery attribution and telemetry exactly.  ``fabric`` (a
    ``FabricTopology``) selects a fan-out tree instead: it forces the
    derived 2-hop shape (leaves + spine), and the returned
    ``leaf_surviving`` row must match the engine's per-leaf recovery
    attribution (``SimResult.leaf_recovery``).
    """
    pb = PersistentBuffer(PCSConfig(
        scheme=scheme, n_pbe=n_pbe, n_tenants=n_tenants, policy=policy,
        n_switches=n_switches, fabric=fabric,
        pbe_per_hop=(None if scheme == Scheme.NOPB or fabric is not None
                     else pbe_per_hop)))
    # SLO hint for the untimed oracle: the differential only exercises
    # *extreme* latency targets (<= 1 ns: every timed ack is over; huge:
    # none is), so the per-persist over/under outcome is decidable
    # without timing — the driver computes it once, up front
    lat_target = policy.drain.latency_target_ns if policy is not None \
        else None
    lat_over = lat_target is not None and lat_target <= 1.0
    aver = collections.defaultdict(int)   # per-address issued versions
    # under a multi-leaf fabric the hop-1 PB is leaf-partitioned: a read
    # from a *different* leaf than the newest persist cannot be forwarded
    # the leaf-private copy — it legitimately serves PM's durable version.
    # Track the newest persist's leaf so the read contract can tell the
    # two regimes apart (same-leaf reads keep the strict newest rule).
    multi_leaf = fabric is not None and fabric.n_leaves >= 2
    last_leaf = {}                        # addr -> leaf of newest persist
    pending = []
    victim_stalls = collections.defaultdict(int)
    reads = []
    for slot, core, op, addr in schedule:
        if slot > crash_slot:
            break
        # epoched schedules: the fuzzed slots issue at ~slot * gap with
        # sub-half-slot drift, and the tests place epoch boundaries at
        # half-slot instants (fuzz_crash_ns convention), so the slot's
        # nominal issue time selects exactly the engine's issue-time
        # epoch; schedule-free configs never leave epoch 0
        ep = pb.epoch_at(slot * FUZZ_SLOT_GAP_NS)
        if ep != pb.epoch:
            pb.set_epoch(ep)
        if op == int(Op.BARRIER):
            continue
        tenant = int(core_tenant[core]) if core_tenant is not None else 0
        if op == int(Op.PERSIST):
            aver[addr] += 1
            if multi_leaf:
                # placement resolved at the *current epoch* — entries
                # never migrate, so the newest copy lives on the leaf
                # the persist was issued to
                last_leaf[addr] = pb._placement[tenant]
            events = pb.persist(addr, (addr, aver[addr]), tenant=tenant,
                                lat_over=lat_over)
            victim_stalls[tenant] += sum(
                1 for e in events if e.kind == EventKind.STALLED)
            pending += [(e.addr, e.version) for e in events
                        if e.kind == EventKind.DRAIN_SENT]
        else:
            data, _ev = pb.read(addr, tenant=tenant)
            same_leaf = (not multi_leaf or addr not in last_leaf
                         or last_leaf[addr] == pb._placement[tenant])
            reads.append((addr, data, aver[addr], same_leaf))
        while pending:
            a, v = pending.pop(0)
            events = pb.pm_ack(a, v)
            pending += [(e.addr, e.version) for e in events
                        if e.kind == EventKind.DRAIN_SENT]
        pb.check_invariants()
    counts = _counts_from(pb.stats, scheme, sum(victim_stalls.values()))
    # NoPB applies exactly one PM write per persist; for the global row
    # keep the device's own applied-writes counter as the source of truth
    if scheme == Scheme.NOPB:
        counts["pm_writes"] = pb.pm.writes_applied
    zero = {k: 0 for k in pb.stats}
    tenant_counts = [
        _counts_from(pb.tenant_stats.get(t, zero), scheme,
                     victim_stalls[t])
        for t in range(n_tenants)]
    snapshot = {a: rec[0] for a, rec in pb.snapshot_durable().items()}
    # surviving (non-Empty) PBEs at the crash instant, per owning tenant
    # and per hop of the switch chain: the engine's recovery_entries /
    # tenant_recovery / hop_recovery must match exactly
    tenant_surviving = [0] * n_tenants
    for hop in [pb.entries, *pb.hops]:
        for e in hop:
            if e.state.name != "EMPTY":
                tenant_surviving[e.tenant] += 1
    hop_surviving = pb.hop_surviving()
    leaf_surviving = pb.leaf_surviving()
    hop_counts = [dict(hc) for hc in pb.hop_counts]
    pb.crash()
    pb.recover()
    durable = {}
    for addr, (gver, payload) in pb.pm.store.items():
        assert payload[0] == addr
        durable[addr] = payload[1]          # per-address version number
    # the non-mutating snapshot must predict recovery exactly
    assert {a: rec[0] for a, rec in pb.pm.store.items()} == snapshot, \
        "snapshot_durable disagrees with crash+recover"
    return dict(durable=durable, counts=counts, reads=reads,
                issued=dict(aver), tenant_counts=tenant_counts,
                tenant_surviving=tenant_surviving,
                hop_surviving=hop_surviving, hop_counts=hop_counts,
                leaf_surviving=leaf_surviving)


def assert_cell_matches(res, oracle, n_addrs, label=""):
    """The engine's post-recovery durable state must equal the oracle's."""
    durable = oracle["durable"]
    issued = oracle["issued"]
    got = {a: int(res.durable_ver[a]) for a in range(n_addrs)}
    want = {a: durable.get(a, 0) for a in range(n_addrs)}
    assert got == want, (label, "durable state diverged", got, want)

    counts = dict(persists=res.persists, coalesces=res.coalesces,
                  read_hits=res.read_hits, pm_reads=res.pm_reads,
                  pm_writes=res.pm_writes, victim_drains=res.victim_drains,
                  slo_violations=res.slo_violations)
    assert counts == oracle["counts"], (label, counts, oracle["counts"])
    # the latency histogram is persist-complete accounting: its mass
    # must equal the persist count the oracle agreed on (bit-exact twin
    # of S_PERSIST_CNT, accumulated at the same three engine sites)
    if res.lat_hist is not None:
        assert int(res.lat_hist.sum()) == res.persists, (
            label, "lat_hist mass", int(res.lat_hist.sum()), res.persists)

    # the Section V-D4 recovery pass re-drains exactly the oracle's
    # surviving (non-Empty) entries — the union across every hop
    assert res.recovery_entries == sum(oracle["tenant_surviving"]), (
        label, "recovery entries", res.recovery_entries,
        oracle["tenant_surviving"])

    # per-hop durable-state agreement over the switch chain: survivors
    # and the chain telemetry (commits / coalesces / bypasses / read
    # hits at every switch) must match row by row
    if res.hop_stats is not None:
        hops = res.hop_results()
        assert len(hops) == len(oracle["hop_surviving"]), (
            label, "hop count", len(hops), oracle["hop_surviving"])
        got_hs = [h["recovered"] for h in hops]
        assert got_hs == oracle["hop_surviving"], (
            label, "per-hop survivors", got_hs, oracle["hop_surviving"])
        for h, (got_h, want_h) in enumerate(
                zip(hops, oracle["hop_counts"])):
            got_row = {k: got_h[k] for k in
                       ("commits", "coalesces", "bypasses", "read_hits")}
            assert got_row == want_h, (label, "hop", h + 1, got_row,
                                       want_h)

    # per-leaf recovery attribution over a fan-out fabric: the engine's
    # leaf_recovery vector (non-None iff >= 2 leaves) must equal the
    # oracle's per-leaf survivor counts, which partition hop 1's total
    if res.leaf_recovery is not None:
        got_ls = [int(x) for x in res.leaf_recovery]
        assert got_ls == oracle["leaf_surviving"], (
            label, "per-leaf survivors", got_ls, oracle["leaf_surviving"])
        assert sum(got_ls) == oracle["hop_surviving"][0], (
            label, "leaf/hop partition", got_ls, oracle["hop_surviving"])
    else:
        assert len(oracle["leaf_surviving"]) <= 1, (
            label, "engine dropped leaf attribution",
            oracle["leaf_surviving"])

    # per-tenant accounting over the shared switch must agree row by row
    if res.n_tenants > 1:
        t_rows = res.tenant_results()
        assert len(t_rows) == len(oracle["tenant_counts"]), label
        for t, (tr, want_t) in enumerate(
                zip(t_rows, oracle["tenant_counts"])):
            got_t = dict(persists=tr.persists, coalesces=tr.coalesces,
                         read_hits=tr.read_hits, pm_reads=tr.pm_reads,
                         pm_writes=tr.pm_writes,
                         victim_drains=tr.victim_drains,
                         slo_violations=tr.slo_violations)
            assert got_t == want_t, (label, "tenant", t, got_t, want_t)
        # per-tenant recovery attribution (surviving-entry owners)
        got_surv = [tr.recovery_entries for tr in t_rows]
        assert got_surv == oracle["tenant_surviving"], (
            label, "tenant recovery", got_surv,
            oracle["tenant_surviving"])

    # prompt-ack regime: every executed persist was acked before the
    # crash, and (the paper's claim) every acked persist is durable
    assert res.acked_persists == res.persists, (label, "unacked persists")
    assert res.durable_persists == res.acked_persists, (
        label, "acked version lost")
    # no resurrection: durability never exceeds what was issued
    for a in range(n_addrs):
        assert got[a] <= issued.get(a, 0), (label, "resurrected", a)

    # read forwarding: every value served was the newest at read time
    # and is one recovery preserves (never a discarded version).  Under
    # a multi-leaf fabric a cross-leaf read (the newest persist landed
    # on another leaf's private PB window) legitimately misses the
    # reader's leaf and serves a durable-or-older version instead — but
    # it must never invent a version (> issued) and never serve one
    # recovery discards.
    for addr, data, newest, same_leaf in oracle["reads"]:
        if newest == 0:
            assert data is None, (label, "read invented data", addr)
            continue
        if same_leaf:
            assert data is not None and data == (addr, newest), (
                label, "stale read", addr, data, newest)
        elif data is not None:
            assert data[0] == addr and 1 <= data[1] <= newest, (
                label, "cross-leaf read invented a version", addr, data,
                newest)
        if data is not None:
            assert durable.get(addr, 0) >= data[1], (
                label, "forwarded value discarded by recovery", addr)
