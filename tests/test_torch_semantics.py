"""The port's untimed oracle (``repro_torch.core.semantics``) against the
reference's (``repro.core.semantics``), and the reference's property
tests on the port's oracle.

Both oracles are driven by the same seeded schedules — the fuzzed
multi-core slot schedules of ``fuzz_trace`` (replayed as the crash
driver does, with every drain acked before the next slot) and the
random persist/ack/read schedules of ``tests/test_semantics.py`` (acks
reordered across addresses, FIFO per address) — over NoPB/PB/PB_RF,
tenants and quotas, chains of depth 1-3 with uneven ``pbe_per_hop``,
fan-out fabrics and ``Schedule`` policies.  Every step's events must be
equal as ``(kind, addr, version, seq)``, with the data every read
returns, and so must ``snapshot_durable``, ``hop_surviving``,
``leaf_surviving``, the counters and the PM store after crash and
recovery.
"""
import collections
import random

import pytest

from _torch_ref import reference
from repro_torch.core import params as PP
from repro_torch.core import semantics as PS
from repro_torch.core.traces import (FUZZ_SLOT_GAP_NS, fuzz_crash_ns,
                                     fuzz_trace, leaf_placement, tenant_ids)

S = PP.Scheme
OP_PERSIST, OP_BARRIER = int(PP.Op.PERSIST), int(PP.Op.BARRIER)


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _ev(e):
    return (e.kind.value, e.addr, e.version, e.seq)


def drive(sem, cfg, steps):
    """Run ``steps`` on a fresh ``sem.PersistentBuffer(cfg)``; return the
    full log: each step's events (and a read's data), then the durable
    snapshot, per-hop and per-leaf survivors, the counters, and the PM
    store after crash and recovery.

    A step is ``("persist", addr, tenant, lat_over)``, ``("read", addr,
    tenant)``, ``("ack", i)`` (deliver pending drain ``i`` modulo the
    queue, FIFO per address), ``("flush",)`` (deliver every pending
    drain in emission order) or ``("epoch", t)``.
    """
    pb = sem.PersistentBuffer(cfg)
    log, pending = [], []
    aver = collections.defaultdict(int)

    def deliver(a, v):
        evs = pb.pm_ack(a, v)
        pending.extend((e.addr, e.version) for e in evs
                       if e.kind == sem.EventKind.DRAIN_SENT)
        log.append(("ack", a, v, [_ev(e) for e in evs]))

    for st in steps:
        kind = st[0]
        if kind == "epoch":
            ep = pb.epoch_at(st[1])
            if ep != pb.epoch:
                pb.set_epoch(ep)
            log.append(("epoch", ep))
            continue
        if kind == "persist":
            _, addr, tenant, lat_over = st
            aver[addr] += 1
            evs = pb.persist(addr, (addr, aver[addr]), tenant=tenant,
                             lat_over=lat_over)
            pending.extend((e.addr, e.version) for e in evs
                           if e.kind == sem.EventKind.DRAIN_SENT)
            log.append(("persist", [_ev(e) for e in evs]))
        elif kind == "read":
            data, e = pb.read(st[1], tenant=st[2])
            log.append(("read", data, _ev(e)))
        elif kind == "ack":
            if pending:
                a, _ = pending[st[1] % len(pending)]
                a, v = min((p for p in pending if p[0] == a),
                           key=lambda p: p[1])
                pending.remove((a, v))
                deliver(a, v)
        elif kind == "flush":
            while pending:
                deliver(*pending.pop(0))
        pb.check_invariants()
    log.append(("snapshot", {a: rec for a, rec in
                             pb.snapshot_durable().items()}))
    log.append(("hops", pb.hop_surviving(), pb.leaf_surviving(),
                [dict(h) for h in pb.hop_counts]))
    log.append(("stats", dict(pb.stats),
                {t: dict(v) for t, v in pb.tenant_stats.items()}))
    pb.crash()
    pb.recover()
    log.append(("recovered", dict(pb.pm.store), pb.pm.writes_applied))
    return log


def fuzz_steps(seed, n_cores, n_tenants, p_persist, lat_over=False,
               n_slots=50, n_addrs=6):
    """The crash driver's replay of a fuzzed schedule, as steps."""
    tr, sched = fuzz_trace(seed, n_cores=n_cores, n_slots=n_slots,
                           n_addrs=n_addrs, n_tenants=n_tenants,
                           p_persist=p_persist)
    core_tenant = tenant_ids(tr.lengths, n_tenants)
    steps = []
    for slot, core, op, addr in sched:
        steps.append(("epoch", slot * FUZZ_SLOT_GAP_NS))
        if op == OP_BARRIER:
            continue
        tenant = int(core_tenant[core])
        if op == OP_PERSIST:
            steps.append(("persist", addr, tenant, lat_over))
        else:
            steps.append(("read", addr, tenant))
        steps.append(("flush",))
    return steps


def random_steps(seed, n_ops=120, n_addrs=6, n_tenants=1):
    """``tests/test_semantics.py``'s random schedules (persist, ack and
    read at random, acks reordered across addresses)."""
    rng = random.Random(seed)
    ack_order = [rng.randrange(32) for _ in range(16)]
    steps, ai = [], 0
    for _ in range(n_ops):
        op, addr = rng.choice(["persist", "ack", "read"]), \
            rng.randrange(n_addrs)
        tenant = rng.randrange(n_tenants)
        if op == "persist":
            steps.append(("persist", addr, tenant, False))
        elif op == "ack":
            steps.append(("ack", ack_order[ai % len(ack_order)]))
            ai += 1
        else:
            steps.append(("read", addr, tenant))
    return steps


BOUND = fuzz_crash_ns(25)          # a mid-run epoch boundary (half slot)

# name -> (config factory over a params module, n_cores, n_tenants)
CONFIGS = {
    "nopb": (lambda m: m.PCSConfig(scheme=m.Scheme.NOPB, n_pbe=4), 3, 1),
    "pb": (lambda m: m.PCSConfig(scheme=m.Scheme.PB, n_pbe=3), 3, 1),
    "pb_rf": (lambda m: m.PCSConfig(scheme=m.Scheme.PB_RF, n_pbe=4), 3, 1),
    "pb_rf_t2_quota": (lambda m: m.PCSConfig(
        scheme=m.Scheme.PB_RF, n_pbe=8, n_cores=4, n_tenants=2,
        policy=m.PBPolicy(drain=m.DrainPolicy(per_tenant=True),
                          alloc=m.AllocPolicy(tenant_quota=(2, 5)))), 4, 2),
    "pb_t2_weighted": (lambda m: m.PCSConfig(
        scheme=m.Scheme.PB, n_pbe=4, n_cores=4, n_tenants=2,
        policy=m.PBPolicy(alloc=m.AllocPolicy(victim="weighted",
                                              tenant_quota=(1, 3)))), 4, 2),
    "pb_chain2": (lambda m: m.PCSConfig(
        scheme=m.Scheme.PB, n_pbe=3, n_switches=2, pbe_per_hop=(3, 3)),
        3, 1),
    "pb_rf_chain3": (lambda m: m.PCSConfig(
        scheme=m.Scheme.PB_RF, n_pbe=3, n_switches=3,
        pbe_per_hop=(3, 2, 1)), 3, 1),
    "pb_chain3_wide": (lambda m: m.PCSConfig(
        scheme=m.Scheme.PB, n_pbe=2, n_switches=3,
        pbe_per_hop=(2, 4, 3)), 3, 1),
    "pb_rf_chain2_t2": (lambda m: m.PCSConfig(
        scheme=m.Scheme.PB_RF, n_pbe=4, n_cores=4, n_tenants=2,
        n_switches=2), 4, 2),
    "pb_rf_fabric2": (lambda m: m.PCSConfig(
        scheme=m.Scheme.PB_RF, n_cores=4, n_tenants=4,
        fabric=m.FabricTopology(2, (4, 4), 4,
                                leaf_placement(4, 2, "spread"))), 4, 4),
    "pb_fabric4_bp": (lambda m: m.PCSConfig(
        scheme=m.Scheme.PB, n_cores=4, n_tenants=4,
        fabric=m.FabricTopology(4, (2, 2, 2, 2), 4,
                                leaf_placement(4, 4, "spread"),
                                bp_high=2.0)), 4, 4),
    "pb_rf_threshold_schedule": (lambda m: m.PCSConfig(
        scheme=m.Scheme.PB_RF, n_pbe=8, n_cores=4, n_tenants=4,
        policy=m.PBPolicy(drain=m.DrainPolicy(
            threshold=m.Schedule((BOUND,), (0.75, 0.375)), preset=0.25))),
        4, 4),
    "pb_quota_schedule": (lambda m: m.PCSConfig(
        scheme=m.Scheme.PB, n_pbe=8, n_cores=4, n_tenants=4,
        policy=m.PBPolicy(alloc=m.AllocPolicy(tenant_quota=m.Schedule(
            (BOUND,), ((2, 2, 2, 2), (5, 1, 1, 1)))))), 4, 4),
    "pb_rf_fabric_placement_schedule": (lambda m: m.PCSConfig(
        scheme=m.Scheme.PB_RF, n_cores=4, n_tenants=4,
        fabric=m.FabricTopology(2, (4, 4), 4, m.Schedule(
            (BOUND,), (leaf_placement(4, 2, "packed"),
                       tuple(1 - p for p in leaf_placement(4, 2,
                                                           "packed")))))),
        4, 4),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_fuzzed_schedules_match_reference_oracle(ref, name, seed):
    make, n_cores, n_tenants = CONFIGS[name]
    steps = fuzz_steps(seed, n_cores, n_tenants, p_persist=0.7)
    got = drive(PS, make(PP), steps)
    want = drive(ref.semantics, make(ref.params), steps)
    assert got == want, (name, seed)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_random_schedules_match_reference_oracle(ref, name):
    make, _, n_tenants = CONFIGS[name]
    steps = random_steps(17, n_tenants=n_tenants)
    got = drive(PS, make(PP), steps)
    want = drive(ref.semantics, make(ref.params), steps)
    assert got == want, name


@pytest.mark.parametrize("lat_target", [1.0, 1e12])
def test_slo_hint_matches_reference_oracle(ref, lat_target):
    """The serving-SLO drain tightening driven by the lat_over hint."""
    def make(m):
        return m.PCSConfig(scheme=m.Scheme.PB_RF, n_pbe=4, n_cores=4,
                           n_tenants=2, policy=m.PBPolicy(
                               drain=m.DrainPolicy(
                                   latency_target_ns=lat_target)))
    steps = fuzz_steps(3, 4, 2, p_persist=0.7,
                       lat_over=lat_target <= 1.0)
    assert drive(PS, make(PP), steps) == \
        drive(ref.semantics, make(ref.params), steps)


# ---- the property tests of tests/test_semantics.py, on the port --------
SCHEMES = [S.NOPB, S.PB, S.PB_RF]


def run_schedule(scheme, n_pbe, ops, ack_order):
    """``tests/_semantics_driver.run_schedule`` on the port's oracle."""
    pb = PS.PersistentBuffer(PP.PCSConfig(scheme=scheme, n_pbe=n_pbe))
    acked, pending, reads, version_of_payload = {}, [], [], {}
    ai = 0
    for op, addr in ops:
        if op == "persist":
            payload = f"{addr}@{len(version_of_payload)}"
            for e in pb.persist(addr, payload):
                if e.kind in (PS.EventKind.PERSIST_ACK,
                              PS.EventKind.COALESCED):
                    acked[e.addr] = max(acked.get(e.addr, -1), e.version)
                    version_of_payload[(e.addr, e.version)] = payload
                if e.kind == PS.EventKind.DRAIN_SENT:
                    pending.append((e.addr, e.version))
        elif op == "ack" and pending:
            i = ack_order[ai % len(ack_order)] % len(pending)
            ai += 1
            a, _ = pending[i]
            a, v = min((p for p in pending if p[0] == a),
                       key=lambda p: p[1])
            pending.remove((a, v))
            for e in pb.pm_ack(a, v):
                if e.kind == PS.EventKind.DRAIN_SENT:
                    pending.append((e.addr, e.version))
                if e.kind in (PS.EventKind.PERSIST_ACK,
                              PS.EventKind.COALESCED):
                    acked[e.addr] = max(acked.get(e.addr, -1), e.version)
        else:
            data, ev = pb.read(addr)
            reads.append((addr, data, ev))
        pb.check_invariants()
    return pb, acked, reads


def _random_schedule(rng, n_ops=120, n_addrs=6):
    ops = [(rng.choice(["persist", "ack", "read"]), rng.randrange(n_addrs))
           for _ in range(n_ops)]
    ack_order = [rng.randrange(32) for _ in range(16)]
    return ops, ack_order


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_crash_consistency_random_schedules(scheme, seed):
    """No acked version is lost across crash + recovery."""
    rng = random.Random(1000 * int(scheme) + seed)
    ops, ack_order = _random_schedule(rng)
    pb, acked, _ = run_schedule(scheme, 2 + seed, ops, ack_order)
    pb.crash()
    pb.recover()
    for addr, ver in acked.items():
        rec = pb.pm.read(addr)
        assert rec is not None, f"acked addr {addr} lost"
        assert rec[0] >= ver, f"addr {addr}: pm={rec[0]} < acked={ver}"


@pytest.mark.parametrize("scheme", [S.PB, S.PB_RF])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_write_read_order_random_schedules(scheme, seed):
    """Reads of every acked address observe the newest acked version or
    newer."""
    rng = random.Random(2000 * int(scheme) + seed)
    ops, ack_order = _random_schedule(rng, n_addrs=4)
    pb, acked, _ = run_schedule(scheme, 2 + seed, ops, ack_order)
    for addr, ver in acked.items():
        data, ev = pb.read(addr)
        assert data is not None
        assert ev.version >= ver or ev.kind == PS.EventKind.READ_FROM_PM


def test_nopb_is_write_through():
    pb = PS.PersistentBuffer(PP.PCSConfig(scheme=S.NOPB, n_pbe=4))
    for i in range(10):
        pb.persist(i % 3, f"v{i}")
    assert pb.pm.writes_applied == 10
    assert all(e.state.name == "EMPTY" for e in pb.entries)


def test_coalescing_only_in_rf():
    for scheme, expect in [(S.PB, 0), (S.PB_RF, 1)]:
        pb = PS.PersistentBuffer(PP.PCSConfig(scheme=scheme, n_pbe=4))
        pb.persist(1, "a")
        evs = pb.persist(1, "b")
        coal = [e for e in evs if e.kind == PS.EventKind.COALESCED]
        assert len(coal) == expect, scheme


def test_rf_keeps_entries_for_forwarding():
    pb = PS.PersistentBuffer(PP.PCSConfig(scheme=S.PB_RF, n_pbe=8))
    pb.persist(1, "a")
    data, ev = pb.read(1)
    assert ev.kind == PS.EventKind.READ_FROM_PB and data == "a"


def test_pb_drains_immediately():
    pb = PS.PersistentBuffer(PP.PCSConfig(scheme=S.PB, n_pbe=8))
    evs = pb.persist(1, "a")
    assert any(e.kind == PS.EventKind.DRAIN_SENT for e in evs)


def test_stall_when_all_draining():
    pb = PS.PersistentBuffer(PP.PCSConfig(scheme=S.PB, n_pbe=2))
    pb.persist(1, "a")
    pb.persist(2, "b")
    evs = pb.persist(3, "c")  # both entries in Drain, no Empty
    assert any(e.kind == PS.EventKind.STALLED for e in evs)
    # ack frees an entry and retries the stalled write
    evs = pb.pm_ack(1, 1)
    assert any(e.kind == PS.EventKind.PERSIST_ACK and e.addr == 3
               for e in evs)


def test_rf_threshold_preset_invariant_deterministic():
    """Under PB_RF the Dirty count never exceeds the drain threshold
    (the drain-down runs to the preset, Section V-D1)."""
    rng = random.Random(7)
    for n_pbe in (4, 8, 16):
        cfg = PP.PCSConfig(scheme=S.PB_RF, n_pbe=n_pbe)
        pb = PS.PersistentBuffer(cfg)
        for i in range(200):
            pb.persist(rng.randrange(30), f"v{i}")
            dirty = sum(1 for e in pb.entries
                        if e.state == PP.PBEState.DIRTY)
            assert dirty <= max(cfg.threshold_count, cfg.preset_count + 1), (
                dirty, cfg.threshold_count)
            pb.check_invariants()


def test_rf_keep_one_free_drains_early():
    """The keep-one-free heuristic (params.rf_drain_count): with the
    Empty pool exhausted, PB_RF drains LRU Dirty entries early."""
    from repro_torch.core.engine.policy import (RF_EMPTY_SLACK,
                                                RF_LOW_WATER_DRAINS,
                                                rf_drain_count)
    assert rf_drain_count(dirty=3, empty=RF_EMPTY_SLACK, threshold=7,
                          preset=4) == min(RF_LOW_WATER_DRAINS, 3)
    assert rf_drain_count(dirty=7, empty=5, threshold=7, preset=4) == 3
    assert rf_drain_count(dirty=3, empty=5, threshold=7, preset=4) == 0
    pb = PS.PersistentBuffer(PP.PCSConfig(scheme=S.PB_RF, n_pbe=4))
    for a in (0, 1, 2):   # third persist leaves <= 1 Empty slot
        pb.persist(a, "x")
    assert sum(1 for e in pb.entries if e.state == PP.PBEState.DRAIN) >= 1


@pytest.mark.parametrize("scheme", [S.PB, S.PB_RF])
@pytest.mark.parametrize("seed", [11, 12])
def test_snapshot_durable_predicts_recovery(scheme, seed):
    """The non-mutating durable snapshot equals what crash + recover
    leaves in PM."""
    rng = random.Random(seed)
    ops = [(rng.choice(["persist", "ack", "read"]), rng.randrange(5))
           for _ in range(120)]
    pb, _acked, _reads = run_schedule(scheme, 4, ops, [3, 0, 2, 1])
    snap = {a: rec[0] for a, rec in pb.snapshot_durable().items()}
    pb.crash()
    pb.recover()
    assert {a: rec[0] for a, rec in pb.pm.store.items()} == snap
