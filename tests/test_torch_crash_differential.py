"""Differential crash-point conformance of the port: the port's eager
engine (``repro_torch.core.simulate_grid`` on the CPU) against the
port's untimed oracle (``repro_torch.core.semantics``).

The matrices are those of ``tests/test_crash_differential.py``: fuzzed
multi-core persist/read/barrier interleavings (``fuzz_trace``), the
engine crashed at a slot boundary (``crash_at_ns``) and the oracle after
replaying the same slots, with exact agreement on the durable state
after recovery, the event counts, the per-tenant rows and the per-hop
survivor and telemetry rows (``tests/_torch_crash_driver.py``).  Each
matrix is parametrised by fuzz seed.  The single-core count checks of
``tests/test_engine_oracle.py`` close the file.
"""
import random

import numpy as np
import pytest

from _torch_crash_driver import assert_cell_matches, oracle_replay
from repro_torch.core import (AllocPolicy, DrainPolicy, Op, PBPolicy,
                              PCSConfig, Scheme, fuzz_crash_ns, fuzz_trace,
                              simulate, simulate_grid, tenant_ids,
                              trace_from_arrays)
from repro_torch.core.semantics import EventKind, PersistentBuffer

SCHEMES = [Scheme.NOPB, Scheme.PB, Scheme.PB_RF]
N_ADDRS = 6
N_SLOTS = 50
N_CORES = 3
CRASH_SLOTS = (0, 7, 13, 21, 29, 37, 44, N_SLOTS)
PBES = (2, 4, 8)         # cycles across crash points


def _grid(traces, configs, max_pbe):
    return simulate_grid(list(traces), configs, max_pbe=max_pbe,
                         track_addrs=N_ADDRS, device="cpu")


@pytest.mark.parametrize("seed", range(9))
def test_differential_matrix(seed):
    """9 seeds x 24 (scheme, crash point, capacity) cells: 216 cells."""
    tr, sched = fuzz_trace(seed, n_cores=N_CORES, n_slots=N_SLOTS,
                           n_addrs=N_ADDRS)
    plan = [(scheme, k, PBES[ki % len(PBES)])
            for scheme in SCHEMES for ki, k in enumerate(CRASH_SLOTS)]
    configs = [PCSConfig(scheme=s, n_pbe=p).with_crash(fuzz_crash_ns(k))
               for s, k, p in plan]
    cells = _grid([tr], configs, max(PBES))[0]
    for j, (scheme, k, n_pbe) in enumerate(plan):
        oracle = oracle_replay(sched, k, scheme, n_pbe)
        assert_cell_matches(cells[j], oracle, N_ADDRS,
                            label=(seed, scheme.name, k, n_pbe))


def _tenant_matrix(seed, plan_of, p_persist=None):
    n_tenants, n_cores = 2, 4
    kw = {} if p_persist is None else dict(p_persist=p_persist)
    tr, sched = fuzz_trace(seed, n_cores=n_cores, n_slots=N_SLOTS,
                           n_addrs=N_ADDRS, n_tenants=n_tenants, **kw)
    plan = plan_of()
    configs = [PCSConfig(scheme=s, n_pbe=p, n_cores=n_cores,
                         n_tenants=n_tenants,
                         policy=pol).with_crash(fuzz_crash_ns(k))
               for s, k, p, pol in plan]
    cells = _grid([tr], configs, max(PBES))[0]
    core_tenant = tenant_ids(tr.lengths, n_tenants)
    for j, (scheme, k, n_pbe, pol) in enumerate(plan):
        oracle = oracle_replay(sched, k, scheme, n_pbe,
                               core_tenant=core_tenant,
                               n_tenants=n_tenants, policy=pol)
        assert_cell_matches(cells[j], oracle, N_ADDRS,
                            label=(seed, scheme.name, k, n_pbe, pol))
    return cells, plan


@pytest.mark.parametrize("seed", range(4))
def test_differential_matrix_multi_tenant(seed):
    """T=2 tenants sharing the PB/PBC/PM: durable state and per-tenant
    accounting at every crash point."""
    def plan():
        return [(s, k, PBES[ki % len(PBES)], None) for s in SCHEMES
                for ki, k in enumerate((0, 11, 23, 36, N_SLOTS))]
    _tenant_matrix(seed, plan)


@pytest.mark.parametrize("seed", range(4))
def test_differential_matrix_quota_policies(seed):
    """Per-tenant quotas, weighted victims and tenant-scoped drain-down,
    mixed with the default policy in one grid."""
    policies = {
        2: PBPolicy(alloc=AllocPolicy(tenant_quota=(1, 1))),
        4: PBPolicy(alloc=AllocPolicy(victim="weighted",
                                      tenant_quota=(1, 3))),
        8: PBPolicy(drain=DrainPolicy(per_tenant=True),
                    alloc=AllocPolicy(tenant_quota=(2, 5))),
    }

    def plan():
        out = []
        for s in SCHEMES:
            for ki, k in enumerate((0, 11, 23, 36, N_SLOTS)):
                n_pbe = PBES[ki % len(PBES)]
                out.append((s, k, n_pbe, policies[n_pbe]))
                out.append((s, k, n_pbe, None))
        return out
    _tenant_matrix(seed, plan, p_persist=0.7)


@pytest.mark.parametrize("seed", range(4))
def test_differential_matrix_latency_target(seed):
    """Extreme latency targets (1 ns: every ack is over; 1e12 ns: none
    is) against the oracle's SLO twin; the never-reached target must
    equal no target in every field."""
    tight = PBPolicy(drain=DrainPolicy(latency_target_ns=1.0))
    never = PBPolicy(drain=DrainPolicy(latency_target_ns=1e12))

    def plan():
        return [(s, k, PBES[ki % len(PBES)], pol) for s in SCHEMES
                for ki, k in enumerate((0, 11, 23, 36, N_SLOTS))
                for pol in (tight, never, None)]
    cells, plan_ = _tenant_matrix(seed, plan, p_persist=0.7)
    from _torch_ref import assert_same_result
    for j in range(0, len(plan_), 3):
        assert_same_result(cells[j + 1], cells[j + 2],
                           ("huge-vs-none", seed, plan_[j][0].name))


CHAINS = [(1, None), (2, (3, 3)), (3, (3, 2, 1))]


@pytest.mark.parametrize("seed", range(5))
def test_differential_matrix_switch_chains(seed):
    """3 schemes x depths 1..3 (uniform, and a bypass-heavy chain whose
    deep hops are smaller than hop 1) x 5 crash points, one mixed-depth
    grid per seed: 45 cells a seed, 225 in all.  Per-hop survivors and
    telemetry rows must match the oracle's."""
    tr, sched = fuzz_trace(seed, n_cores=N_CORES, n_slots=N_SLOTS,
                           n_addrs=N_ADDRS, p_persist=0.7)
    plan = [(s, d, hp, k) for s in SCHEMES for d, hp in CHAINS
            for k in (0, 11, 23, 36, N_SLOTS)]
    configs = [PCSConfig(scheme=s, n_pbe=3, n_switches=d,
                         pbe_per_hop=None if s == Scheme.NOPB else hp
                         ).with_crash(fuzz_crash_ns(k))
               for s, d, hp, k in plan]
    cells = _grid([tr], configs, 3)[0]
    for j, (scheme, d, hp, k) in enumerate(plan):
        oracle = oracle_replay(sched, k, scheme, 3, n_switches=d,
                               pbe_per_hop=hp)
        assert_cell_matches(cells[j], oracle, N_ADDRS,
                            label=("CHAIN", seed, scheme.name, d, hp, k))


# ---- single-core counts (tests/test_engine_oracle.py) --------------------
GAP_NS = 50_000.0


def _random_ops(seed, n_ops=160, n_addrs=12, p_persist=0.55):
    rng = random.Random(seed)
    return [(Op.PERSIST if rng.random() < p_persist else Op.PM_READ,
             rng.randrange(n_addrs)) for _ in range(n_ops)]


def _as_trace(op_list):
    ops = np.array([[int(o) for o, _ in op_list]], np.int32)
    addrs = np.array([[a for _, a in op_list]], np.int32)
    gaps = np.full(ops.shape, GAP_NS, np.float32)
    return trace_from_arrays("xval", ops, addrs, gaps,
                             np.array([ops.shape[1]], np.int32))


def _oracle_counts(op_list, scheme, n_pbe):
    """Drive the oracle, delivering every pending PM ack between ops."""
    pb = PersistentBuffer(PCSConfig(scheme=scheme, n_pbe=n_pbe))
    pending = []
    victim_drains = 0
    for op, addr in op_list:
        if op == Op.PERSIST:
            events = pb.persist(addr, f"v@{addr}")
            pending += [(e.addr, e.version) for e in events
                        if e.kind == EventKind.DRAIN_SENT]
            victim_drains += sum(
                1 for e in events if e.kind == EventKind.STALLED)
        else:
            pb.read(addr)
        while pending:
            a, v = pending.pop(0)
            events = pb.pm_ack(a, v)
            pending += [(e.addr, e.version) for e in events
                        if e.kind == EventKind.DRAIN_SENT]
    return dict(
        persists=pb.stats["persists"],
        coalesces=pb.stats["coalesces"],
        read_hits=pb.stats["read_hits"],
        pm_reads=pb.stats["read_hits"] + pb.stats["read_misses"],
        pm_writes=(pb.pm.writes_applied if scheme == Scheme.NOPB
                   else pb.stats["drains"]),
        victim_drains=victim_drains,
    )


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("seed,n_pbe", [(0, 8), (1, 8), (2, 4), (3, 16)])
def test_engine_counts_match_oracle(scheme, seed, n_pbe):
    op_list = _random_ops(seed)
    res = simulate(_as_trace(op_list), PCSConfig(scheme=scheme, n_pbe=n_pbe),
                   device="cpu")
    want = _oracle_counts(op_list, scheme, n_pbe)
    got = dict(persists=res.persists, coalesces=res.coalesces,
               read_hits=res.read_hits, pm_reads=res.pm_reads,
               pm_writes=res.pm_writes, victim_drains=res.victim_drains)
    assert got == want, (scheme.name, seed, n_pbe)
