"""Port parity beyond the paper grid: crash cells with durability
tracking, multi-tenant policy cells, and the ``simulate_cells`` /
``simulate`` / ``simulate_sweep`` front-ends, against the JAX engine.

Equality is exact on runtimes, stats-derived fields, ``durable_ver``,
``recovery_entries`` and ``recovery_ns`` (means within 1 ulp).
"""
from __future__ import annotations

import dataclasses

import pytest

from _torch_ref import assert_same_result, reference
import repro_torch.core as P

TINY_BUDGET = 200
TINY_BUCKET = 512


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _port_trace(t):
    return P.trace_from_arrays(t.name, t.ops, t.addrs, t.gaps, t.lengths)


def _port_cfg(c):
    return P.config_from_fields(dataclasses.asdict(c))


def test_crash_cells_match(ref):
    """The chip smoke's phase-3 crash cells at the tiny budget: PB and
    PB_RF on two workloads at three power-loss points, 64 tracked
    addresses."""
    R = ref.params
    traces, configs = [], []
    for w in ("radiosity", "lu_cont"):
        tr = ref.traces.make_trace(w, persist_budget=TINY_BUDGET)
        t_pb = ref.grid.simulate(tr, R.PCSConfig(scheme=R.Scheme.PB),
                                 bucket=TINY_BUCKET, macro=False).runtime_ns
        for s in (R.Scheme.PB, R.Scheme.PB_RF):
            for f in (0.25, 0.5, 0.75):
                traces.append(tr)
                configs.append(R.PCSConfig(scheme=s).with_crash(f * t_pb))
    want = ref.grid.simulate_cells(traces, configs, bucket=TINY_BUCKET,
                                   track_addrs=64, macro=False)
    got = P.simulate_cells([_port_trace(t) for t in traces],
                           [_port_cfg(c) for c in configs],
                           track_addrs=64, device="cpu")
    assert any(w.recovery_entries > 0 for w in want)
    assert any(w.durable_ver.any() for w in want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert_same_result(g, w, ("crash", k))


def test_tenant_policy_cells_match(ref):
    """Two-tenant fuzz traces under quotas, weighted victims, tenant-
    scoped and SLO-tightened drains, with and without a crash."""
    R = ref.params
    pols = [R.PBPolicy(),
            R.PBPolicy(alloc=R.AllocPolicy(victim="weighted")),
            R.PBPolicy(alloc=R.AllocPolicy(tenant_quota=(3, 5))),
            R.PBPolicy(drain=R.DrainPolicy(per_tenant=True,
                                           latency_target_ns=300.0,
                                           latency_tol=0.1))]
    configs = [R.PCSConfig(scheme=s, n_pbe=8, n_tenants=2, policy=p)
               for s in (R.Scheme.PB, R.Scheme.PB_RF) for p in pols]
    configs += [c.with_crash(2.5e7) for c in configs[:3]]
    configs.append(R.PCSConfig(scheme=R.Scheme.NOPB, n_pbe=8, n_tenants=2))
    fz = [ref.traces.fuzz_trace(seed, n_cores=4, n_slots=120,
                                n_tenants=2)[0] for seed in range(2)]
    traces = [fz[k % 2] for k in range(len(configs))]
    want = ref.grid.simulate_cells(traces, configs, bucket=TINY_BUCKET,
                                   track_addrs=8, macro=False)
    got = P.simulate_cells([_port_trace(t) for t in traces],
                           [_port_cfg(c) for c in configs],
                           track_addrs=8, device="cpu")
    assert any(w.tenant_stats is not None for w in want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert_same_result(g, w, ("tenants", k))


def test_simulate_and_sweep_wrappers_match(ref):
    R = ref.params
    tr = ref.traces.make_trace("raytrace", persist_budget=60)
    configs = [R.PCSConfig(scheme=s, n_pbe=n)
               for s in (R.Scheme.PB, R.Scheme.PB_RF) for n in (4, 33)]
    configs.append(R.PCSConfig(scheme=R.Scheme.NOPB, n_switches=0))
    want = ref.grid.simulate_sweep(tr, configs, bucket=TINY_BUCKET)
    got = P.simulate_sweep(_port_trace(tr), [_port_cfg(c) for c in configs],
                           device="cpu")
    for k, (g, w) in enumerate(zip(got, want)):
        assert_same_result(g, w, ("sweep", k))
    one = P.simulate(_port_trace(tr), _port_cfg(configs[1]), device="cpu")
    assert_same_result(one, want[1], "simulate")
