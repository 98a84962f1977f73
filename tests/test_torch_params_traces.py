"""Port parity: configs and traces (``repro_torch.core.params`` /
``traces``) against the JAX reference's.

Every config field, derived value and validation error must match;
the drain-count helpers must agree over grids of inputs; and the trace
generators must be byte-equal for equal seeds.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

from _torch_ref import reference
from repro_torch.core import params as P
from repro_torch.core import traces as TR

TINY_BUDGET = 200                    # the conftest tiny-trace settings
TINY_TRACE_KW = {"fft": {"m": 9}}


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _policies(m):
    """The same policy objects built from either package's ``params``."""
    return [
        m.PBPolicy(),
        m.PBPolicy(alloc=m.AllocPolicy(victim="weighted")),
        m.PBPolicy(alloc=m.AllocPolicy(tenant_quota=(3, 5))),
        m.PBPolicy(drain=m.DrainPolicy(per_tenant=True,
                                       latency_target_ns=300.0,
                                       latency_tol=0.1)),
        m.PBPolicy(drain=m.DrainPolicy(threshold=0.5, preset=0.25,
                                       low_water_drains=0, empty_slack=0)),
        m.PBPolicy(drain=m.DrainPolicy(
            threshold=m.Schedule((1e5,), (0.8, 0.5)),
            preset=m.Schedule((1e5,), (0.6, 0.25)))),
        m.PBPolicy(alloc=m.AllocPolicy(
            tenant_quota=m.Schedule((5e4, 9e4), ((3, 5), None, (6, 2))))),
    ]


def _configs(m):
    S = m.Scheme
    out = [m.PCSConfig(scheme=s) for s in S]
    out += [m.PCSConfig(scheme=S.PB_RF, n_pbe=n, pm_banks=b)
            for n, b in ((8, 1), (33, 3), (128, 8))]
    out += [m.PCSConfig(scheme=S.PB_RF, n_tenants=2, policy=p)
            for p in _policies(m)]
    out += [m.PCSConfig(scheme=S.PB, crash_at_ns=1234.5),
            m.PCSConfig(scheme=S.NOPB, n_switches=0),
            m.PCSConfig(scheme=S.PB, n_switches=3, pbe_per_hop=(16, 8, 4)),
            m.PCSConfig(scheme=S.PB_RF, drain_threshold=0.9,
                        drain_preset=0.3),
            m.PCSConfig(scheme=S.PB_RF, n_tenants=2, fabric=m.FabricTopology(
                n_leaves=2, leaf_pbe=(8, 8), spine_pbe=16, placement=(0, 1),
                bp_high=4.0)),
            m.PCSConfig(scheme=S.PB, latency=m.LatencyProfile(
                link_ns=70.0, nvm_write_ns=300.0))]
    return out


def _derived(c):
    return (c.hop_pbes, c.max_hop_pbe, c.threshold_count, c.preset_count,
            c.n_epochs, c.epoch_boundaries)


@pytest.mark.parametrize("k", range(len(_configs(P))))
def test_config_fields_and_derived_values_match(ref, k):
    rc = _configs(ref.params)[k]
    pc = P.config_from_fields(dataclasses.asdict(rc))
    assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    assert pc == _configs(P)[k]
    assert _derived(pc) == _derived(rc)
    lat_r, lat_p = rc.latency, pc.latency
    for n in (0, 1, 2, 3):
        assert lat_p.oneway_cpu_pm(n) == lat_r.oneway_cpu_pm(n)
        assert lat_p.oneway_cpu_sw1(n) == lat_r.oneway_cpu_sw1(n)
        assert lat_p.oneway_sw1_pm(n) == lat_r.oneway_sw1_pm(n)
    for n in (1, 7, 16, 33, 128):
        assert lat_p.pb_tag_ns_for(n) == lat_r.pb_tag_ns_for(n)
        assert lat_p.pb_data_ns_for(n) == lat_r.pb_data_ns_for(n)
    assert lat_p.hop_ns() == lat_r.hop_ns()


BAD = [
    ("PCSConfig", dict(n_pbe=0)),
    ("PCSConfig", dict(n_switches=-1)),
    ("PCSConfig", dict(scheme="PB", n_switches=0)),
    ("PCSConfig", dict(scheme="NOPB", pbe_per_hop=(4,))),
    ("PCSConfig", dict(n_switches=2, pbe_per_hop=(4,))),
    ("PCSConfig", dict(n_switches=2, pbe_per_hop=(4, 0))),
    ("PCSConfig", dict(n_tenants=0)),
    ("PCSConfig", dict(n_tenants=9)),
    ("PCSConfig", dict(drain_threshold=0.5, drain_preset=0.7)),
    ("PCSConfig", dict(crash_at_ns=-1.0)),
    ("PCSConfig", dict(n_tenants=2, policy="quota_too_big")),
    ("PCSConfig", dict(n_tenants=2, policy="quota_wrong_len")),
    ("PCSConfig", dict(scheme="NOPB", fabric="fab")),
    ("PCSConfig", dict(fabric="fab", n_switches=3)),
    ("PCSConfig", dict(fabric="fab", n_tenants=2)),
    ("PCSConfig", dict(policy="schedules_disagree")),
    ("DrainPolicy", dict(threshold=0.5, preset=0.7)),
    ("DrainPolicy", dict(low_water_drains=-1)),
    ("DrainPolicy", dict(latency_target_ns=0.0)),
    ("DrainPolicy", dict(latency_tol=1.0)),
    ("AllocPolicy", dict(victim="random")),
    ("AllocPolicy", dict(tenant_quota=(0, 2))),
    ("AllocPolicy", dict(tenant_quota=())),
    ("FabricTopology", dict(n_leaves=0)),
    ("FabricTopology", dict(n_leaves=2, leaf_pbe=(8,))),
    ("FabricTopology", dict(leaf_pbe=(0,))),
    ("FabricTopology", dict(spine_pbe=0)),
    ("FabricTopology", dict(placement=(1,))),
    ("FabricTopology", dict(placement=())),
    ("FabricTopology", dict(bp_high=0.5)),
    ("FabricTopology", dict(bp_high=2.0)),
    ("Schedule", dict(boundaries_ns=(1.0,), values=(1,))),
    ("Schedule", dict(boundaries_ns=(-1.0,), values=(1, 2))),
    ("Schedule", dict(boundaries_ns=(2.0, 1.0), values=(1, 2, 3))),
]


def _build(m, cls, kw):
    kw = dict(kw)
    if isinstance(kw.get("scheme"), str):
        kw["scheme"] = m.Scheme[kw["scheme"]]
    pol = kw.get("policy")
    if pol == "quota_too_big":
        kw["policy"] = m.PBPolicy(alloc=m.AllocPolicy(tenant_quota=(9, 9)))
    elif pol == "quota_wrong_len":
        kw["policy"] = m.PBPolicy(alloc=m.AllocPolicy(tenant_quota=(3,)))
    elif pol == "schedules_disagree":
        kw["policy"] = m.PBPolicy(drain=m.DrainPolicy(
            threshold=m.Schedule((1.0,), (0.8, 0.9)),
            preset=m.Schedule((2.0,), (0.5, 0.6))))
    if kw.get("fabric") == "fab":
        kw["fabric"] = m.FabricTopology(n_leaves=2, leaf_pbe=(8, 8),
                                        placement=(0,))
    return getattr(m, cls)(**kw)


@pytest.mark.parametrize("cls,kw", BAD)
def test_validation_errors_match(ref, cls, kw):
    with pytest.raises(ValueError) as want:
        _build(ref.params, cls, kw)
    with pytest.raises(ValueError) as got:
        _build(P, cls, kw)
    assert str(got.value) == str(want.value)


def test_drain_count_helpers_match_over_grids(ref):
    R = ref.params
    fracs = (0.05, 0.25, 0.5, 0.6, 0.8, 0.95, 1.0)
    for n in (1, 2, 3, 7, 8, 16, 17.5, 33, 64, 128):
        for f in fracs:
            assert P.threshold_count(n, f) == R.threshold_count(n, f)
            assert P.preset_count(n, f) == R.preset_count(n, f)
    for d in range(0, 20):
        for e in range(0, 6):
            for thr in (1, 4, 13):
                for pre in (0, 3, 9):
                    for lw in (0, 2):
                        for slack in (0, 1):
                            args = (d, e, thr, pre, lw, slack)
                            assert P.rf_drain_count(*args) == \
                                R.rf_drain_count(*args)
    pols_r, pols_p = _policies(R), _policies(P)
    for pr, pp in zip(pols_r, pols_p):
        for e in range(3):
            rr, rp = R.resolve_epoch(pr, e), P.resolve_epoch(pp, e)
            assert dataclasses.asdict(rp) == dataclasses.asdict(rr)
            for hops in ((16,), (16, 8), (16, 8, 4)):
                assert P.hop_drain_counts(rp, hops) == \
                    R.hop_drain_counts(rr, hops)
            for n_pbe, nt in ((16, 2), (8, 2), (33, 2)):
                if pp.alloc.tenant_quota is not None and \
                        rp.alloc.tenant_quota is not None and \
                        sum(rp.alloc.tenant_quota) > n_pbe:
                    continue
                assert P.tenant_drain_counts(rp, n_pbe, nt) == \
                    R.tenant_drain_counts(rr, n_pbe, nt)
    bounds = (10.0, 20.0, 35.5)
    for x in (0.0, 9.99, 10.0, 10.01, 20.0, 35.5, 1e9):
        assert P.epoch_index(bounds, x) == R.epoch_index(bounds, x)
    for live in (0, 3, 4, 5):
        for bp in (4.0, math.inf):
            assert P.spine_defer(live, bp) == R.spine_defer(live, bp)
    fr = R.FabricTopology(n_leaves=3, leaf_pbe=(4, 8, 2), placement=(2, 0))
    fp = P.FabricTopology(n_leaves=3, leaf_pbe=(4, 8, 2), placement=(2, 0))
    assert fp.leaf_bases() == fr.leaf_bases()


def _same_trace(a, b):
    for f in ("ops", "addrs", "gaps", "lengths"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert a.name == b.name


@pytest.mark.parametrize("name", sorted(TR.WORKLOADS))
def test_workload_traces_byte_equal(ref, name):
    kw = TINY_TRACE_KW.get(name, {})
    rt = ref.traces.make_trace(name, persist_budget=TINY_BUDGET, **kw)
    pt = TR.make_trace(name, persist_budget=TINY_BUDGET, **kw)
    _same_trace(pt, rt)
    back = TR.trace_from_arrays(rt.name, rt.ops, rt.addrs, rt.gaps,
                                rt.lengths)
    _same_trace(back, rt)
    km = ref.params.MACRO_KMAX
    assert np.array_equal(TR.plan_runs(pt.ops, pt.addrs, pt.gaps, km),
                          ref.traces.plan_runs(rt.ops, rt.addrs, rt.gaps, km))


def test_fuzz_compose_and_arrival_traces_byte_equal(ref):
    RT = ref.traces
    for seed in range(4):
        for kw in (dict(), dict(n_cores=4, n_slots=120, n_tenants=2)):
            (pt, ps), (rt, rs) = TR.fuzz_trace(seed, **kw), \
                RT.fuzz_trace(seed, **kw)
            _same_trace(pt, rt)
            assert ps == rs
        assert TR.fuzz_crash_ns(seed) == RT.fuzz_crash_ns(seed)
    parts = [("radiosity", 60), ("lu_cont", 40)]
    _same_trace(TR.make_mixed_tenant_trace(parts),
                RT.make_mixed_tenant_trace(parts))
    _same_trace(TR.make_tenant_trace("fft", 2, persist_budget=80, m=8),
                RT.make_tenant_trace("fft", 2, persist_budget=80, m=8))
    subs_p = [TR.make_trace(n, n_cores=2, persist_budget=40)
              for n in ("radiosity", "raytrace")]
    subs_r = [RT.make_trace(n, n_cores=2, persist_budget=40)
              for n in ("radiosity", "raytrace")]
    _same_trace(TR.compose_tenants(subs_p), RT.compose_tenants(subs_r))
    for arr in ("PoissonArrivals(rate_mops=2.0)",
                "BurstyArrivals(rate_mops=1.0, burst=6.0)",
                "DiurnalArrivals(rate_mops=2.0)"):
        ap, ar = eval("TR." + arr), eval("RT." + arr)
        _same_trace(
            TR.make_offered_load_trace("radiosity", ap, persist_budget=60),
            RT.make_offered_load_trace("radiosity", ar, persist_budget=60))
    lengths = np.asarray([5, 0, 7, 3, 2, 0, 9, 1], np.int32)
    for nt in (1, 2, 3):
        assert np.array_equal(TR.tenant_ids(lengths, nt),
                              RT.tenant_ids(lengths, nt))
    for nt, nl in ((4, 2), (3, 3), (5, 2)):
        for mode in ("packed", "spread"):
            assert TR.leaf_placement(nt, nl, mode) == \
                RT.leaf_placement(nt, nl, mode)
