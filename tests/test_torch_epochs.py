"""Epoch schedules in the port: the port's engine against the JAX engine.

``step.resolve_epoch_sc`` against the reference's on seeded numpy
operands; the eager ``simulate_grid(device="cpu")`` against the
reference's ``simulate_grid`` (``macro=False``) and against the port's
oracle on the epoch matrix of ``tests/test_crash_differential.py``
(fuzzed 4-tenant traces x 5 crash points x {quota step, threshold
tighten, static} x NoPB/PB/PB_RF, plus the placement flip x PB/PB_RF;
the boundary half a slot after slot 25), every ``SimResult`` field equal
(``_torch_ref.assert_same_result``: exact, the derived means within 1
ulp).  Then ``tests/test_epoch_schedules.py``'s single-epoch identity
and mid-epoch crash against the reference, two identities of the port's
own (equal epochs are the static config; a static config inside a
scheduled grid is itself alone), ``benchmarks/fig_dynamic.py``'s grid at
its smoke size against ``testdata/dynamic_ref.json``, the datum's shape,
and the kernel's epoch bound.
"""
import json
import os

import numpy as np
import pytest
import torch

from _torch_crash_driver import assert_cell_matches, oracle_replay
from chip_smoke import EPOCH_CRASH_SLOTS as CRASH_SLOTS, epoch_matrix
from _torch_ref import assert_same_result, ref_config, reference
import repro_torch
import repro_torch.core as P
from repro_torch.core.engine.state import (EPOCH_KEYS, INF, N_HOP_STATS,
                                           N_STATS, result_from_stats,
                                           scalars_from_config)
from repro_torch.core.engine.step import resolve_epoch_sc
from repro_torch.kernels import cell_scan as cs

N_ADDRS = 6
N_SLOTS = 50
N_TENANTS = N_CORES = 4
DATUM = os.path.join(os.path.dirname(repro_torch.__file__), "testdata",
                     "dynamic_ref.json")


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


# ---- resolve_epoch_sc -------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_resolve_epoch_sc_matches_reference(ref, seed):
    """Seeded epoch rows and bounds (INF-padded past the config's own),
    resolved at issue times on, between and past the bounds: the same
    rows and next boundary as the reference's, a boundary instant in the
    new epoch, the padding never selected, no next boundary without a
    schedule."""
    rng = np.random.default_rng(seed)
    E, T, D1 = (2, 3, 5, 8)[seed], 3, 2
    n_real = int(rng.integers(1, E))            # bounds of the config's own
    bounds = np.full(E - 1, INF)
    bounds[:n_real] = np.sort(rng.uniform(1e3, 1e6, n_real))
    shapes = dict(threshold_count=(), preset_count=(), lat_target=(),
                  quota=(T,), share=(T,), t_threshold=(T,), t_preset=(T,),
                  deep_thr=(D1,), deep_pre=(D1,), leaf_of_t=(T,))
    assert set(shapes) == set(EPOCH_KEYS)
    sc_np = {k: rng.uniform(0, 9, (E,) + s) for k, s in shapes.items()}
    sc_np.update(n_pbe=np.float64(8), deep_pbe=rng.uniform(0, 9, D1),
                 epoch_bounds=bounds)
    times = [0.0, float(bounds[0]), np.nextafter(bounds[0], 0.0),
             float(bounds[n_real - 1]), 2e6, 0.5 * INF]
    sc_t = {k: torch.as_tensor(v) for k, v in sc_np.items()}
    with ref.x64():
        import jax.numpy as jnp
        from repro.core.engine.step import resolve_epoch_sc as ref_resolve
        sc_j = {k: jnp.asarray(v) for k, v in sc_np.items()}
        want = [ref_resolve(sc_j, jnp.float64(t)) for t in times]
    for t, (w, w_next) in zip(times, want):
        got, nxt = resolve_epoch_sc(sc_t, torch.tensor(t, dtype=torch.float64))
        assert nxt.dtype == torch.float64
        assert float(nxt) == float(w_next), (t, float(nxt), float(w_next))
        later = bounds[bounds > t]
        assert float(nxt) == (float(later.min()) if len(later) else INF)
        assert set(got) == set(w) == set(sc_np) - {"epoch_bounds"}
        for k in got:
            assert got[k].dtype == torch.float64
            assert np.array_equal(got[k].numpy(), np.asarray(w[k])), (t, k)
        ep = int((bounds <= t).sum())
        assert np.array_equal(got["quota"].numpy(), sc_np["quota"][ep])
    assert np.array_equal(
        resolve_epoch_sc(sc_t, torch.tensor(float(bounds[0]),
                                            dtype=torch.float64))[0]["quota"],
        sc_np["quota"][1])
    flat = {k: v[0] if k in EPOCH_KEYS else v
            for k, v in sc_t.items() if k != "epoch_bounds"}
    got, nxt = resolve_epoch_sc(flat, torch.tensor(5e5))
    assert got is flat and nxt is None


# ---- the matrix against the reference ---------------------------------------
_PORT = {}


def port_matrix(seed):
    """The matrix through the eager engine, once per seed."""
    if seed not in _PORT:
        tr, sched = P.fuzz_trace(seed, n_cores=N_CORES, n_slots=N_SLOTS,
                                 n_addrs=N_ADDRS, n_tenants=N_TENANTS,
                                 p_persist=0.7)
        plan, cfgs, pols, fab = epoch_matrix(P)
        assert {c.n_epochs for c in cfgs} == {1, 2}
        cells = P.simulate_grid([tr], cfgs, max_pbe=8, track_addrs=N_ADDRS,
                                device="cpu")[0]
        _PORT[seed] = (tr, sched, plan, pols, fab, cells)
    return _PORT[seed]


@pytest.mark.parametrize("seed", range(3))
def test_epoch_matrix_matches_reference(ref, seed):
    """55 cells a seed in one grid (E = 2, D = 1, NL = 2), every
    SimResult field equal to the reference's."""
    R = ref.core
    tr, _ = ref.traces.fuzz_trace(seed, n_cores=N_CORES, n_slots=N_SLOTS,
                                  n_addrs=N_ADDRS, n_tenants=N_TENANTS,
                                  p_persist=0.7)
    plan, rcfg, _, _ = epoch_matrix(R)
    want = ref.grid.simulate_grid([tr], rcfg, max_pbe=8, bucket=512,
                                  track_addrs=N_ADDRS, macro=False)[0]
    ptr, _, pplan, _, _, got = port_matrix(seed)
    assert np.array_equal(ptr.ops, tr.ops)
    for (s, k, v), g, w in zip(pplan, got, want):
        assert_same_result(g, w, (seed, s.name, k, v))
    # the schedules move the results: a quota step and a threshold
    # tighten each differ from the static cell somewhere
    by = {(s.name, k, v): g for (s, k, v), g in zip(pplan, got)}

    def key(r):
        return (r.runtime_ns, r.persist_lat_ns, r.coalesces, r.pm_writes,
                r.stall_ns, r.victim_drains)
    for v in ("quota", "threshold"):
        assert any(key(by[(s, k, v)]) != key(by[(s, k, "static")])
                   for s in ("PB", "PB_RF") for k in CRASH_SLOTS), v


@pytest.mark.parametrize("seed", range(3))
def test_epoch_matrix_matches_oracle(seed):
    """The same cells against the port's epoch-aware oracle: durable
    versions, counts, per-tenant rows and per-leaf survivors."""
    tr, sched, plan, pols, fab, cells = port_matrix(seed)
    ct = P.tenant_ids(tr.lengths, N_TENANTS)
    for (s, k, v), r in zip(plan, cells):
        oracle = oracle_replay(sched, k, s, 8, core_tenant=ct,
                               n_tenants=N_TENANTS,
                               policy=None if v == "placement" else pols[v],
                               fabric=fab if v == "placement" else None)
        assert_cell_matches(r, oracle, N_ADDRS, label=(seed, s.name, k, v))


def test_scheduled_chain_thresholds_match_reference(ref):
    """Drain thresholds stepped down and up over switch chains of 2-4
    switches (the deep rows' thresholds step with hop 1's): a row left
    over its new count drains on the next persist's forwards even when
    they carry no packet, as the reference's always-run forwards do."""
    R = ref.core
    rtr = ref.traces.make_trace("radiosity", persist_budget=100)
    ptr = P.trace_from_arrays(rtr.name, rtr.ops, rtr.addrs, rtr.gaps,
                              rtr.lengths)
    cfgs = [P.PCSConfig(scheme=P.Scheme.PB_RF, n_switches=n,
                        policy=P.PBPolicy(drain=P.DrainPolicy(
                            threshold=P.Schedule((1e4,), v), preset=0.25)))
            for n in (2, 3, 4) for v in ((0.8, 0.5), (0.5, 0.8))]
    want = ref.grid.simulate_grid([rtr], [ref_config(R, c) for c in cfgs],
                                  macro=False)[0]
    got = P.simulate_grid([ptr], cfgs, device="cpu")[0]
    for k, (g, w) in enumerate(zip(got, want)):
        assert_same_result(g, w, k)
        assert g.runtime_ns > 1e4


def test_single_epoch_schedule_matches_reference(ref):
    """``tests/test_epoch_schedules.py:136``: a Schedule with no boundary
    beside the scalar it holds, in one grid, at a mid-run crash and
    uncrashed — the same cells as the reference's, and equal pairs."""
    R = ref.core

    def mk(m, threshold, quota):
        return m.PBPolicy(drain=m.DrainPolicy(threshold=threshold,
                                              preset=0.25),
                          alloc=m.AllocPolicy(tenant_quota=quota))

    def grid(m):
        cfgs = []
        for k in (23, N_SLOTS):
            for pol in (mk(m, 0.75, (3, 3)),
                        mk(m, m.Schedule((), (0.75,)),
                           m.Schedule((), ((3, 3),)))):
                cfgs.append(m.PCSConfig(scheme=m.Scheme.PB_RF, n_pbe=8,
                                        n_cores=4, n_tenants=2, policy=pol)
                            .with_crash(m.fuzz_crash_ns(k)))
        return cfgs
    rtr = [ref.traces.fuzz_trace(s, n_cores=4, n_slots=N_SLOTS,
                                 n_addrs=N_ADDRS, n_tenants=2,
                                 p_persist=0.7)[0] for s in range(2)]
    ptr = [P.fuzz_trace(s, n_cores=4, n_slots=N_SLOTS, n_addrs=N_ADDRS,
                        n_tenants=2, p_persist=0.7)[0] for s in range(2)]
    pcfg = grid(P)
    assert {c.n_epochs for c in pcfg} == {1}
    want = ref.grid.simulate_grid(rtr, grid(R), max_pbe=8, bucket=128,
                                  track_addrs=N_ADDRS, macro=False)
    got = P.simulate_grid(ptr, pcfg, max_pbe=8, track_addrs=N_ADDRS,
                          device="cpu")
    for i in range(2):
        for j in range(len(pcfg)):
            assert_same_result(got[i][j], want[i][j], (i, j))
        for j in range(0, len(pcfg), 2):
            assert_same_result(got[i][j + 1], got[i][j], ("pair", i, j))


def test_mid_epoch_crash_recovers_issue_time_leaf(ref):
    """``tests/test_epoch_schedules.py:172``: entries persisted under
    epoch 0's placement stay on that leaf after the flip — in the port's
    oracle, and in the engine after a crash in epoch 1, equal to the
    reference's cell and to the oracle."""
    place0, place1 = (0, 0, 1, 1), (1, 1, 0, 0)
    fab = P.FabricTopology(2, (4, 4), 4, P.Schedule((1.0e6,),
                                                    (place0, place1)))
    pb = P.PersistentBuffer(P.PCSConfig(scheme=P.Scheme.PB_RF, n_cores=4,
                                        n_tenants=4, fabric=fab))
    assert pb._placement == place0
    for a in range(3):                       # tenant 0 -> leaf 0
        pb.persist(a, ("e0", a), tenant=0)
    pb.set_epoch(pb.epoch_at(2.0e6))
    assert pb.epoch == 1 and pb._placement == place1
    pb.persist(3, ("e1", 3), tenant=0)       # now on leaf 1
    before = pb.snapshot_durable()
    assert pb.leaf_surviving()[:2] == [3, 1]
    pb.crash()
    pb.recover()
    assert {a: r[0] for a, r in pb.pm.store.items()} \
        == {a: r[0] for a, r in before.items()}

    tr, sched = P.fuzz_trace(7, n_cores=4, n_slots=N_SLOTS, n_addrs=N_ADDRS,
                             n_tenants=4, p_persist=0.8)
    fab2 = P.FabricTopology(2, (4, 4), 4, P.Schedule(
        (P.fuzz_crash_ns(25),), (place0, place1)))
    cfg = P.PCSConfig(scheme=P.Scheme.PB_RF, n_cores=4, n_tenants=4,
                      fabric=fab2).with_crash(P.fuzz_crash_ns(36))
    got = P.simulate_grid([tr], [cfg], max_pbe=8, track_addrs=N_ADDRS,
                          device="cpu")[0][0]
    rtr, _ = ref.traces.fuzz_trace(7, n_cores=4, n_slots=N_SLOTS,
                                   n_addrs=N_ADDRS, n_tenants=4,
                                   p_persist=0.8)
    want = ref.grid.simulate_grid([rtr], [ref_config(ref.core, cfg)],
                                  max_pbe=8, bucket=128, track_addrs=N_ADDRS,
                                  macro=False)[0][0]
    assert_same_result(got, want, "mid-epoch crash")
    assert_cell_matches(got, oracle_replay(
        sched, 36, P.Scheme.PB_RF, 8,
        core_tenant=P.tenant_ids(tr.lengths, 4), n_tenants=4, fabric=fab2),
        N_ADDRS, label=("mid-epoch crash",))
    assert int((got.leaf_recovery > 0).sum()) == 2


# ---- identities -------------------------------------------------------------
def _identity_configs(b):
    """A static config per knob a Schedule drives, and its spelling as a
    schedule whose two epochs hold the same value (boundary ``b``)."""
    Sch = P.Schedule
    place = P.leaf_placement(N_TENANTS, 2, "spread")
    pairs = []
    for knob in ("threshold", "quota", "target", "placement"):
        out = []
        for v in ((lambda x: x), (lambda x: Sch((b,), (x, x)))):
            if knob == "threshold":
                kw = dict(n_pbe=8, n_switches=3, policy=P.PBPolicy(
                    drain=P.DrainPolicy(threshold=v(0.5), preset=v(0.25))))
            elif knob == "quota":
                kw = dict(n_pbe=8, policy=P.PBPolicy(alloc=P.AllocPolicy(
                    tenant_quota=v((1, 3, 2, 2)))))
            elif knob == "target":
                kw = dict(n_pbe=8, policy=P.PBPolicy(drain=P.DrainPolicy(
                    latency_target_ns=v(350.0), per_tenant=True)))
            else:
                kw = dict(fabric=P.FabricTopology(2, (4, 4), 4, v(place)))
            out.append(P.PCSConfig(scheme=P.Scheme.PB_RF, n_cores=N_CORES,
                                   n_tenants=N_TENANTS, **kw)
                       .with_crash(P.fuzz_crash_ns(33)))
        pairs.append(tuple(out))
    return pairs


def test_equal_epochs_are_the_static_config():
    """A schedule whose epochs hold equal values, in a scheduled grid
    (E = 2), equals its static config in a schedule-free grid (E = 1),
    for each scheduled knob."""
    tr = P.fuzz_trace(2, n_cores=N_CORES, n_slots=N_SLOTS, n_addrs=N_ADDRS,
                      n_tenants=N_TENANTS, p_persist=0.7)[0]
    pairs = _identity_configs(P.fuzz_crash_ns(20))
    sched = P.simulate_grid([tr], [p[1] for p in pairs], max_pbe=8,
                            track_addrs=N_ADDRS, device="cpu")[0]
    for k, (static, _) in enumerate(pairs):
        alone = P.simulate(tr, static, max_pbe=8, track_addrs=N_ADDRS,
                           device="cpu")
        assert_same_result(sched[k], alone, k)


def test_static_config_in_scheduled_grid_equals_it_alone():
    """Static configs of every kind (depth 1, a 3-switch chain, a
    fabric, a quota, an SLO target) in one grid with a three-epoch
    schedule (E = 3, its bounds INF-padded for them) equal each config
    run alone in its own schedule-free grid."""
    tr = P.fuzz_trace(4, n_cores=N_CORES, n_slots=N_SLOTS, n_addrs=N_ADDRS,
                      n_tenants=N_TENANTS, p_persist=0.7)[0]
    Sch, fb = P.Schedule, P.fuzz_crash_ns
    statics = [p[0] for p in _identity_configs(fb(20))] + [
        P.PCSConfig(scheme=P.Scheme.PB, n_pbe=8, n_cores=N_CORES,
                    n_tenants=N_TENANTS)]
    sched = P.PCSConfig(scheme=P.Scheme.PB_RF, n_pbe=8, n_cores=N_CORES,
                        n_tenants=N_TENANTS, policy=P.PBPolicy(
                            alloc=P.AllocPolicy(tenant_quota=Sch(
                                (fb(10), fb(30)),
                                ((2, 2, 2, 2), (5, 1, 1, 1),
                                 (1, 1, 1, 5))))))
    got = P.simulate_grid([tr], statics + [sched], max_pbe=8,
                          track_addrs=N_ADDRS, device="cpu")[0]
    for k, cfg in enumerate(statics):
        alone = P.simulate(tr, cfg, max_pbe=8, track_addrs=N_ADDRS,
                           device="cpu")
        assert_same_result(got[k], alone, k)


# ---- benchmarks/fig_dynamic.py and its datum --------------------------------
def same_as_datum(r, d, label):
    """A SimResult equal to the one the datum's numbers give."""
    stats = np.asarray([[float(x) for x in row] for row in d["stats"]])
    hs = np.asarray([[float(x) for x in row] for row in d["hop_stats"]])
    want = result_from_stats(
        float(d["runtime_ns"]), stats, crash_at_ns=r.crash_at_ns,
        recovery_entries=d["recovery_entries"],
        recovery_ns=float(d["recovery_ns"]), n_tenants=len(stats),
        tenant_recovery=r.tenant_recovery, n_hops=len(d["hop_recovery"]),
        hop_stats=hs, hop_recovery=np.asarray(d["hop_recovery"]),
        n_leaves=len(d["leaf_recovery_raw"]),
        leaf_recovery=np.asarray(d["leaf_recovery_raw"]))
    assert_same_result(r, want, label)
    assert (r.leaf_recovery is None) == (d["leaf_recovery"] is None)


def test_fig_dynamic_smoke_matches_datum():
    """fig_dynamic's 12 cells at its smoke size (persist_budget 150,
    rates 0.5 and 8 Mops/s a core) in one grid (E = 2, D = 1, NL = 2)
    through the eager engine, equal to the reference's numbers in
    dynamic_ref.json."""
    from chip_smoke import DYN_SMOKE_BUDGET, DYN_SMOKE_RATES, dynamic_grid
    with open(DATUM) as f:
        d = json.load(f)["fig_smoke"]
    traces, labels, configs, bound, crash = dynamic_grid(
        np, DYN_SMOKE_BUDGET, DYN_SMOKE_RATES)
    assert (bound, crash) == (float(d["bound_ns"]), float(d["crash_ns"]))
    assert [int(t.lengths.sum()) for t in traces] == d["total_ops"]
    got = P.simulate_grid(traces, configs, device="cpu")
    for i, r in enumerate(DYN_SMOKE_RATES):
        for lab, res in zip(labels, got[i]):
            same_as_datum(res, d["cells"][f"{r:g}"][lab], (r, lab))


def test_dynamic_ref_datum_holds_the_reference_shape():
    """The datum chip_smoke.py checks against: fig_dynamic's 18 cells at
    its published size and 12 at its smoke size, and the scheduled
    paper grid's 28, each with stats rows of the engine's width, hops
    and leaves as its topology has, per-leaf survivors that sum to hop
    1's, and a boundary inside the published runs."""
    with open(DATUM) as f:
        d = json.load(f)
    assert {"script", "command", "what", "jax_version"} <= set(d)
    assert sorted(d["fig"]["cells"]) == ["0.5", "2", "8"]
    assert sorted(d["fig_smoke"]["cells"]) == ["0.5", "8"]
    assert sorted(d["grid_b"]) == sorted(P.WORKLOADS)
    fig = [(k, c, 4, 2) for g in ("fig", "fig_smoke")
           for v in d[g]["cells"].values() for k, c in v.items()]
    paper = [(k, c, 1, 1) for v in d["grid_b"].values()
             for k, c in v["cells"].items()]
    assert len(fig) == 18 + 12 and len(paper) == 28
    for key, c, T, nl in fig + paper:
        assert len(c["stats"]) == T
        assert all(len(row) == N_STATS for row in c["stats"])
        assert len(c["hop_stats"]) == len(c["hop_recovery"]) == 2
        assert all(len(row) == N_HOP_STATS for row in c["hop_stats"])
        assert len(c["leaf_recovery_raw"]) == nl
        assert sum(c["leaf_recovery_raw"]) == c["hop_recovery"][0]
        assert sum(c["hop_recovery"]) == c["recovery_entries"]
        assert sum(float(row[1]) for row in c["stats"]) > 0   # persists
    runtime = max(float(c["runtime_ns"]) for k, c, _, _ in fig[:18])
    assert float(d["fig"]["bound_ns"]) < runtime
    for v in d["grid_b"].values():
        assert float(v["bound_ns"]) < min(float(c["runtime_ns"])
                                          for c in v["cells"].values())


# ---- the kernel's bound -----------------------------------------------------
def test_more_epochs_than_the_kernel_takes_raise():
    """A schedule of MAX_EPOCHS + 1 epochs raises on the port's grid
    (the kernel's bound, as for chains and fabrics); MAX_EPOCHS runs."""
    tr = P.make_trace("radiosity", persist_budget=20)

    def cfg(n):
        b = tuple(1e3 * (i + 1) for i in range(n - 1))
        return P.PCSConfig(scheme=P.Scheme.PB_RF, policy=P.PBPolicy(
            drain=P.DrainPolicy(threshold=P.Schedule(
                b, tuple(0.5 + 0.05 * (i % 2) for i in range(n))),
                preset=0.25)))
    P.simulate_grid([tr], [cfg(cs.MAX_EPOCHS)], device="cpu")
    with pytest.raises(ValueError, match="epochs"):
        P.simulate_grid([tr], [cfg(cs.MAX_EPOCHS + 1)], device="cpu")
    sc = scalars_from_config(cfg(3), 1, n_epochs_max=3)
    assert sc["epoch_bounds"].shape == (2,) and bool(
        (sc["epoch_bounds"] < INF).all())
    assert not torch.equal(sc["threshold_count"][0],
                           sc["threshold_count"][1])
