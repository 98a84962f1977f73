"""Switch chains in the port: the port's engine against the JAX engine.

One ``simulate_cells`` call on each side covers the fuzzed chain crash
matrix (3 schemes x depths 1-3, uniform and bypass-heavy capacities, 5
crash points, 8 tracked addresses), Fig. 1's depth sweep at its smoke
size (``benchmarks/fig1_switch_depth.py``: NoPB at depths 0-4, PB and
PB_RF at 1-4, a crashed replica of each PB cell; 200 persist/read
pairs) and a mixed {scheme x depth x policy} sweep on radiosity at
persist_budget=60.  Every
cell must be equal field by field (``_torch_ref.assert_same_result``):
runtime, stats, ``hop_stats``, ``hop_recovery``, ``durable_ver``,
``recovery_entries`` and ``recovery_ns`` exactly, the means within 1
ulp.  Then the chain acceptance checks of ``tests/test_chain.py`` on the
port: depth-1 cells stay bit-exact inside a mixed-depth grid, a zero-
traffic deep hop reports NaN, and ``pbe_per_hop`` is validated.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from _torch_ref import assert_same_result, reference
import repro_torch.core as P
from repro_torch.core.engine.chain import xla_sum

N_ADDRS = 8
FIG1_DEPTHS = (0, 1, 2, 3, 4)
FIG1_OPS, FIG1_GAP = 200, 2000.0
CHAINS = [(1, None), (2, (3, 3)), (3, (3, 2, 1))]
CRASH_SLOTS = (0, 11, 23, 36, 50)


def fig1_trace(m, n_ops=FIG1_OPS, gap=FIG1_GAP):
    """``benchmarks/fig1_switch_depth._probe_trace`` built with ``m``'s
    ``Op`` and ``Trace`` (the port's or the reference's)."""
    ops, addrs = [], []
    for i in range(n_ops):
        ops += [int(m.Op.PERSIST), int(m.Op.PM_READ)]
        addrs += [i, (1 << 20) + i]
    return m.Trace(ops=np.array([ops], np.int32),
                   addrs=np.array([addrs], np.int32),
                   gaps=np.full((1, len(ops)), gap, np.float32),
                   lengths=np.array([len(ops)], np.int32), name="fig1_probe")


def fig1_plan(m, n_ops=FIG1_OPS, gap=FIG1_GAP):
    """Fig. 1's 21 cells: (label, config)."""
    out = []
    for n_sw in FIG1_DEPTHS:
        out.append((("nopb", n_sw, False),
                    m.PCSConfig(scheme=m.Scheme.NOPB, n_switches=n_sw)))
        if n_sw >= 1:
            for key, s in (("pb", m.Scheme.PB), ("pb_rf", m.Scheme.PB_RF)):
                out.append(((key, n_sw, False),
                            m.PCSConfig(scheme=s, n_switches=n_sw)))
    crash_at = 0.5 * (2 * n_ops) * gap
    for key, s in (("pb", m.Scheme.PB), ("pb_rf", m.Scheme.PB_RF)):
        for n_sw in FIG1_DEPTHS[1:]:
            out.append(((key, n_sw, True), m.PCSConfig(
                scheme=s, n_switches=n_sw).with_crash(crash_at)))
    return out


def cells_of(m, make_trace, fuzz_trace, fuzz_crash_ns):
    """The whole test grid as (group, label, trace, config) rows."""
    rows = []
    for seed in (0, 1):
        tr, _ = fuzz_trace(seed, n_cores=3, n_slots=50, n_addrs=6,
                           p_persist=0.7)
        for s in m.Scheme:
            for d, hp in CHAINS:
                for k in CRASH_SLOTS:
                    rows.append((f"crash{seed}", (s.name, d, hp, k), tr,
                                 m.PCSConfig(
                                     scheme=s, n_pbe=3, n_switches=d,
                                     pbe_per_hop=(None if s == m.Scheme.NOPB
                                                  else hp)
                                 ).with_crash(fuzz_crash_ns(k))))
    tr = fig1_trace(m)
    for label, cfg in fig1_plan(m):
        rows.append((f"fig1_n{label[1]}", label, tr, cfg))
    tr = make_trace("radiosity", persist_budget=60)
    pol = m.PBPolicy(alloc=m.AllocPolicy(victim="weighted"))
    for s in (m.Scheme.PB, m.Scheme.PB_RF):
        for d in (2, 4):
            rows.append(("sweep", (s.name, d, None), tr,
                         m.PCSConfig(scheme=s, n_switches=d)))
        rows.append(("sweep", (s.name, 3, "weighted"), tr,
                     m.PCSConfig(scheme=s, n_switches=3, policy=pol)))
    rows.append(("sweep", ("NOPB", 2, None), tr,
                 m.PCSConfig(scheme=m.Scheme.NOPB, n_switches=2)))
    rows.append(("sweep", ("PB_RF", 3, (16, 3, 2)), tr,
                 m.PCSConfig(scheme=m.Scheme.PB_RF, n_switches=3,
                             pbe_per_hop=(16, 3, 2))))
    return rows


@pytest.fixture(scope="module")
def both(ref):
    """(rows, reference results, port results) of one simulate_cells call
    on each side."""
    R = ref.params
    ns = type("m", (), {})
    for k in ("Op", "Scheme", "PCSConfig", "PBPolicy", "AllocPolicy"):
        setattr(ns, k, getattr(R, k))
    ns.Trace = ref.traces.Trace
    rows = cells_of(ns, ref.traces.make_trace, ref.traces.fuzz_trace,
                    ref.traces.fuzz_crash_ns)
    want = ref.grid.simulate_cells([r[2] for r in rows],
                                   [r[3] for r in rows], bucket=512,
                                   track_addrs=N_ADDRS, macro=False)
    ptraces = {}
    for r in rows:
        t = r[2]
        if id(t) not in ptraces:
            ptraces[id(t)] = P.trace_from_arrays(t.name, t.ops, t.addrs,
                                                 t.gaps, t.lengths)
    got = P.simulate_cells([ptraces[id(r[2])] for r in rows],
                           [P.config_from_fields(dataclasses.asdict(r[3]))
                            for r in rows],
                           track_addrs=N_ADDRS, device="cpu")
    return rows, want, got


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


GROUPS = ["crash0", "crash1"] + [f"fig1_n{d}" for d in FIG1_DEPTHS] \
    + ["sweep"]


@pytest.mark.parametrize("group", GROUPS)
def test_chain_cells_match_reference(both, group):
    rows, want, got = both
    sel = [k for k, r in enumerate(rows) if r[0] == group]
    assert sel
    for k in sel:
        assert_same_result(got[k], want[k], (group, rows[k][1]))
    if group.startswith("crash"):
        # the matrix reaches deep hops, bypasses and per-hop survivors
        deep = [want[k].hop_stats for k in sel
                if want[k].hop_stats is not None and
                len(want[k].hop_stats) > 1]
        assert any(h[1:, 1].sum() > 0 for h in deep)


def test_fig1_rows_reach_every_hop(both):
    """The crashed PB replicas attribute survivors to deep hops, and the
    persist latency rows are finite; printed as chip_smoke.py does."""
    rows, want, got = both
    base = None
    for k, r in enumerate(rows):
        if not r[0].startswith("fig1"):
            continue
        key, n_sw, crashed = r[1]
        res = got[k]
        if key == "nopb" and n_sw == 0:
            base = res.persist_lat_ns
        assert math.isfinite(res.persist_lat_ns)
        if crashed:
            assert res.hop_recovery is not None
            assert len(res.hop_recovery) == n_sw
    assert base is not None


@pytest.mark.parametrize("n", [1, 5, 17, 32, 33, 48, 64, 65, 80, 97, 160])
def test_xla_sum_order_matches_jnp_sum(ref, n):
    """``chain.xla_sum`` adds in the order of the reference's XLA CPU
    reduction (the per-hop commit-latency sum depends on it)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(n)
    f = jax.jit(lambda v: jnp.sum(v))
    with ref.x64():
        for _ in range(40):
            v = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 8, n)
            v[rng.random(n) < 0.3] = 0.0
            want = float(f(jnp.asarray(v)))
            assert float(xla_sum(torch.tensor(v))) == want, n


# ---- tests/test_chain.py on the port -------------------------------------
COUNT_FIELDS = ("persists", "pm_reads", "read_hits", "coalesces",
                "pm_writes", "pi_detours", "victim_drains",
                "acked_persists", "durable_persists", "recovery_entries")
FLOAT_FIELDS = ("runtime_ns", "persist_lat_ns", "read_lat_ns", "stall_ns",
                "recovery_ns")


def _assert_bit_exact(a, b, label):
    for f in COUNT_FIELDS:
        assert getattr(a, f) == getattr(b, f), (label, f)
    for f in FLOAT_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if math.isnan(va) and math.isnan(vb):
            continue
        assert va == vb, (label, f, va, vb)


@pytest.fixture(scope="module")
def chain_trace():
    return P.make_trace("radiosity", persist_budget=60)


@pytest.mark.parametrize("scheme", list(P.Scheme))
def test_depth1_bit_exact_inside_mixed_depth_grid(chain_trace, scheme):
    """A depth-1 cell inside a grid with deep-hop rows reproduces its
    standalone (chain-free) result bit for bit."""
    cfg = P.PCSConfig(scheme=scheme)
    alone = P.simulate(chain_trace, cfg, device="cpu")
    cells = P.simulate_grid(
        [chain_trace], [cfg, P.PCSConfig(scheme=P.Scheme.PB_RF,
                                         n_switches=4)], device="cpu")[0]
    _assert_bit_exact(cells[0], alone, scheme.name)
    assert np.array_equal(cells[0].lat_hist, alone.lat_hist)


def test_depth1_crash_cell_bit_exact_in_mixed_depth_grid(chain_trace):
    t_end = P.simulate(chain_trace, P.PCSConfig(scheme=P.Scheme.PB_RF),
                       device="cpu").runtime_ns
    cfg = P.PCSConfig(scheme=P.Scheme.PB_RF).with_crash(0.4 * t_end)
    alone = P.simulate(chain_trace, cfg, track_addrs=8, device="cpu")
    cells = P.simulate_grid(
        [chain_trace],
        [cfg, P.PCSConfig(scheme=P.Scheme.PB, n_switches=3).with_crash(
            0.4 * t_end)], track_addrs=8, device="cpu")[0]
    _assert_bit_exact(cells[0], alone, "crash")
    assert (cells[0].durable_ver == alone.durable_ver).all()


def test_deep_hops_with_zero_traffic_report_nan_not_zero():
    cfg = P.PCSConfig(scheme=P.Scheme.PB_RF, n_switches=3,
                      pbe_per_hop=(128, 4, 4))
    r = P.simulate(P.make_trace("volrend_npl", persist_budget=40), cfg,
                   device="cpu")
    hops = r.hop_results()
    assert len(hops) == 3
    assert hops[0]["commits"] > 0 and not math.isnan(hops[0]["fwd_lat_ns"])
    for h in hops[1:]:
        assert h["commits"] == 0, h
        assert math.isnan(h["fwd_lat_ns"])


def test_chain_deeper_than_the_kernel_bound_raises(chain_trace):
    from repro_torch.kernels.cell_scan import MAX_DEEP
    cfg = P.PCSConfig(scheme=P.Scheme.PB, n_switches=MAX_DEEP + 2)
    with pytest.raises(ValueError, match="switch chains of up to"):
        P.simulate_grid([chain_trace], [cfg], device="cpu")


def test_pbe_per_hop_arity_must_match_depth():
    with pytest.raises(ValueError, match="one per switch"):
        P.PCSConfig(scheme=P.Scheme.PB, n_switches=2, pbe_per_hop=(4, 4, 4))


def test_pbe_per_hop_entries_positive():
    with pytest.raises(ValueError, match=">= 1"):
        P.PCSConfig(scheme=P.Scheme.PB, n_switches=2, pbe_per_hop=(4, 0))


def test_pbe_per_hop_rejected_for_nopb():
    with pytest.raises(ValueError, match="NOPB"):
        P.PCSConfig(scheme=P.Scheme.NOPB, n_switches=2, pbe_per_hop=(4, 4))


def test_pbe_per_hop_syncs_hop1_capacity():
    cfg = P.PCSConfig(scheme=P.Scheme.PB_RF, n_switches=3,
                      pbe_per_hop=(8, 4, 2))
    assert cfg.n_pbe == 8
    assert cfg.hop_pbes == (8, 4, 2)
    assert cfg.max_hop_pbe == 8
    assert P.PCSConfig(scheme=P.Scheme.PB, n_switches=2, n_pbe=4).hop_pbes \
        == (4, 4)


def test_chain_ref_datum_holds_the_reference_shape():
    """``testdata/chain_ref.json``, the datum chip_smoke.py phase 8 holds
    the kernel against: Fig. 1's 21 cells at 2000 pairs and all 63 cells
    of the chained paper grid (7 workloads x NoPB/PB/PB_RF x n_switches
    2-4), each row of the engine's width, one hop row per switch,
    survivors summing to the recovery count; two NoPB Fig. 1 cells also
    through the port's eager engine."""
    import json
    import os

    import repro_torch
    from repro_torch.core.engine.state import N_HOP_STATS, N_STATS
    path = os.path.join(os.path.dirname(repro_torch.__file__), "testdata",
                        "chain_ref.json")
    with open(path) as f:
        d = json.load(f)
    plan = fig1_plan(P, n_ops=2000)
    keys = [f"{s.upper()}/{n}" + ("/crash" if c else "")
            for (s, n, c), _ in plan]
    assert sorted(d["fig1"]) == sorted(keys)
    assert sorted(d["grid_b"]) == sorted(P.WORKLOADS)
    grid_keys = [f"{s.name}/{n}" for n in (2, 3, 4) for s in P.Scheme]
    assert all(sorted(by) == sorted(grid_keys)
               for by in d["grid_b"].values())
    cells = list(d["fig1"].items()) + [
        (f"{w}/{s}", c) for w, by in d["grid_b"].items()
        for s, c in by.items()]
    for key, c in cells:
        assert len(c["stats"]) == N_STATS, key
        assert all(len(r) == N_HOP_STATS for r in c["hop_stats"]), key
        assert len(c["hop_stats"]) == len(c["hop_recovery"]), key
        assert sum(c["hop_recovery"]) == c["recovery_entries"], key
    assert all(len(c["hop_stats"]) == (0 if k.startswith("NOPB/")
                                       else int(k.split("/")[1]))
               for by in d["grid_b"].values() for k, c in by.items())
    tr = fig1_trace(P, n_ops=2000)
    for n_sw in (0, 4):
        r = P.simulate(tr, P.PCSConfig(scheme=P.Scheme.NOPB,
                                       n_switches=n_sw), device="cpu")
        assert r.runtime_ns == float(d["fig1"][f"NOPB/{n_sw}"]["runtime_ns"])
