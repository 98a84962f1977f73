"""Fan-out fabrics in the port: the port's engine against the JAX engine.

The fabric helpers (``core/engine/fabric.py``) against the reference's on
seeded numpy operands; the eager ``simulate_grid(device="cpu")`` against
the reference's ``simulate_grid`` (``macro=False``) on the fabric matrix
of ``tests/test_crash_differential.py``: fuzzed 4-tenant traces x PB/PB_RF
x {explicit 2-hop chain, 1-leaf fabric, 2 leaves packed and spread, 2
leaves with a backpressure watermark, 4 leaves} x 5 crash points, every
``SimResult`` field equal (``_torch_ref.assert_same_result``: exact, the
derived means within 1 ulp), ``leaf_recovery`` included.  Then the two
identities (the 1-leaf fabric is the 2-hop chain; a mixed {chain x
fabric} grid equals each cell run alone), ``benchmarks/fig_fabric.py``'s
grid at its smoke size against ``testdata/fabric_ref.json``, the datum's
shape, and the validation the port's params did not test yet.
"""
import json
import os

import numpy as np
import pytest
import torch

from _torch_ref import assert_same_result, reference
import repro_torch
import repro_torch.core as P
from repro_torch.core.engine import fabric
from repro_torch.core.engine.state import (DIRTY, DRAIN, EMPTY, INF,
                                           N_HOP_STATS, N_STATS, init_state,
                                           scalars_from_config)

N_ADDRS = 6
N_SLOTS = 50
N_TENANTS = N_CORES = 4
CRASH_SLOTS = (0, 11, 23, 36, N_SLOTS)
DATUM = os.path.join(os.path.dirname(repro_torch.__file__), "testdata",
                     "fabric_ref.json")


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


# ---- the helpers -----------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_fabric_helpers_match_reference(ref, seed):
    """slot_leaf (INF-padded bases), leaf_mask (the n_leaves < 2 bypass
    included), leaf_of_tenant and spine_live, exactly."""
    rng = np.random.default_rng(seed)
    NL1 = (1, 3, 8, 5)[seed]
    P_ = 40
    n_leaves = int(rng.integers(1, NL1 + 1))
    caps = rng.integers(1, 8, n_leaves)
    base = np.full(NL1, INF)
    base[:n_leaves] = np.concatenate([[0], np.cumsum(caps)[:-1]])
    T = 5
    sc_np = dict(leaf_base=base, n_leaves=np.float64(n_leaves),
                 leaf_of_t=rng.integers(0, n_leaves, T).astype(np.float64),
                 deep_pbe=np.array([float(rng.integers(0, P_ + 1)), 3.0]))
    slot_ids = np.arange(P_)
    dstate = rng.choice([EMPTY, DIRTY, DRAIN], P_).astype(np.int8)
    sc_t = {k: torch.as_tensor(v) for k, v in sc_np.items()}
    with ref.x64():
        import jax.numpy as jnp
        sc_j = {k: jnp.asarray(v) for k, v in sc_np.items()}
        sl_r = np.asarray(ref.fabric.slot_leaf(sc_j, jnp.asarray(slot_ids)))
        sp_r = float(ref.fabric.spine_live(sc_j, jnp.asarray(dstate),
                                           jnp.asarray(slot_ids)))
        lm_r = [np.asarray(ref.fabric.leaf_mask(sc_j, jnp.asarray(sl_r),
                                                jnp.int32(lf)))
                for lf in range(NL1)]
        lt_r = [int(ref.fabric.leaf_of_tenant(sc_j, t)) for t in range(T)]
    sl = fabric.slot_leaf(sc_t, torch.as_tensor(slot_ids))
    assert sl.dtype == torch.int32
    assert np.array_equal(sl.numpy(), sl_r)
    for lf in range(NL1):
        got = fabric.leaf_mask(sc_t, sl, torch.tensor(lf, dtype=torch.int32))
        assert np.array_equal(got.numpy(), lm_r[lf])
        if n_leaves < 2:
            assert bool(got.all())
    assert [int(fabric.leaf_of_tenant(sc_t, t)) for t in range(T)] == lt_r
    sp = fabric.spine_live(sc_t, torch.as_tensor(dstate),
                           torch.as_tensor(slot_ids))
    assert sp.dtype == torch.float64 and float(sp) == sp_r


def test_has_fabric_follows_the_leaf_bound():
    for nl, want in ((1, False), (2, True), (8, True)):
        st = init_state(2, 8, 4, n_deep_max=1, n_leaves_max=nl)
        assert st.lpbc.shape == ((nl,) if nl > 1 else (0,))
        assert fabric.has_fabric(st) is want


# ---- the matrix against the reference ---------------------------------------
def fabrics(m):
    """The matrix's topologies: sum(leaf_pbe) == 8 and spine 4 throughout,
    so the chain control is the 1-leaf lowering's target."""
    F, lp = m.FabricTopology, m.leaf_placement
    return [None,
            F(1, (8,), 4, (0,) * N_TENANTS),
            F(2, (4, 4), 4, lp(N_TENANTS, 2, "packed")),
            F(2, (4, 4), 4, lp(N_TENANTS, 2, "spread")),
            F(2, (4, 4), 4, lp(N_TENANTS, 2, "packed"), bp_high=2.0),
            F(4, (2, 2, 2, 2), 4, lp(N_TENANTS, 4, "spread"))]


def matrix(m, fuzz_crash_ns):
    """(plan, configs): fabric-innermost, so each run of len(fabrics)
    cells shares one (scheme, crash point)."""
    plan = [(s, k, j) for s in (m.Scheme.PB, m.Scheme.PB_RF)
            for k in CRASH_SLOTS for j in range(len(fabrics(m)))]
    cfgs = []
    for s, k, j in plan:
        fab = fabrics(m)[j]
        kw = (dict(n_pbe=8, n_switches=2, pbe_per_hop=(8, 4))
              if fab is None else dict(fabric=fab))
        cfgs.append(m.PCSConfig(scheme=s, n_cores=N_CORES,
                                n_tenants=N_TENANTS, **kw)
                    .with_crash(fuzz_crash_ns(k)))
    return plan, cfgs


def port_matrix(seed):
    tr, sched = P.fuzz_trace(seed, n_cores=N_CORES, n_slots=N_SLOTS,
                             n_addrs=N_ADDRS, n_tenants=N_TENANTS,
                             p_persist=0.7)
    plan, cfgs = matrix(P, P.fuzz_crash_ns)
    cells = P.simulate_grid([tr], cfgs, max_pbe=8, track_addrs=N_ADDRS,
                            device="cpu")[0]
    return tr, sched, plan, cells


@pytest.mark.parametrize("seed", range(3))
def test_fabric_matrix_matches_reference(ref, seed):
    """60 cells a seed, every SimResult field equal to the reference's,
    and leaf_recovery reported exactly for the >= 2-leaf topologies."""
    R = ref.core
    tr, _ = ref.traces.fuzz_trace(seed, n_cores=N_CORES, n_slots=N_SLOTS,
                                  n_addrs=N_ADDRS, n_tenants=N_TENANTS,
                                  p_persist=0.7)
    plan, rcfg = matrix(R, ref.traces.fuzz_crash_ns)
    want = ref.grid.simulate_grid([tr], rcfg, max_pbe=8, bucket=512,
                                  track_addrs=N_ADDRS, macro=False)[0]
    ptr, _, _, got = port_matrix(seed)
    assert np.array_equal(ptr.ops, tr.ops)
    fabs = fabrics(P)
    for (s, k, j), g, w in zip(plan, got, want):
        label = (seed, s.name, k, j)
        assert_same_result(g, w, label)
        multi = fabs[j] is not None and fabs[j].n_leaves >= 2
        assert (g.leaf_recovery is not None) == multi, label
    # the matrix reaches what it is for: survivors on two leaves of one
    # cell, and spine hits
    assert any(g.leaf_recovery is not None and
               int((g.leaf_recovery > 0).sum()) >= 2 for g in got)
    assert any(g.hop_recovery is not None and g.hop_recovery[1] > 0
               for g in got)


# ---- identities -------------------------------------------------------------
def test_one_leaf_fabric_equals_chain():
    """The 1-leaf fabric column is the explicit 2-hop chain column, field
    for field, inside a grid that also holds multi-leaf fabrics."""
    for seed in range(2):
        _, _, plan, cells = port_matrix(seed)
        n = len(fabrics(P))
        for j in range(0, len(plan), n):
            assert_same_result(cells[j + 1], cells[j],
                               ("1-leaf-vs-chain", seed) + plan[j][:2])


def test_mixed_grid_equals_cells_alone():
    """Chain cells up to n_switches = 4 and fabric cells in one grid (D = 3,
    NL = 4) equal each cell run alone (D and NL of its own)."""
    S = P.Scheme
    tr = P.fuzz_trace(3, n_cores=N_CORES, n_slots=40, n_addrs=N_ADDRS,
                      n_tenants=N_TENANTS, p_persist=0.7)[0]
    fabs = fabrics(P)
    cfgs = ([P.PCSConfig(scheme=s, n_pbe=8, n_cores=N_CORES,
                         n_tenants=N_TENANTS, n_switches=d)
             .with_crash(P.fuzz_crash_ns(27))
             for s in (S.PB, S.PB_RF) for d in (1, 2, 4)]
            + [P.PCSConfig(scheme=S.NOPB, n_pbe=8, n_cores=N_CORES,
                           n_tenants=N_TENANTS, n_switches=3)]
            + [P.PCSConfig(scheme=s, n_cores=N_CORES, n_tenants=N_TENANTS,
                           fabric=fabs[j]).with_crash(P.fuzz_crash_ns(27))
               for s in (S.PB, S.PB_RF) for j in (1, 4, 5)])
    grid = P.simulate_grid([tr], cfgs, max_pbe=8, track_addrs=N_ADDRS,
                           device="cpu")[0]
    for k, cfg in enumerate(cfgs):
        alone = P.simulate(tr, cfg, max_pbe=8, track_addrs=N_ADDRS,
                           device="cpu")
        assert_same_result(grid[k], alone, ("mixed", k))


# ---- benchmarks/fig_fabric.py and its datum --------------------------------
FIG_TENANTS, FIG_LEAVES, FIG_TOTAL, FIG_SPINE = 8, (1, 2, 4, 8), 16, 8


def fig_fabric_trace(n_ops, gap=500.0):
    """``benchmarks/fig_fabric._probe_trace``."""
    C, L = FIG_TENANTS, 2 * n_ops
    ops = np.zeros((C, L), np.int32)
    addrs = np.zeros((C, L), np.int32)
    for c in range(C):
        for i in range(n_ops):
            ops[c, 2 * i] = int(P.Op.PERSIST)
            addrs[c, 2 * i] = (c << 16) + i % 64
            ops[c, 2 * i + 1] = int(P.Op.PM_READ)
            addrs[c, 2 * i + 1] = (c << 16) + (1 << 10) + i
    return P.trace_from_arrays("fab_probe", ops, addrs,
                               np.full((C, L), gap, np.float32),
                               np.full(C, L, np.int32))


def fig_fabric_cell(label, n_ops, gap=500.0):
    """The config of a datum key '<scheme>/l<leaves>/<placement>/<bp|none>
    [/crash]' of ``benchmarks/fig_fabric.plan`` (crash at half the op
    span)."""
    parts = label.split("/")
    key, nl, mode, bp = parts[0], int(parts[1][1:]), parts[2], parts[3]
    per = FIG_TOTAL // nl
    fab = P.FabricTopology(nl, (per,) * nl, FIG_SPINE,
                           P.leaf_placement(FIG_TENANTS, nl, mode),
                           bp_high=float(FIG_SPINE // 2) if bp == "bp"
                           else None)
    cfg = P.PCSConfig(scheme=P.Scheme[key.upper()], n_cores=FIG_TENANTS,
                      n_tenants=FIG_TENANTS, fabric=fab)
    if parts[-1] == "crash":
        cfg = cfg.with_crash(0.5 * (2 * n_ops) * gap)
    return cfg


def same_as_datum(r, d, label):
    """A SimResult equal to the one the datum's numbers give."""
    from repro_torch.core.engine.state import result_from_stats
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


SMOKE_CELLS = ("pb/l1/packed/none", "pb_rf/l2/packed/bp",
               "pb/l8/spread/none", "pb_rf/l4/spread/bp/crash",
               "pb_rf/l8/packed/bp/crash", "pb/l2/spread/bp/crash")


def test_fig_fabric_smoke_matches_datum():
    """Six of fig_fabric's cells at its smoke size (150 persist/read
    pairs a core) in one grid (NL = 8) through the eager engine, equal to
    the reference's numbers in fabric_ref.json."""
    with open(DATUM) as f:
        cells = json.load(f)["fig_smoke"]
    tr = fig_fabric_trace(150)
    got = P.simulate_grid([tr], [fig_fabric_cell(k, 150)
                                 for k in SMOKE_CELLS], device="cpu")[0]
    for k, r in zip(SMOKE_CELLS, got):
        same_as_datum(r, cells[k], k)


def test_fabric_ref_datum_holds_the_reference_shape():
    """The datum chip_smoke.py checks against: fig_fabric's 52 cells at
    its published and smoke sizes and the fabric paper grid's 28, each
    with per-tenant stats rows of the engine's width, two hops, and
    per-leaf survivors that sum to hop 1's."""
    with open(DATUM) as f:
        d = json.load(f)
    assert {"script", "command", "what"} <= set(d)
    assert len(d["fig"]) == len(d["fig_smoke"]) == 52
    assert sorted(d["grid_b"]) == sorted(P.WORKLOADS)
    assert sum(len(v) for v in d["grid_b"].values()) == 28
    every = list(d["fig"].items()) + list(d["fig_smoke"].items()) + [
        (k, c) for v in d["grid_b"].values() for k, c in v.items()]
    for key, c in every:
        nl = int(key.split("/")[1][1:])
        assert len(c["stats"]) == FIG_TENANTS
        assert all(len(row) == N_STATS for row in c["stats"])
        assert len(c["hop_stats"]) == len(c["hop_recovery"]) == 2
        assert all(len(row) == N_HOP_STATS for row in c["hop_stats"])
        assert len(c["leaf_recovery_raw"]) == nl
        assert sum(c["leaf_recovery_raw"]) == c["hop_recovery"][0]
        assert (c["leaf_recovery"] is None) == (nl < 2)
        assert sum(c["hop_recovery"]) == c["recovery_entries"]
        assert sum(float(row[1]) for row in c["stats"]) > 0   # persists


# ---- validation -------------------------------------------------------------
def test_fabric_validation_rejects_malformed():
    """``tests/test_crash_differential.py``'s fabric validation that the
    port's params tests do not cover: the fabric owns ``pbe_per_hop``,
    the derived lowering, and static grid bounds that reject instead of
    truncating; and the kernel's leaf bound."""
    fab2 = P.FabricTopology(2, (4, 4), 4, (0, 1))
    with pytest.raises(ValueError, match="fabric owns it"):
        P.PCSConfig(scheme=P.Scheme.PB_RF, n_cores=2, n_tenants=2,
                    fabric=fab2, n_switches=2, pbe_per_hop=(5, 4))
    cfg = P.PCSConfig(scheme=P.Scheme.PB_RF, n_cores=2, n_tenants=2,
                      fabric=fab2)
    assert (cfg.n_switches, cfg.pbe_per_hop, cfg.n_pbe) == (2, (8, 4), 8)
    with pytest.raises(ValueError, match="leaf bound"):
        scalars_from_config(cfg, n_tenants_max=2, n_deep_max=1,
                            n_leaves_max=1)
    deep = P.PCSConfig(scheme=P.Scheme.PB_RF, n_switches=3,
                       pbe_per_hop=(2, 2, 2))
    with pytest.raises(ValueError, match="deep-row bound"):
        scalars_from_config(deep, n_tenants_max=1, n_deep_max=1,
                            n_leaves_max=1)
    wide = P.PCSConfig(scheme=P.Scheme.PB, fabric=P.FabricTopology(
        33, (1,) * 33, 4, (0,)))
    tr = P.make_trace("radiosity", persist_budget=20)
    with pytest.raises(ValueError, match="leaves"):
        P.simulate_grid([tr], [wide], device="cpu")
