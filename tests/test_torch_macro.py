"""Macro-steps of the port (``repro_torch.core.engine.macro``) against the
JAX reference's (``repro.core.engine.macro``), on the CPU.

``tests/test_macro.py``'s six tests become port tests: the run planner,
the guard's fall-back, a committed window, the telemetry with macro-steps
off and the dead-run collapse, each holding the port's ``SimResult`` and
its ``_LAST_MACRO`` integers (slots run as macro-steps, total slots, the
six abort reasons) against the reference's, through the port's
``core.simulator`` shim.  Then the crash differential's macro column
(``tests/test_crash_differential.py::test_differential_macro_column_
bit_exact``): on the fuzzed single-tenant matrix with a depth-2 group
and the T = 2 matrix, ``macro=True`` equals ``macro=False`` exactly, and
every cell's counters equal the reference's.  One case per abort reason
asserts that reason's count is positive and the reference's.  Last, the
datum ``testdata/macro_ref.json`` (the reference's counters per cell on
the grids ``chip_smoke.py`` checks the kernel on) against the eager
engine on the cells the CPU can run.

Tolerances (DESIGN.md "Bit-stability"): counters and every result
exactly equal; derived means within 1 ulp of the reference's.
"""
from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import pytest

from _torch_ref import assert_same_result, ref_config, reference
import repro_torch
import repro_torch.core as P
from repro_torch.core import simulator
from repro_torch.core.engine import grid as pgrid
from repro_torch.core.engine import (last_macro_abort_reasons,
                                     last_macro_hit_rate)
from repro_torch.core.engine.macro import MACRO_ABORT_REASONS
from repro_torch.core.params import MACRO_KMAX
from repro_torch.core.traces import plan_runs
from repro_torch.kernels import cell_scan as cs

R_, W_, C_ = int(P.Op.PM_READ), int(P.Op.PERSIST), int(P.Op.COMPUTE)
N_ADDRS, N_SLOTS, N_CORES = 6, 50, 3       # tests/test_crash_differential.py
PBES = (2, 4, 8)
DATUM = os.path.join(os.path.dirname(repro_torch.__file__), "testdata",
                     "macro_ref.json")


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _trace(ops, addrs, gap=2000.0, name="macro_probe"):
    ops = np.asarray(ops, np.int32).reshape(-1, len(ops[0])) \
        if isinstance(ops[0], (list, tuple)) else np.asarray([ops], np.int32)
    addrs = np.asarray(addrs, np.int32).reshape(ops.shape)
    return P.trace_from_arrays(name, ops, addrs,
                               np.full(ops.shape, gap, np.float32),
                               np.full(ops.shape[0], ops.shape[1], np.int32))


def _ref_trace(ref, tr):
    return ref.core.Trace(ops=tr.ops, addrs=tr.addrs, gaps=tr.gaps,
                          lengths=tr.lengths, name=tr.name)


def _telemetry(grid_module):
    m = grid_module._LAST_MACRO
    return (int(m["macro_ops"]), int(m["total_ops"]),
            [int(x) for x in m["abort_reasons"]])


@contextlib.contextmanager
def _cell_counters(ref):
    """Spy on both engines' per-cell counters: ``got["ref"]`` /
    ``got["port"]`` become ``(macro_ops (N,), macro_aborts (N, 6))`` of
    the latest grid call, cells in row-major (trace, config) order."""
    got = {}
    r_results, p_scan = ref.grid._results_from, cs.cell_scan

    def r_spy(out, *a, **k):
        got["ref"] = (np.asarray(out[9]).reshape(-1),
                      np.asarray(out[10]).reshape(-1, 6))
        return r_results(out, *a, **k)

    def p_spy(*a, **k):
        out = p_scan(*a, **k)
        got["port"] = (out.macro_ops.numpy(), out.macro_aborts.numpy())
        return out
    ref.grid._results_from, cs.cell_scan = r_spy, p_spy
    try:
        yield got
    finally:
        ref.grid._results_from, cs.cell_scan = r_results, p_scan


def _same_grid(ref, traces, configs, *, max_pbe=None, track_addrs=0,
               label=""):
    """Both engines over the grid with macro-steps on (the port on the
    CPU, also with them off): results equal cell for cell, each cell's
    counters and the telemetry equal the reference's.  Returns the
    port's summed abort counts and slots run as macro-steps."""
    rtr = [_ref_trace(ref, t) for t in traces]
    rcf = [ref_config(ref.core, c) for c in configs]
    kw = dict(max_pbe=max_pbe, track_addrs=track_addrs)
    with _cell_counters(ref) as cells:
        want = ref.grid.simulate_grid(rtr, rcf, **kw)
        got = P.simulate_grid(traces, configs, device="cpu", **kw)
    tele = _telemetry(pgrid)
    assert tele == _telemetry(ref.grid), label
    off = P.simulate_grid(traces, configs, device="cpu", macro=False, **kw)
    for i in range(len(traces)):
        for j in range(len(configs)):
            assert_same_result(got[i][j], want[i][j], (label, i, j))
            assert_same_result(got[i][j], off[i][j], (label, i, j, "off"))
    for a, b in zip(cells["port"], cells["ref"]):
        assert np.array_equal(a, b), (label, a, b)
    return tele


# ------------------------------------------------------------- plan_runs
def test_plan_runs_eligibility(ref):
    """Only PM_READ/PERSIST slots with non-negative gaps start runs; run
    length counts the homogeneous suffix, capped at MACRO_KMAX — the
    reference's plan, slot for slot."""
    ops = np.asarray([[R_] * 12], np.int32)
    addrs = np.arange(12, dtype=np.int32)[None, :]
    gaps = np.full((1, 12), 10.0, np.float32)
    ops2 = ops.copy()
    ops2[0, 5] = C_
    gaps3 = gaps.copy()
    gaps3[0, 3] = -1.0
    for o, g in ((ops, gaps), (ops2, gaps), (ops, gaps3)):
        got = plan_runs(o, addrs, g)
        assert got.dtype == np.int8
        assert np.array_equal(got, ref.traces.plan_runs(o, addrs, g))
    mlen = plan_runs(ops, addrs, gaps)
    assert mlen[0, 0] == MACRO_KMAX and mlen[0, 11] == 1
    assert mlen[0, 12 - MACRO_KMAX] == MACRO_KMAX
    mlen2 = plan_runs(ops2, addrs, gaps)
    assert mlen2[0, 0] == 5 and mlen2[0, 5] == 1
    assert plan_runs(ops, addrs, gaps3)[0, 0] == 3


def test_plan_runs_same_addr_persist_pairs_excluded(ref):
    """A window holding two ops on one address where either is a PERSIST
    is statically excluded; read-read repeats are fine."""
    gaps = np.full((1, 4), 10.0, np.float32)
    cases = (([W_, R_, R_, R_], [7, 7, 8, 9], (0, 1), (1, 3)),
             ([R_, R_, R_, R_], [7, 7, 8, 9], (0,), (4,)),
             ([W_, W_, W_, W_], [7, 8, 7, 9], (0,), (2,)))
    for o, a, at, want in cases:
        o = np.asarray([o], np.int32)
        a = np.asarray([a], np.int32)
        got = plan_runs(o, a, gaps)
        assert np.array_equal(got, ref.traces.plan_runs(o, a, gaps))
        assert [int(got[0, i]) for i in at] == list(want)


# ------------------------------------------------------- guard fallback
@pytest.mark.parametrize("scheme", ["PB", "PB_RF"])
def test_guard_failure_falls_back_bit_exact(ref, scheme):
    """A statically eligible window whose guard fails (a PB read hit
    mid-window) falls back to the slot-at-a-time handlers: the results
    match macro-steps off, no slot ran as a macro-step, and the
    telemetry is the reference's (the abort counted under ``guard``)."""
    tr = _trace([W_, R_, R_], [5, 5, 6], gap=10.0)
    cfg = P.PCSConfig(scheme=P.Scheme[scheme], n_pbe=4)
    got = simulator.simulate(tr, cfg, track_addrs=8, device="cpu")
    tele = _telemetry(pgrid)
    assert last_macro_hit_rate() == 0.0
    off = simulator.simulate(tr, cfg, track_addrs=8, device="cpu",
                             macro=False)
    assert_same_result(got, off, scheme)
    want = ref.grid.simulate(_ref_trace(ref, tr), ref_config(ref.core, cfg),
                             track_addrs=8)
    assert_same_result(got, want, scheme)
    assert tele == _telemetry(ref.grid)
    assert tele[2][MACRO_ABORT_REASONS.index("guard")] > 0


def test_macro_commit_pure_miss_window(ref):
    """Distinct-address read windows commit: hit rate > 0.5, results
    identical to macro-steps off and to the reference's."""
    tr = _trace([R_] * 10, list(range(10)))
    cfg = P.PCSConfig(scheme=P.Scheme.PB, n_pbe=4)
    got = simulator.simulate(tr, cfg, device="cpu")
    tele, hit = _telemetry(pgrid), last_macro_hit_rate()
    assert hit > 0.5, hit
    assert_same_result(got, simulator.simulate(tr, cfg, device="cpu",
                                               macro=False))
    want = ref.grid.simulate(_ref_trace(ref, tr), ref_config(ref.core, cfg))
    assert_same_result(got, want)
    assert tele == _telemetry(ref.grid)
    assert hit == ref.grid.last_macro_hit_rate()


def test_macro_disabled_reports_zero_hit_rate(ref):
    tr = _trace([R_] * 6, list(range(6)))
    cfg = P.PCSConfig(scheme=P.Scheme.PB)
    simulator.simulate(tr, cfg, device="cpu", macro=False)
    assert last_macro_hit_rate() == 0.0
    assert set(last_macro_abort_reasons()) == set(MACRO_ABORT_REASONS)
    assert not any(last_macro_abort_reasons().values())
    ref.grid.simulate(_ref_trace(ref, tr), ref_config(ref.core, cfg),
                      macro=False)
    assert _telemetry(pgrid) == _telemetry(ref.grid)


def test_dead_run_collapse_after_crash(ref):
    """Post-crash streams collapse MACRO_KMAX slots at a time — op mixes
    the live path never takes too — and the crashed results match
    macro-steps off and the reference's."""
    tr = _trace([W_, C_] * 15, [3, 0] * 15, gap=1000.0)
    cfg = P.PCSConfig(scheme=P.Scheme.PB, n_pbe=4).with_crash(1500.0)
    got = simulator.simulate(tr, cfg, track_addrs=8, device="cpu")
    tele, hit = _telemetry(pgrid), last_macro_hit_rate()
    assert hit > 0.5, hit
    assert_same_result(got, simulator.simulate(tr, cfg, track_addrs=8,
                                               device="cpu", macro=False))
    want = ref.grid.simulate(_ref_trace(ref, tr), ref_config(ref.core, cfg),
                             track_addrs=8)
    assert_same_result(got, want)
    assert tele == _telemetry(ref.grid)


# ----------------------------------------------- the differential column
@pytest.mark.parametrize("seed", range(4))
def test_differential_macro_column_bit_exact(ref, seed):
    """The fuzzed single-tenant matrix with a depth-2 chain group (the
    deep gate must abort cleanly), at crash points mid-window and past
    the stream end: macro-steps on equal off, and each cell's counters
    equal the reference's."""
    tr = P.fuzz_trace(seed, n_cores=N_CORES, n_slots=N_SLOTS,
                      n_addrs=N_ADDRS)[0]
    plan = [(s, k, PBES[ki % len(PBES)], d)
            for s in P.Scheme
            for ki, k in enumerate((0, 13, 29, N_SLOTS)) for d in (1, 2)]
    configs = [P.PCSConfig(scheme=s, n_pbe=p, n_switches=d)
               .with_crash(P.fuzz_crash_ns(k)) for s, k, p, d in plan]
    _, _, ab = _same_grid(ref, [tr], configs, max_pbe=max(PBES),
                          track_addrs=N_ADDRS, label=seed)
    assert ab[MACRO_ABORT_REASONS.index("deep")] > 0


@pytest.mark.parametrize("seed", range(2))
def test_differential_macro_column_tenants(ref, seed):
    """The T = 2 matrix (4 cores, two tenants sharing the PB)."""
    n_tenants, n_cores = 2, 4
    tr = P.fuzz_trace(seed, n_cores=n_cores, n_slots=N_SLOTS,
                      n_addrs=N_ADDRS, n_tenants=n_tenants)[0]
    configs = [P.PCSConfig(scheme=s, n_pbe=4, n_cores=n_cores,
                           n_tenants=n_tenants).with_crash(
                               P.fuzz_crash_ns(k))
               for s in P.Scheme for k in (11, 29, N_SLOTS)]
    _same_grid(ref, [tr], configs, max_pbe=4, track_addrs=N_ADDRS,
               label=("T2", seed))


# ------------------------------------------------------ each abort reason
def _reason_case(reason):
    S = P.Scheme
    if reason == "window":
        # computes between the persists: no run of two at any cursor
        return _trace([W_, C_] * 12, [1, 0] * 12), [P.PCSConfig(scheme=S.PB)]
    if reason == "fabric":
        tr = _trace([[W_, R_] * 10] * 2,
                    [[c * 100 + i for i in range(20)] for c in range(2)],
                    gap=500.0)
        return tr, [P.PCSConfig(scheme=S.PB_RF, n_cores=2, n_tenants=2,
                                fabric=P.FabricTopology(2, (4, 4), 4,
                                                        (0, 1)))]
    if reason == "deep":
        return _trace([R_] * 20, list(range(20))), \
            [P.PCSConfig(scheme=S.PB, n_switches=2)]
    if reason == "epoch_boundary":
        # one core, windows of reads 2 us apart; the boundary mid-run
        return _trace([R_] * 40, list(range(40))), [P.PCSConfig(
            scheme=S.PB, policy=P.PBPolicy(drain=P.DrainPolicy(
                threshold=P.Schedule((3e4,), (0.75, 0.5)), preset=0.25)))]
    if reason == "interleave":
        return _trace([[R_] * 16] * 2,
                      [[c * 100 + i for i in range(16)] for c in range(2)],
                      gap=300.0), [P.PCSConfig(scheme=S.NOPB, n_cores=2)]
    # guard: the read of line 5 hits the persist's entry
    return _trace([W_, R_, R_], [5, 5, 6], gap=10.0), \
        [P.PCSConfig(scheme=S.PB_RF, n_pbe=4)]


@pytest.mark.parametrize("reason", MACRO_ABORT_REASONS)
def test_abort_reason_counted_as_reference(ref, reason):
    """A grid built to fail each gate: that reason's count is positive,
    and every count, result and the telemetry are the reference's."""
    tr, configs = _reason_case(reason)
    _, _, ab = _same_grid(ref, [tr], configs, label=reason)
    assert ab[MACRO_ABORT_REASONS.index(reason)] > 0, ab


def test_simulator_shim_reexports_the_engine():
    assert simulator.simulate is P.simulate
    assert simulator.simulate_grid is P.simulate_grid
    assert simulator.simulate_sweep is P.simulate_sweep
    assert simulator.SimResult is P.SimResult
    assert set(simulator.__all__) == {"SimResult", "simulate",
                                      "simulate_grid", "simulate_sweep"}


# ------------------------------------------------------------- the datum
def test_macro_ref_datum_holds_every_grid():
    """The reference's counters per cell: the paper grid (21 cells),
    Fig. 1's sweep (21), fig_fabric (52), fig_dynamic (18) and the
    budget-2000 crash cells (12), each with six reason counts that,
    with the committed slots, never exceed the cell's slots."""
    with open(DATUM) as f:
        d = json.load(f)
    sizes = dict(paper=21, fig1=21, fig_fabric=52, fig_dynamic=18,
                 crash2000=12)
    for grid_name, n in sizes.items():
        cells = _datum_cells(d, grid_name)
        assert len(cells) == n, grid_name
        for lab, c in cells.items():
            assert len(c["abort_reasons"]) == len(MACRO_ABORT_REASONS)
            assert 0 <= c["macro_ops"] <= c["total_ops"], lab
            assert sum(c["abort_reasons"]) <= c["total_ops"], lab
    assert d["jax_version"] and d["command"] and d["what"]


def _datum_cells(d, grid_name):
    """``{label: cell}`` of one grid of the datum, nesting flattened."""
    out, todo = {}, [((), d["grids"][grid_name])]
    while todo:
        key, node = todo.pop()
        if "macro_ops" in node:
            out["/".join(key)] = node
            continue
        todo += [(key + (k,), v) for k, v in node.items()
                 if isinstance(v, dict)]
    return out


def test_crash_cells_match_macro_ref():
    """radiosity's budget-2000 crash cells (PB and PB_RF crashed at 1/4,
    1/2 and 3/4 of the PB runtime; lu_cont's, the datum's other six, run
    on the card only) through the eager engine: each cell's counters
    equal the datum's."""
    with open(DATUM) as f:
        want = json.load(f)["grids"]["crash2000"]
    for w in ("radiosity",):
        tr = P.make_trace(w, persist_budget=2000)
        t_pb = P.simulate(tr, P.PCSConfig(scheme=P.Scheme.PB),
                          device="cpu").runtime_ns
        for s in ("PB", "PB_RF"):
            for f in (0.25, 0.5, 0.75):
                P.simulate(tr, P.PCSConfig(scheme=P.Scheme[s])
                           .with_crash(f * t_pb), device="cpu")
                d = want[w][s][f"{f:g}"]
                assert _telemetry(pgrid) == (d["macro_ops"], d["total_ops"],
                                             d["abort_reasons"]), (w, s, f)
