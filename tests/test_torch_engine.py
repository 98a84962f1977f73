"""Port parity of the whole slice: the tiny paper grid (7 workloads x
NoPB/PB/PB_RF at the conftest's reduced persist budget) through
``repro_torch`` on the CPU (its default, macro-steps on), against the
JAX ``simulate_grid`` with the macro-step fast path off and on, its
macro telemetry against the reference's, and the Fig. 5 rows built from
both.

Tolerances (DESIGN.md "Bit-stability"): runtimes, stats-derived counts
and sums, histograms and recovery numbers exactly equal; derived means
within 1 ulp.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from _torch_ref import assert_same_result, ref_config, reference
import repro_torch.core as P

TINY_BUDGET = 200                    # the conftest tiny-trace settings
TINY_BUCKET = 512
TINY_TRACE_KW = {"fft": {"m": 9}}


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


@pytest.fixture(scope="module")
def grids(ref):
    """Reference (macro off, macro on) and port results of the grid."""
    names = list(ref.traces.WORKLOADS)
    rtr = [ref.traces.make_trace(n, persist_budget=TINY_BUDGET,
                                 **TINY_TRACE_KW.get(n, {})) for n in names]
    rcf = [ref.params.PCSConfig(scheme=s) for s in ref.params.Scheme]
    off = ref.grid.simulate_grid(rtr, rcf, bucket=TINY_BUCKET, macro=False)
    on = ref.grid.simulate_grid(rtr, rcf, bucket=TINY_BUCKET, macro=True)
    ref_tele = (ref.grid.last_macro_hit_rate(),
                ref.grid.last_macro_abort_reasons())
    ptr = [P.trace_from_arrays(t.name, t.ops, t.addrs, t.gaps, t.lengths)
           for t in rtr]
    pcf = [P.config_from_fields(dataclasses.asdict(c)) for c in rcf]
    port = P.simulate_grid(ptr, pcf, device="cpu")
    port_tele = (P.last_macro_hit_rate(), P.last_macro_abort_reasons())
    return names, off, on, port, (ref_tele, port_tele)


@pytest.mark.parametrize("macro", [False, True])
def test_tiny_paper_grid_matches_reference(grids, macro):
    names, off, on, port, _ = grids
    want = on if macro else off
    for i, name in enumerate(names):
        for j in range(3):
            assert_same_result(port[i][j], want[i][j], (name, j, macro))


def _fig5_rows(cells, names):
    """``benchmarks/fig5_speedup.run`` over a grid of results."""
    rows, sp = [], {"pb": [], "pb_rf": []}
    for i, name in enumerate(names):
        nopb = cells[i][0]
        for key, j in (("pb", 1), ("pb_rf", 2)):
            s = 100.0 * (nopb.runtime_ns / cells[i][j].runtime_ns - 1.0)
            sp[key].append(s)
            rows.append((f"fig5_{key}_{name}", round(s, 1), "speedup_%"))
    for key, paper in (("pb", 12.0), ("pb_rf", 15.0)):
        rows.append((f"fig5_{key}_mean",
                     round(sum(sp[key]) / len(sp[key]), 1),
                     f"paper={paper}%"))
    return rows


def test_tiny_paper_grid_macro_telemetry_matches_reference(grids):
    """The default call's hit rate and per-reason aborts, exactly the
    reference's (most live heads abort on interleave)."""
    ref_tele, port_tele = grids[4]
    assert port_tele == ref_tele
    assert port_tele[0] > 0.0 and port_tele[1]["interleave"] > 0


def test_fig5_rows_identical(grids):
    names, off, on, port, _ = grids
    assert _fig5_rows(port, names) == _fig5_rows(off, names)
    assert _fig5_rows(port, names) == _fig5_rows(on, names)


def test_paper_grid_ref_datum_holds_the_reference_shape():
    """The full-budget datum chip_smoke.py checks against: 21 cells, a
    stats row of the engine's width each."""
    import json
    import os

    import repro_torch
    path = os.path.join(os.path.dirname(repro_torch.__file__), "testdata",
                        "paper_grid_ref.json")
    with open(path) as f:
        cells = json.load(f)["cells"]
    assert sorted(cells) == sorted(P.WORKLOADS)
    from repro_torch.core.engine.state import (N_STATS, S_PERSIST_CNT,
                                               result_from_stats)
    for name, by_scheme in cells.items():
        assert sorted(by_scheme) == sorted(s.name for s in P.Scheme)
        for d in by_scheme.values():
            assert len(d["stats"]) == N_STATS
            r = result_from_stats(d["runtime_ns"], np.asarray(d["stats"]))
            assert r.persists == d["stats"][S_PERSIST_CNT] > 0


SCHEDULED = [
    dict(n_switches=3, policy=P.PBPolicy(drain=P.DrainPolicy(
        threshold=P.Schedule((1e4,), (0.8, 0.5)), preset=0.25))),
    # a fabric whose placement moves tenants between leaves mid-run
    dict(fabric=P.FabricTopology(2, (8, 8), 8,
                                 P.Schedule((1e4,), ((0,), (1,))))),
    dict(policy=P.PBPolicy(drain=P.DrainPolicy(
        threshold=P.Schedule((1e4,), (0.8, 0.5)),
        preset=P.Schedule((1e4,), (0.6, 0.25))))),
]


@pytest.mark.parametrize("kw", range(len(SCHEDULED)))
def test_scheduled_configs_match_reference(ref, kw):
    """The schedules the port once refused (a deep-row threshold over a
    3-switch chain, a placement flip, a threshold and preset step), each
    with its boundary inside the run: equal to the reference's cell."""
    rtr = ref.traces.make_trace("radiosity", persist_budget=100)
    ptr = P.trace_from_arrays(rtr.name, rtr.ops, rtr.addrs, rtr.gaps,
                              rtr.lengths)
    cfg = P.PCSConfig(scheme=P.Scheme.PB_RF, **SCHEDULED[kw])
    assert cfg.n_epochs == 2
    rcfg = ref_config(ref.core, cfg)
    want = ref.grid.simulate_grid([rtr], [rcfg], macro=False)[0][0]
    got = P.simulate_grid([ptr], [cfg], device="cpu")[0][0]
    assert_same_result(got, want, kw)
    assert got.runtime_ns > 1e4                  # the run crosses it


@pytest.mark.parametrize("kw", ["macro_chain", "macro_fabric",
                                "macro_schedule"])
def test_macro_on_chain_fabric_schedule_configs(ref, kw):
    """The configs the port once refused with macro-steps on (a 3-switch
    chain, a fabric, a scheduled chain): ``simulate_grid`` and
    ``simulate_cells`` equal ``macro=False``, and their telemetry is the
    reference's."""
    rtr = ref.traces.make_trace("radiosity", persist_budget=20)
    tr = P.trace_from_arrays(rtr.name, rtr.ops, rtr.addrs, rtr.gaps,
                             rtr.lengths)
    if kw == "macro_chain":
        cfgs = [P.PCSConfig(scheme=s, n_switches=3) for s in P.Scheme]
    elif kw == "macro_fabric":
        cfgs = [P.PCSConfig(scheme=s, n_tenants=2,
                            fabric=P.FabricTopology(2, (8, 8), 8, (0, 1)))
                for s in (P.Scheme.PB, P.Scheme.PB_RF)]
    else:
        cfgs = [P.PCSConfig(scheme=P.Scheme.PB_RF, **SCHEDULED[0]),
                P.PCSConfig(scheme=P.Scheme.NOPB)]
    rcf = [ref_config(ref.core, c) for c in cfgs]
    for run, ref_run, trs, rtrs in (
            (P.simulate_grid, ref.grid.simulate_grid, [tr], [rtr]),
            (P.simulate_cells, ref.grid.simulate_cells, [tr] * len(cfgs),
             [rtr] * len(cfgs))):
        on = run(trs, cfgs, device="cpu")
        tele = (P.last_macro_hit_rate(), P.last_macro_abort_reasons())
        ref_run(rtrs, rcf)
        assert tele == (ref.grid.last_macro_hit_rate(),
                        ref.grid.last_macro_abort_reasons()), kw
        off = run(trs, cfgs, device="cpu", macro=False)
        if run is P.simulate_grid:
            on, off = on[0], off[0]
        for j in range(len(cfgs)):
            assert_same_result(on[j], off[j], (kw, j))


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    tr = P.make_trace("radiosity", persist_budget=20)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.simulate_grid([tr], [P.PCSConfig()])
    with pytest.raises(RuntimeError, match="CUDA"):
        P.simulate(tr, P.PCSConfig())
