"""Port parity of the whole slice: the tiny paper grid (7 workloads x
NoPB/PB/PB_RF at the conftest's reduced persist budget) through
``repro_torch`` on the CPU, against the JAX ``simulate_grid`` with the
macro-step fast path off and on, and the Fig. 5 rows built from both.

Tolerances (DESIGN.md "Bit-stability"): runtimes, stats-derived counts
and sums, histograms and recovery numbers exactly equal; derived means
within 1 ulp.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from _torch_ref import assert_same_result, reference
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
    ptr = [P.trace_from_arrays(t.name, t.ops, t.addrs, t.gaps, t.lengths)
           for t in rtr]
    pcf = [P.config_from_fields(dataclasses.asdict(c)) for c in rcf]
    port = P.simulate_grid(ptr, pcf, device="cpu")
    return names, off, on, port


@pytest.mark.parametrize("macro", [False, True])
def test_tiny_paper_grid_matches_reference(grids, macro):
    names, off, on, port = grids
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


def test_fig5_rows_identical(grids):
    names, off, on, port = grids
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


OUT_OF_SCOPE = [
    dict(n_switches=3, policy=P.PBPolicy(drain=P.DrainPolicy(
        threshold=P.Schedule((1e4,), (0.8, 0.5)), preset=0.25))),
    dict(fabric=P.FabricTopology()),
    dict(policy=P.PBPolicy(drain=P.DrainPolicy(
        threshold=P.Schedule((1e4,), (0.8, 0.5)),
        preset=P.Schedule((1e4,), (0.6, 0.25))))),
]


@pytest.mark.parametrize("kw", OUT_OF_SCOPE + ["macro"])
def test_out_of_scope_configs_raise(kw):
    tr = P.make_trace("radiosity", persist_budget=20)
    if kw == "macro":
        cfg, call = P.PCSConfig(scheme=P.Scheme.PB), dict(macro=True)
    else:
        cfg, call = P.PCSConfig(scheme=P.Scheme.PB_RF, **kw), {}
    with pytest.raises(NotImplementedError):
        P.simulate_grid([tr], [cfg], device="cpu", **call)
    with pytest.raises(NotImplementedError):
        P.simulate_cells([tr], [cfg], device="cpu", **call)


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    tr = P.make_trace("radiosity", persist_budget=20)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.simulate_grid([tr], [P.PCSConfig()])
    with pytest.raises(RuntimeError, match="CUDA"):
        P.simulate(tr, P.PCSConfig())
