"""Port kernels on the CPU: the plain versions against the JAX reference,
and the wrappers' device dispatch (a CPU tensor takes the plain version
and launches nothing; an input the kernel does not take raises).

The CUDA kernels themselves run only on the card: ``chip_smoke.py``
holds each against its plain version there.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_ref import reference
from repro_torch.core import PCSConfig, Scheme, make_trace
from repro_torch.core.engine import grid
from repro_torch.core.engine.step import scan_cell
from repro_torch.kernels import cell_scan as cs
from repro_torch.kernels import tat_lookup as tl
from repro_torch.kernels.ref import tat_lookup_ref

SWEEP = [(256, 16), (512, 64), (1024, 256), (8, 16)]


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _case(seed, r, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n * 2, r).astype(np.int32),
            rng.integers(0, n * 2, n).astype(np.int32),
            rng.integers(0, 3, n).astype(np.int32))


@pytest.mark.parametrize("r,n", SWEEP)
def test_tat_lookup_ref_matches_jax_ref_and_pallas(ref, r, n):
    import jax.numpy as jnp
    req, tat, st = _case(42 + r + n, r, n)
    want_ref = ref.kref.tat_lookup_ref(jnp.asarray(req), jnp.asarray(tat),
                                       jnp.asarray(st))
    want_pallas = ref.ktat.tat_lookup_pallas(
        jnp.asarray(req), jnp.asarray(tat), jnp.asarray(st),
        block_r=min(256, r), interpret=True)
    got = tat_lookup_ref(torch.from_numpy(req), torch.from_numpy(tat),
                         torch.from_numpy(st))
    for g, w1, w2 in zip(got, want_ref, want_pallas):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w1))
        assert np.array_equal(g.numpy(), np.asarray(w2))


def test_tat_lookup_empty_never_matches():
    idx, s = tat_lookup_ref(torch.tensor([7, 7], dtype=torch.int32),
                            torch.tensor([7, 7, 7, 7], dtype=torch.int32),
                            torch.zeros(4, dtype=torch.int32))
    assert (idx == -1).all() and (s == 0).all()


def test_tat_lookup_wrapper_cpu_takes_plain_version():
    req, tat, st = (torch.from_numpy(a) for a in _case(5, 300, 40))
    before = tl.launches
    got = tl.tat_lookup(req, tat, st)
    want = tat_lookup_ref(req, tat, st)
    assert tl.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bad", ["dtype", "rank", "shape"])
def test_tat_lookup_wrapper_raises_on_what_it_does_not_take(bad):
    req = torch.zeros(8, dtype=torch.int32)
    tat = torch.zeros(16, dtype=torch.int32)
    st = torch.zeros(16, dtype=torch.int32)
    if bad == "dtype":
        req = req.to(torch.int64)
    elif bad == "rank":
        tat, st = tat.reshape(4, 4), st.reshape(4, 4)
    else:
        st = st[:8]
    with pytest.raises(ValueError):
        tl.tat_lookup(req, tat, st)


def _grid_inputs(budget=120):
    traces = [make_trace(n, persist_budget=budget)
              for n in ("radiosity", "lu_cont")]
    configs = [PCSConfig(scheme=s) for s in Scheme]
    pairs = [(i, j) for i in range(2) for j in range(3)]
    return traces, configs, pairs, grid.cell_inputs(
        traces, configs, [p[0] for p in pairs], [p[1] for p in pairs],
        track_addrs=4)


def test_cell_scan_wrapper_cpu_runs_eager_scan_cell():
    traces, configs, pairs, (args, kw) = _grid_inputs()
    before = cs.launches
    out = cs.cell_scan(*args, **kw)
    assert cs.launches == before
    assert out.lookups.eq(0).all()
    for k, (i, j) in enumerate(pairs):
        t = traces[i]
        sc = cs._config_view(args[7], args[8], args[9], j)
        want = scan_cell(torch.from_numpy(t.ops), torch.from_numpy(t.addrs),
                         torch.from_numpy(t.gaps),
                         torch.from_numpy(t.lengths), int(configs[j].scheme),
                         sc, max_pbe=kw["max_pbe"], pm_banks=kw["pm_banks"],
                         n_track=kw["n_track"], n_tenants_max=1)
        assert float(out.runtime[k]) == float(want[0])
        assert torch.equal(out.stats[k], want[1])
        assert torch.equal(out.durable_ver[k], want[2])
        assert int(out.steps[k]) == want[9] == t.total_ops


@pytest.mark.parametrize("bad", ["ops_dtype", "gaps_dtype", "max_pbe",
                                 "banks", "cfg_shape", "device_mix"])
def test_cell_scan_wrapper_raises_on_what_it_does_not_take(bad):
    _, _, _, (args, kw) = _grid_inputs(budget=40)
    args, kw = list(args), dict(kw)
    if bad == "ops_dtype":
        args[0] = args[0].to(torch.int64)
    elif bad == "gaps_dtype":
        args[2] = args[2].to(torch.float64)
    elif bad == "max_pbe":
        kw["max_pbe"] = cs.MAX_PBE + 1
    elif bad == "banks":
        kw["pm_banks"] = cs.MAX_BANKS + 1
    elif bad == "cfg_shape":
        args[7] = args[7][:, :-1]
    else:
        args[3] = args[3].to("meta")
    with pytest.raises(ValueError):
        cs.cell_scan(*args, **kw)


def test_pack_configs_columns_follow_sc_keys():
    from repro_torch.core.engine.state import scalars_from_config
    cfgs = [PCSConfig(scheme=Scheme.PB, crash_at_ns=77.0),
            PCSConfig(scheme=Scheme.PB_RF, n_tenants=2)]
    scs = [scalars_from_config(c, 2) for c in cfgs]
    sct, tent, cht = cs.pack_configs(scs, 2, "cpu")
    assert sct.shape == (2, len(cs.SC_KEYS))
    assert tent.shape == (2, len(cs.TENANT_KEYS), 2)
    assert cht.shape == (2, len(cs.CHAIN_KEYS) + len(cs.DEEP_KEYS))
    for j, sc in enumerate(scs):
        for i, k in enumerate(cs.SC_KEYS):
            assert float(sct[j, i]) == float(sc[k])
        for i, k in enumerate(cs.TENANT_KEYS):
            assert torch.equal(tent[j, i], sc[k])
        view = cs._config_view(sct, tent, cht, j)
        for k in cs.CHAIN_KEYS + cs.DEEP_KEYS:
            assert torch.equal(view[k].reshape(-1), sc[k].reshape(-1)), k
