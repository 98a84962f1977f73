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
from repro_torch.kernels import cell_scan_variants as cv
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
        sc = cs._config_view(*args[7:13], j)
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
                                 "banks", "cfg_shape", "device_mix",
                                 "leaves", "fab_shape", "epochs",
                                 "ep_shape", "mlen_dtype", "macro_pad"])
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
    elif bad == "leaves":
        kw["n_leaves_max"] = cs.MAX_LEAVES + 1
    elif bad == "fab_shape":
        args[10] = args[10][:, :-1]
    elif bad == "epochs":
        # more epochs than the kernel takes
        E = cs.MAX_EPOCHS + 1
        args[11] = args[11].expand(-1, E, -1).contiguous()
        args[12] = torch.full((args[11].shape[0], E - 1), 1e30,
                              dtype=torch.float64)
    elif bad == "ep_shape":
        args[11] = args[11][:, :, :-1]
    elif bad == "mlen_dtype":
        args[13] = args[13].to(torch.int32)
    elif bad == "macro_pad":
        # macro-steps read MACRO_KMAX slots past a stream: the trace axis
        # cut to the longest stream cannot carry them
        L = int(args[3].max())
        args[:3] = [a[..., :L].contiguous() for a in args[:3]]
        args[13] = args[13][..., :L].contiguous()
        assert kw["macro"]
    else:
        args[3] = args[3].to("meta")
    with pytest.raises(ValueError):
        cs.cell_scan(*args, **kw)


def test_pack_configs_columns_follow_sc_keys():
    from repro_torch.core.engine.state import scalars_from_config
    from repro_torch.core import FabricTopology
    cfgs = [PCSConfig(scheme=Scheme.PB, crash_at_ns=77.0),
            PCSConfig(scheme=Scheme.PB_RF, n_tenants=2),
            PCSConfig(scheme=Scheme.PB_RF, n_tenants=2,
                      fabric=FabricTopology(3, (2, 5, 1), 4, (2, 0),
                                            bp_high=3.0))]
    scs = [scalars_from_config(c, 2, 1, 3) for c in cfgs]
    sct, tent, cht, fabt, ept, epb = cs.pack_configs(scs, 2, "cpu")
    assert sct.shape == (3, len(cs.SC_KEYS))
    # no schedule: one epoch, no bounds
    assert ept.shape == (3, 1, len(cs.EPOCH_SC_KEYS)
                         + len(cs.TENANT_KEYS) * 2 + 2 + 2)
    assert epb.shape == (3, 0)
    assert tent.shape == (3, len(cs.TENANT_KEYS), 2)
    assert cht.shape == (3, len(cs.CHAIN_KEYS) + len(cs.DEEP_KEYS))
    assert fabt.shape == (3, len(cs.FAB_KEYS) + 3 + 2)
    for j, sc in enumerate(scs):
        for i, k in enumerate(cs.SC_KEYS):
            assert float(sct[j, i]) == float(sc[k])
        for i, k in enumerate(cs.TENANT_KEYS):
            assert torch.equal(tent[j, i], sc[k])
        view = cs._config_view(sct, tent, cht, fabt, ept, epb, j)
        assert set(view) == set(sc)
        for k in (cs.CHAIN_KEYS + cs.DEEP_KEYS + cs.FAB_KEYS
                  + ("leaf_base", "leaf_of_t")):
            assert torch.equal(view[k].reshape(-1), sc[k].reshape(-1)), k


def test_pack_configs_epoch_rows():
    """A scheduled grid (E = 3): the tables hold epoch 0's rows, the
    epoch table every epoch's, and the view is the lowered dict, key for
    key with its (E,) axes and the INF-padded bounds."""
    from repro_torch.core import (AllocPolicy, DrainPolicy, FabricTopology,
                                  PBPolicy, Schedule)
    from repro_torch.core.engine.state import EPOCH_KEYS, scalars_from_config
    b = (1e4, 3e4)
    cfgs = [PCSConfig(scheme=Scheme.PB_RF, n_tenants=2, n_switches=3,
                      policy=PBPolicy(
                          drain=DrainPolicy(
                              threshold=Schedule(b, (0.75, 0.5, 0.875)),
                              preset=0.25,
                              latency_target_ns=Schedule(b, (None, 300.0,
                                                             200.0))),
                          alloc=AllocPolicy(tenant_quota=Schedule(
                              b, ((8, 8), (12, 4), (4, 12)))))),
            PCSConfig(scheme=Scheme.PB, n_tenants=2, fabric=FabricTopology(
                2, (4, 4), 4, Schedule((2e4,), ((0, 1), (1, 0))))),
            PCSConfig(scheme=Scheme.PB_RF, n_tenants=2)]
    scs = [scalars_from_config(c, 2, 2, 2, n_epochs_max=3) for c in cfgs]
    tables = cs.pack_configs(scs, 2, "cpu")
    ept, epb = tables[4:]
    assert ept.shape == (3, 3, len(cs.EPOCH_SC_KEYS)
                         + len(cs.TENANT_KEYS) * 2 + 2 * 2 + 2)
    assert epb.shape == (3, 2)
    for j, sc in enumerate(scs):
        view = cs._config_view(*tables, j)
        assert set(view) == set(sc)
        for k, v in sc.items():
            assert view[k].shape == v.shape and torch.equal(view[k], v), k
        flat = cs._config_view(*tables[:4], ept[:, :1], epb[:, :0], j)
        for k in EPOCH_KEYS:
            assert torch.equal(flat[k], sc[k][0]), k


def test_cell_scan_units_cover_every_instantiation(tmp_path):
    """The cell scan's split build: the generated units
    (``_build.unit_sources``) hold one (SPL, D, MAC) unit for each triple
    of every ``(SPL, D, FAB, EP, MAC)`` the wrapper dispatches to, and
    the entry unit; the source's runners take FAB (D >= 1), EP and MAC
    both ways; a source without the units' list builds as one unit."""
    import re
    from repro_torch.kernels import _build
    src = _build.CSRC / "cell_scan.cu"
    units = _build.unit_sources(src)
    pairs = set()
    for name, text in units.items():
        assert f'#include "{src.resolve()}"' in text, name
        if name == "entry":
            assert "#define CELL_SCAN_UNIT_ENTRY" in text
            continue
        spl, d, mac = (int(re.search(rf"#define CELL_SCAN_UNIT_{k} (\d+)",
                                     text).group(1))
                       for k in ("SPL", "D", "MAC"))
        assert name == f"s{spl}_d{d}_m{mac}"
        pairs.add((spl, d, bool(mac)))
    assert "entry" in units and len(units) == len(pairs) + 1
    dispatched = {cs.instantiation(p, d, nl, e, m)
                  for p in range(1, cs.MAX_PBE + 1)
                  for d in range(cs.MAX_DEEP + 1)
                  for nl in ((1, 2) if d else (1,)) for e in (1, 2)
                  for m in (False, True)}
    assert dispatched == set(cs.INSTANTIATIONS)
    assert len(dispatched) == 84
    assert {(s, d, m) for s, d, _, _, m in dispatched} == pairs
    body = src.read_text()
    for call in ("run_one<SPL, D, FAB, true, MAC>",
                 "run_one<SPL, D, FAB, false, MAC>",
                 "run_ep<SPL, D, true, MAC>", "run_ep<SPL, D, false, MAC>",
                 "run_ep<SPL, 0, false, MAC>", "run_d<SPL, D, MAC>",
                 "run_mac<true>", "run_mac<false>"):
        assert call in body, call
    one = tmp_path / "cell_scan.cu"
    one.write_text(re.sub(r"#define CELL_SCAN_UNITS\(X\)", "#define NONE",
                          body))
    assert _build.unit_sources(one) == {}


@pytest.mark.parametrize("name", sorted(cv.VARIANTS))
def test_cell_scan_variants_edits_apply(name):
    """Each A/B variant of the cell scan finds its anchors once in the
    source, cuts the units to SPL 1 at D = 0, 1 and 3 (MAC both ways),
    and (but for the yardstick ``units``) changes the kernel's text."""
    from repro_torch.kernels import _build
    text = (_build.CSRC / "cell_scan.cu").read_text()
    out = cv.variant_source(text, cv.VARIANTS[name])
    cut = cv.variant_source(text, [])
    assert (out == cut) == (name == "units")
    assert "X(1, 0, 0) X(1, 1, 0) X(1, 3, 0) X(1, 0, 1) X(1, 1, 1) " \
        "X(1, 3, 1)\n" in out and "X(2, 0" not in out
    with pytest.raises(ValueError):
        cv.variant_source(out, cv.VARIANTS[name] or [("no such text", "")])
