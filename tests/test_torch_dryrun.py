"""The port's dry-run (``launch.dryrun``) on the CPU: ``analytic_cell``
and ``_cache_bytes`` exactly the reference's for every (id, shape, 256
or 512 chips, moment bytes); the cell plan (activation spec, MoE routing
groups); cells at cut depth on the fake process group (their rows, the
DTensors' local bytes against the specs' arithmetic, one meta pass shared
by both meshes where the step is the same); the CLI's summary, exit code
and ``--set`` parsing.  The whole 80 cells run in ``chip_smoke.py``
phase 15a.  Every mesh here is entered and left through its context, so
no process group outlives a test.
"""
from __future__ import annotations

import dataclasses
import json
import os
import types

import pytest
import torch
import torch.distributed as dist

from _torch_ref import reference
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.launch.shapes import SHAPES
from repro_torch.models import transformer as tt


@pytest.fixture(scope="module")
def ref():
    """The reference's dry-run module; importing it appends
    ``--xla_force_host_platform_device_count=512`` to ``XLA_FLAGS``, so
    the backend is started first and the variable put back."""
    with reference() as r:
        import jax
        jax.devices()
        before = os.environ.get("XLA_FLAGS")
        try:
            from repro.launch import dryrun, shapes
        finally:
            if before is None:
                os.environ.pop("XLA_FLAGS", None)
            else:
                os.environ["XLA_FLAGS"] = before
        yield types.SimpleNamespace(r=r, dryrun=dryrun, shapes=shapes)


def _memo_param_count(monkeypatch, cls, counts):
    monkeypatch.setattr(cls, "param_count", lambda self: counts[self.name])


def test_analytic_cell_and_cache_bytes_are_the_references(ref, monkeypatch):
    """Exactly equal, for every id, shape, chip count and moment size.
    ``param_count`` is counted once per id (and equal in both packages),
    then read from that count in both."""
    rcls = type(ref.r.configs.get_config("smollm-135m"))
    counts = {}
    for arch in tconfigs.ARCHS:
        tcfg = tconfigs.get_config(arch)
        counts[tcfg.name] = tcfg.param_count()
        assert ref.r.configs.get_config(arch).param_count() \
            == counts[tcfg.name]
    _memo_param_count(monkeypatch, tt.ModelConfig, counts)
    _memo_param_count(monkeypatch, rcls, counts)
    n = 0
    for arch in tconfigs.ARCHS:
        tcfg = tconfigs.get_config(arch)
        rcfg = ref.r.configs.get_config(arch)
        for name, shape in SHAPES.items():
            rshape = ref.shapes.SHAPES[name]
            for chips in (256, 512):
                assert D._cache_bytes(tcfg, shape, chips) \
                    == ref.dryrun._cache_bytes(rcfg, rshape, chips)
                for mb in (2, 4):
                    assert D.analytic_cell(tcfg, shape, chips, mb) \
                        == ref.dryrun.analytic_cell(rcfg, rshape, chips, mb)
                    n += 1
    assert n == 160


@pytest.mark.parametrize("act_shard", ("none", "seq", "d"))
def test_cell_plan_is_the_references_choice(act_shard, monkeypatch):
    """``dryrun.py:96-111``'s choice: the batch dims over the data axes
    where the batch divides them, the activation spec per ``act_shard``,
    and that many MoE routing groups where the tokens divide them."""
    monkeypatch.setitem(tsh.FLAGS, "act_shard", act_shard)
    cfg = tconfigs.get_config("mixtral-8x7b")
    for mp, n in ((False, 16), (True, 32)):
        mesh = D._mesh_shape(mp)
        for name, shape in SHAPES.items():
            act, g = D.cell_plan(cfg, shape, mesh)
            bdim = None if name == "long_500k" else ("data",) if not mp \
                else ("pod", "data")
            want = {"none": (bdim,), "seq": (bdim, "model"),
                    "d": (bdim, None, "model")}[act_shard]
            assert act == want, (name, mp)
            assert g == (1 if name == "long_500k" else n), (name, mp)


def _cut(arch, layers, **kw):
    cfg = tconfigs.get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers, **kw)


# (config cut in depth, shape): each kind of step and model family
CUT_CELLS = (
    ("smollm-135m", dict(layers=2), "train_4k"),
    ("mixtral-8x7b", dict(layers=1), "prefill_32k"),
    ("jamba-1.5-large-398b", dict(layers=8), "decode_32k"),
    ("seamless-m4t-large-v2", dict(layers=1, n_enc_layers=1), "decode_32k"),
    ("mamba2-1.3b", dict(layers=2), "long_500k"),
)


def _arith_bytes(cfg, shape, mesh):
    """Each group's per-device bytes from the specs alone: every leaf's
    bytes over the product of the axes its spec splits it by."""
    def of(tree, spec_of):
        total = 0
        for name, t in tsh.leaves(tree).items():
            split = 1
            for e in spec_of(name, t):
                if e is not None:
                    split *= tsh._axis_size(mesh, e)
            assert t.numel() % split == 0, name
            total += t.numel() * t.element_size() // split
        return total
    params = dict(tspecs.params_specs(cfg).named_parameters())
    out = {"param": of(params, lambda n, t: tsh.param_spec(mesh, n, t))}
    if shape.kind == "train":
        out["opt"] = of(tspecs.opt_state_specs(cfg, D.opt_config(cfg),
                                               params),
                        lambda n, t: tsh.param_spec(mesh, n, t))
    if shape.kind == "decode":
        d = tspecs.decode_specs(cfg, shape)
        out["cache"] = of(d["caches"], lambda n, t: tsh.cache_spec(
            mesh, n, t, shape.global_batch))
    return out


@pytest.mark.parametrize("arch,cut,shape_name", CUT_CELLS)
def test_cells_at_cut_depth_on_the_fake_group(arch, cut, shape_name):
    """Both meshes' rows of one cell: ok, its chips, the DTensors' local
    bytes equal to the specs' arithmetic, the flops divided by the chips;
    one meta pass for both meshes unless MoE routing groups differ; and
    no process group left behind."""
    cut = dict(cut)
    cfg = _cut(arch, cut.pop("layers"), **cut)
    shape = SHAPES[shape_name]
    rows = D.run_cells(cfg, shape, [False, True], arch, verbose=False)
    assert not dist.is_initialized()
    assert [r["mesh"] for r in rows] == ["single", "multi"]
    for r, mp in zip(rows, (False, True)):
        assert r["status"] == "ok" and r["chips"] == (512 if mp else 256)
        want = _arith_bytes(cfg, shape, D._mesh_shape(mp))
        assert r["param_bytes_per_device"] == want["param"]
        assert r["opt_bytes_per_device"] == want.get("opt", 0)
        assert r["cache_bytes_per_device"] == want.get("cache", 0)
        assert r["flops"] > 0
        assert r["flops_per_device"] == r["flops"] / r["chips"]
        assert r["t_compute_s"] == r["flops_per_device"] / 989e12
        assert r["t_memory_s"] == r["analytic"]["traffic_bytes"] / 3.35e12
        assert r["bottleneck"] == ("compute" if r["t_compute_s"]
                                   >= r["t_memory_s"] else "memory")
        assert r["analytic"] == D.analytic_cell(
            cfg, shape, r["chips"], 2 if cfg.param_count() > 1e11 else 4)
    same_pass = rows[0]["flops"] == rows[1]["flops"]
    if cfg.n_experts and shape.global_batch > 1:
        assert (rows[0]["moe_groups"], rows[1]["moe_groups"]) == (16, 32)
    else:
        assert same_pass and rows[1]["meta_pass_s"] == rows[0]["meta_pass_s"]
    json.dumps(rows)


def test_the_flop_counter_counts_the_bf16_expert_products():
    """A bf16 ``bmm`` with ``out_dtype`` (the MoE expert products) counts
    2 b m n k, as an f32 ``bmm`` does."""
    from torch.utils.flop_counter import FlopCounterMode
    a = torch.empty((3, 5, 7), dtype=torch.bfloat16, device="meta")
    b = torch.empty((3, 7, 4), dtype=torch.bfloat16, device="meta")
    for kw in ({"out_dtype": torch.float32}, {}):
        counter = FlopCounterMode(
            display=False, custom_mapping={torch.ops.aten.bmm: D._bmm_flop})
        with counter:
            torch.bmm(a, b, **kw)
        assert counter.get_total_flops() == 2 * 3 * 5 * 7 * 4


def test_cli_summary_rows_and_exit_code(tmp_path, capsys):
    out = tmp_path / "rows.json"
    assert D.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                   "--mesh", "both", "--out", str(out)]) == 0
    assert capsys.readouterr().out.splitlines()[-1] \
        == "dry-run: 2 ok, 0 skipped, 0 FAILED"
    rows = json.loads(out.read_text())
    assert [(r["shape"], r["mesh"], r["status"]) for r in rows] == [
        ("decode_32k", "single", "ok"), ("decode_32k", "multi", "ok")]
    for key in ("collective_bytes_per_device", "collectives",
                "t_collective_s", "memory_analysis"):
        assert key not in rows[0]
    assert D.main(["--arch", "smollm-135m", "--shape", "long_500k"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] \
        == "dry-run: 0 ok, 2 skipped, 0 FAILED"
    assert D.run_cell("smollm-135m", "long_500k", True)["status"].startswith(
        "skipped")
    assert not dist.is_initialized()


def test_cli_counts_a_cell_that_does_not_trace_as_failed(monkeypatch,
                                                         capsys):
    def broken(*a, **kw):
        raise RuntimeError("does not trace")
    monkeypatch.setattr(D, "meta_pass", broken)
    assert D.main(["--arch", "smollm-135m", "--shape", "train_4k",
                   "--mesh", "single"]) == 1
    assert capsys.readouterr().out.splitlines()[-1] \
        == "dry-run: 0 ok, 0 skipped, 1 FAILED"
    assert not dist.is_initialized()


def test_cli_set_parses_flags_and_refuses_unknown_ones(monkeypatch):
    monkeypatch.setattr(tsh, "FLAGS", dict(tsh.FLAGS))
    monkeypatch.setattr(D, "_tasks", lambda *a: ([], []))
    assert D.main(["--set", "moe_expert_parallel=1", "--set",
                   "act_shard=seq", "--set", "batch_both=0"]) == 0
    assert tsh.FLAGS == {"moe_expert_parallel": True, "dense_pure_tp": False,
                         "act_shard": "seq", "batch_both": False,
                         "fsdp_same_dim": False}
    for bad in ("no_such_flag=1", "dense_pure_tp"):
        with pytest.raises(SystemExit) as e:
            D.main(["--set", bad])
        assert e.value.code == 2
