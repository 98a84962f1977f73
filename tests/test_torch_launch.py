"""The port's launch layer on the CPU, against the JAX reference:
``launch.shapes`` (``SHAPES``, ``applicable``, ``cells``); every
``launch.sharding`` spec (``param_spec`` for every parameter and
optimizer-state leaf of all ten ids on both production meshes, under the
default ``FLAGS`` and each of four knobs; ``batch_spec`` and
``cache_spec`` for every train, prefill and decode input); the DTensor
placements of those specs (each device's block the reference's); the
``launch.specs`` stand-ins' shapes and dtypes through
``models.convert``'s name map; ``make_prefill_step`` /
``make_decode_step`` against the reference's; and the meshes
(``launch.mesh``), each test ending the process group it starts.

The reference's ``param_spec`` / ``batch_spec`` / ``cache_spec`` read
only ``mesh.shape[name]`` and ``mesh.axis_names``, so they take a
stand-in mesh and need no devices (ROADMAP F2).  A port spec is the
reference's with its stacked ``reps`` entry dropped.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_ref import reference
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps as tsteps
from repro_torch.launch.serve import random_batch
from repro_torch.models import transformer as tt
from repro_torch.models.convert import (numpy_params, params_from_reference,
                                        reference_path)
from repro_torch.optim import AdamWConfig

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tconfigs.ARCHS
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}
# FLAGS settings held: the defaults and each knob that moves a spec
FLAG_SETS = {"default": {}, "moe_expert_parallel": {"moe_expert_parallel":
                                                     True},
             "dense_pure_tp": {"dense_pure_tp": True},
             "batch_both": {"batch_both": True},
             "fsdp_same_dim": {"fsdp_same_dim": True}}
SERVE_RTOL = 1e-3    # serve_ref.json's: of each step's largest |logit|


@pytest.fixture(scope="module")
def ref():
    """The reference's launch modules.  Importing its dry-run appends
    ``--xla_force_host_platform_device_count=512`` to ``XLA_FLAGS``; the
    backend is started first (so the flag changes nothing here) and the
    variable is put back."""
    with reference() as r:
        import jax
        jax.devices()
        before = os.environ.get("XLA_FLAGS")
        try:
            from repro.launch import dryrun, shapes, sharding, specs
        finally:
            if before is None:
                os.environ.pop("XLA_FLAGS", None)
            else:
                os.environ["XLA_FLAGS"] = before
        yield types.SimpleNamespace(r=r, dryrun=dryrun, shapes=shapes,
                                    sharding=sharding, specs=specs)


@pytest.fixture(scope="module")
def ref_params(ref):
    """arch -> the reference's parameter stand-ins (``jax.eval_shape``)."""
    return {a: ref.specs.params_specs(ref.r.configs.get_config(a))
            for a in ARCHS}


def _standins(name):
    axes, sizes = MESHES[name]
    return (types.SimpleNamespace(axis_names=axes,
                                  shape=dict(zip(axes, sizes))),
            types.SimpleNamespace(mesh_dim_names=axes, shape=sizes))


class _flags:
    """Both packages' FLAGS set to ``changes`` (the defaults otherwise)."""

    def __init__(self, ref, changes):
        self.dicts = (ref.sharding.FLAGS, tsh.FLAGS)
        self.changes = changes

    def __enter__(self):
        self.saved = [dict(d) for d in self.dicts]
        for d in self.dicts:
            d.update(self.changes)

    def __exit__(self, *exc):
        for d, s in zip(self.dicts, self.saved):
            d.clear()
            d.update(s)


def _norm(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _lookup(tree, path):
    for k in path:
        tree = (getattr(tree, k) if hasattr(tree, "_fields")
                else tree[int(k)] if isinstance(tree, (list, tuple))
                else tree[k])
    return tree


def _ref_leaf_spec(ref, rmesh, fn, ref_tree, path, *extra, stacked=None):
    """The reference's spec of the leaf at dotted ``path``, with a stacked
    leaf's ``reps`` entry dropped (every cache leaf is stacked; a
    parameter is under ``blocks`` or ``enc_blocks``), and that leaf's
    per-layer shape and dtype."""
    keys = path.split(".")
    leaf = _lookup(ref_tree, keys)
    spec = _norm(fn(rmesh, keys, leaf, *extra), len(leaf.shape))
    if stacked is None:
        stacked = bool({"blocks", "enc_blocks"} & set(keys[:2]))
    if stacked:
        assert spec[0] is None, (path, spec)
        return spec[1:], tuple(leaf.shape[1:]), leaf.dtype
    return spec, tuple(leaf.shape), leaf.dtype


# ------------------------------------------------------------------ shapes
def test_shapes_applicable_and_cells_are_the_references(ref):
    assert {k: tuple(vars(v).values()) for k, v in tshapes.SHAPES.items()} \
        == {k: tuple(vars(v).values())
            for k, v in ref.shapes.SHAPES.items()}
    skipped = []
    for arch in ARCHS:
        tcfg = tconfigs.get_config(arch)
        rcfg = ref.r.configs.get_config(arch)
        for name, shape in tshapes.SHAPES.items():
            got = tshapes.applicable(tcfg, shape)
            assert got == ref.shapes.applicable(rcfg,
                                                ref.shapes.SHAPES[name])
            skipped += [] if got else [(arch, name)]
        assert [s.name for s in tshapes.cells(tcfg)] \
            == [s.name for s in ref.shapes.cells(rcfg)]
    assert len(skipped) == 5 and {s for _, s in skipped} == {"long_500k"}


# --------------------------------------------------------- parameter specs
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("flags", FLAG_SETS)
def test_param_specs_are_the_references(ref, ref_params, flags, mesh_name):
    """Every parameter and AdamW-state leaf of all ten ids: the port's spec
    (by the port's name) is the reference's (by the leaf's reference path
    from ``models.convert.reference_path``), stacked entry dropped; and
    the leaf's shape and dtype are the reference stand-in's."""
    rmesh, tmesh_ = _standins(mesh_name)
    seen = set()
    with _flags(ref, FLAG_SETS[flags]):
        for arch in ARCHS:
            tcfg = tconfigs.get_config(arch)
            rtree = ref_params[arch]
            ropt = {"m": rtree, "v": rtree}
            params = dict(tspecs.params_specs(tcfg).named_parameters())
            opt = tspecs.opt_state_specs(tcfg, AdamWConfig(), params)
            assert set(opt) == {"m", "v", "step"}
            for name, leaf in itertools.chain(
                    params.items(), (("m." + n, t) for n, t in params.items()),
                    (("v." + n, t) for n, t in params.items())):
                head, pname = ((name[:2], name[2:])
                               if name[:2] in ("m.", "v.") else ("", name))
                path = head + reference_path(tcfg, pname)[0]
                want, shape, dtype = _ref_leaf_spec(
                    ref, rmesh, ref.sharding.param_spec,
                    ropt if head else rtree, path)
                got = tsh.param_spec(tmesh_, name, leaf)
                assert got == want, (arch, name, got, want)
                assert tuple(leaf.shape) == shape, (arch, name)
                assert str(leaf.dtype).split(".")[-1] == str(dtype), name
                seen.add(got)
            step = opt["step"]
            assert tsh.param_spec(tmesh_, "step", step) == tuple(
                ref.sharding.param_spec(rmesh, ["step"], step))
    # the rules reach sharded and replicated leaves alike
    assert () in seen or (None,) in seen
    assert any(any(e is not None for e in s) for s in seen)


# ---------------------------------------------------- batch and cache specs
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("flags", ("default", "batch_both"))
def test_batch_and_cache_specs_are_the_references(ref, flags, mesh_name):
    """Every input of every applicable cell: the train and prefill batch
    (``batch_spec``), and for each decode cell (batch 128 and batch 1)
    its tokens, encoder output and every per-layer cache leaf
    (``cache_spec``, against the reference's stacked leaf of the layer's
    block position), with the stand-ins' shapes and dtypes."""
    rmesh, tmesh_ = _standins(mesh_name)
    kinds = set()
    with _flags(ref, FLAG_SETS[flags]):
        for arch in ARCHS:
            tcfg = tconfigs.get_config(arch)
            rcfg = ref.r.configs.get_config(arch)
            for shape in tshapes.cells(tcfg):
                rshape = ref.shapes.SHAPES[shape.name]
                rb = ref.specs.train_batch_specs(rcfg, rshape)
                tb = tspecs.train_batch_specs(tcfg, shape)
                assert set(tb) == set(rb)
                for k, leaf in tb.items():
                    assert tuple(leaf.shape) == rb[k].shape
                    assert str(leaf.dtype).split(".")[-1] == str(rb[k].dtype)
                    assert tsh.batch_spec(tmesh_, leaf) == _norm(
                        ref.sharding.batch_spec(rmesh, rb[k]), leaf.ndim)
                if shape.kind != "decode":
                    continue
                rd = ref.specs.decode_specs(rcfg, rshape)
                td = tspecs.decode_specs(tcfg, shape)
                assert set(td) == set(rd)
                for k in set(td) - {"caches"}:
                    leaf = td[k]
                    assert tuple(leaf.shape) == rd[k].shape, k
                    assert str(leaf.dtype).split(".")[-1] == str(
                        rd[k].dtype), k
                    if k in ("tokens_last", "enc_out"):
                        assert tsh.batch_spec(tmesh_, leaf) == _norm(
                            ref.sharding.batch_spec(rmesh, rd[k]), leaf.ndim)
                assert len(td["caches"]) == tcfg.n_layers
                pat = len(tcfg.block_pattern)
                for i, cache in enumerate(td["caches"]):
                    for field, leaf in zip(cache._fields, cache):
                        want, shape_, dtype = _ref_leaf_spec(
                            ref, rmesh,
                            lambda m, p, l, b: ref.sharding.cache_spec(
                                m, p, l, b), rd["caches"],
                            f"{i % pat}.{field}", shape.global_batch,
                            stacked=True)
                        got = tsh.cache_spec(tmesh_, f"{i}.{field}", leaf,
                                             shape.global_batch)
                        assert got == want, (arch, shape.name, i, field)
                        assert tuple(leaf.shape) == shape_
                        assert str(leaf.dtype).split(".")[-1] == str(dtype)
                        kinds.add((field, shape.global_batch, got != (None,)
                                   * leaf.ndim))
    assert {("k", 128, True), ("k", 1, True), ("state", 128, True),
            ("conv", 1, True)} <= kinds


# -------------------------------------------------------------- placements
def _jax_offset(entry, coord, names, sizes, block):
    """JAX's block offset for a dim split over ``entry``'s axes, the
    first-named axis major."""
    idx = 0
    for a in entry:
        idx = idx * sizes[names.index(a)] + coord[names.index(a)]
    return idx * block


@pytest.mark.parametrize("mesh_name", MESHES)
def test_placements_put_the_references_block_on_each_device(mesh_name):
    """For each way a spec splits a dim (one axis, the data axes, the
    cache's ('data', 'model'), ``fsdp_same_dim``'s ('model', 'data') and
    ``batch_both``'s axes), every device's offset and shape under
    :func:`placements` are those JAX gives the device at the same mesh
    coordinate."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_and_offset
    names, sizes = MESHES[mesh_name]
    mesh = types.SimpleNamespace(mesh_dim_names=names, shape=sizes)
    dp = tmesh.data_axes(mesh)
    entries = [("model",), ("data",), dp, ("data", "model"),
               ("model", "data"), dp + ("model",)]
    for entry in entries:
        n = 1
        for a in entry:
            n *= sizes[names.index(a)]
        block = 3
        for spec in ((entry, None), (None, entry)):
            shape = [5, 5]
            d = spec.index(entry)
            shape[d] = n * block
            pl = tsh.placements(mesh, spec)
            assert tsh.local_shape(mesh, shape, spec)[d] == block
            for coord in itertools.product(*map(range, sizes)):
                loc, off = local_and_offset(shape, sizes, list(coord), pl)
                assert loc[d] == block and loc[1 - d] == 5, (entry, coord)
                assert off[d] == _jax_offset(entry, coord, names, sizes,
                                             block), (entry, coord, pl)
                assert off[1 - d] == 0


# ----------------------------------------------------------------- DTensors
def test_shard_tree_on_the_production_mesh_gives_local_blocks():
    """smollm-135m at full width on the fake 16 x 16 group: a meta DTensor
    for every parameter, AdamW-state, batch and cache leaf, its
    placements those of its spec and its local shape the spec's block;
    the group is gone after the mesh's context."""
    cfg = tconfigs.get_config("smollm-135m")
    shape = tshapes.SHAPES["decode_32k"]
    params = dict(tspecs.params_specs(cfg).named_parameters())
    opt = tspecs.opt_state_specs(cfg, AdamWConfig(), params)
    d = tspecs.decode_specs(cfg, shape)
    with tmesh.make_production_mesh() as mesh:
        assert dist.is_initialized() and dist.get_world_size() == 256
        assert mesh.shape == (16, 16) and mesh.mesh_dim_names == (
            "data", "model")
        groups = {
            "params": (tsh.shard_tree(mesh, params),
                       lambda n, t: tsh.param_spec(mesh, n, t), params),
            "opt": (tsh.shard_tree(mesh, opt),
                    lambda n, t: tsh.param_spec(mesh, n, t), opt),
            "batch": (tsh.shard_batch(mesh, {"t": d["tokens_last"]}),
                      lambda n, t: tsh.batch_spec(mesh, t),
                      {"t": d["tokens_last"]}),
            "caches": (tsh.shard_caches(mesh, d["caches"], 128),
                       lambda n, t: tsh.cache_spec(mesh, n, t, 128),
                       d["caches"])}
        local_bytes = 0
        for what, (dts, spec_of, tree) in groups.items():
            src = tsh.leaves(tree)
            got = tsh.leaves(dts)
            assert set(got) == set(src), what
            for name, dt in got.items():
                spec = spec_of(name, src[name])
                assert list(dt.placements) == tsh.placements(mesh, spec)
                assert dt.shape == src[name].shape and dt.device.type == \
                    "meta"
                assert tuple(dt.to_local().shape) == tsh.local_shape(
                    mesh, src[name].shape, spec), (what, name)
                local_bytes += dt.to_local().numel() * dt.element_size()
        # the embedding splits vocab over model and d over data
        emb = tsh.leaves(groups["params"][0])["embed.table"]
        assert tuple(emb.to_local().shape) == (49152 // 16, 576 // 16)
        assert local_bytes > 0
    assert not dist.is_initialized()


def test_meshes_refuse_a_second_group_and_end_their_own():
    with tmesh.make_production_mesh(multi_pod=True) as mesh:
        assert mesh.shape == (2, 16, 16) and tmesh.data_axes(mesh) == (
            "pod", "data")
        with pytest.raises(RuntimeError, match="already alive"):
            with tmesh.make_host_mesh("cpu"):
                pass
        assert dist.get_world_size() == 512
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        with tmesh.make_production_mesh():
            raise RuntimeError("inside")
    assert not dist.is_initialized()


def test_host_mesh_on_the_cpu_holds_whole_tensors():
    """The 1 x 1 gloo mesh: ``shard_tree`` places a smoke model's weights
    and AdamW state whole (each local tensor equals its global one)."""
    cfg = tconfigs.get_config("smollm-135m", smoke=True)
    model = params_from_reference(cfg, numpy_params(cfg, 0), "cpu")
    params = dict(model.named_parameters())
    opt = tspecs.opt_state_specs(cfg, AdamWConfig(), params)
    with tmesh.make_host_mesh("cpu") as mesh:
        assert mesh.device_type == "cpu" and mesh.shape == (1, 1)
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        for tree in (params, opt):
            src = tsh.leaves(tree)
            for name, dt in tsh.leaves(tsh.shard_tree(mesh, tree)).items():
                assert torch.equal(dt.to_local(), src[name]), name
    assert not dist.is_initialized()
    if not torch.cuda.is_available():      # the card's unless asked
        with pytest.raises(RuntimeError, match="CUDA"):
            with tmesh.make_host_mesh():
                pass


# ----------------------------------------------------- prefill and decode
def _j(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("arch", ("smollm-135m", "seamless-m4t-large-v2"))
def test_prefill_and_decode_steps_match_the_references(ref, arch):
    """``make_prefill_step`` / ``make_decode_step`` at smoke size against
    the reference's on the same weights and prompt: the prefill's logits
    and 3 greedy decode steps' (the encoder-decoder's with its encoder
    output passed through the step), each within 1e-3 of the step's
    largest |logit| (serve_ref.json's limit)."""
    import jax.numpy as jnp
    R = ref.r
    tcfg = tconfigs.get_config(arch, smoke=True)
    rcfg = R.configs.get_config(arch, smoke=True)
    tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    rcfg = dataclasses.replace(rcfg, dtype=jnp.float32)
    tree = numpy_params(tcfg, 0)
    model = params_from_reference(tcfg, tree, "cpu")
    batch = random_batch(tcfg, 2, 16, 0, "cpu")
    max_len = 16 + 4
    from repro.launch import steps as rsteps
    rpre = rsteps.make_prefill_step(rcfg, max_len)
    rdec = rsteps.make_decode_step(rcfg)
    rparams = _j(tree)
    rbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    with torch.inference_mode():
        tl, tc = tsteps.make_prefill_step(model, max_len)(batch)
        enc = {}
        if tcfg.is_enc_dec:
            eo, ep = model.encode(batch["enc_embeds"])
            enc = {"enc_out": eo, "enc_pos": ep}
        rl, rc = rpre(rparams, rbatch)
        renc = {}
        if rcfg.is_enc_dec:
            renc = {"enc_out": jnp.asarray(enc["enc_out"].numpy()),
                    "enc_pos": jnp.asarray(enc["enc_pos"].numpy())}
        dec = tsteps.make_decode_step(model)
        for i in range(4):
            want = np.asarray(rl)
            got = tl.numpy()
            scale = np.abs(want).max(axis=1, keepdims=True)
            assert np.max(np.abs(got - want) / scale) <= SERVE_RTOL, i
            if i == 3:
                break
            tok = np.argmax(want, axis=1)[:, None].astype(np.int32)
            pos = 16 + i
            tl, tc = dec(torch.from_numpy(tok), tc, pos, **enc)
            rl, rc = rdec(rparams, jnp.asarray(tok), rc, pos, **renc)


def test_serve_goes_through_the_steps(monkeypatch):
    """``launch.serve.serve`` prefills and decodes through the two step
    makers: one prefill step and ``gen`` decode steps."""
    from repro_torch.launch import serve as tserve
    calls = {"prefill": 0, "decode": 0}
    real_p, real_d = tserve.make_prefill_step, tserve.make_decode_step

    def prefill(model, max_len):
        step = real_p(model, max_len)
        return lambda *a: (calls.__setitem__("prefill", calls["prefill"] + 1)
                           or step(*a))

    def decode(model):
        step = real_d(model)
        return lambda *a: (calls.__setitem__("decode", calls["decode"] + 1)
                           or step(*a))
    monkeypatch.setattr(tserve, "make_prefill_step", prefill)
    monkeypatch.setattr(tserve, "make_decode_step", decode)
    cfg = tconfigs.get_config("smollm-135m", smoke=True)
    model = params_from_reference(cfg, numpy_params(cfg, 0), "cpu")
    res = tserve.serve(model, random_batch(cfg, 2, 8, 0, "cpu"), 3)
    assert calls == {"prefill": 1, "decode": 3}
    assert res.tokens.shape == (2, 3)


def test_activation_sharding_records_and_constrains_nothing():
    assert tt.activation_spec() is None
    with tt.activation_sharding((("data",), "model")):
        assert tt.activation_spec() == (("data",), "model")
        with tt.activation_sharding(None):
            assert tt.activation_spec() is None
        assert tt.activation_spec() == (("data",), "model")
    assert tt.activation_spec() is None


def test_the_port_imports_neither_jax_nor_the_reference():
    """No module of ``src/repro_torch`` names ``jax`` or the ``repro``
    package in an import."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert any(f.name == "dryrun.py" for f in files)
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad
