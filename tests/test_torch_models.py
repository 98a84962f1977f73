"""The model side of the port on the CPU, against the JAX reference.

Every comparison feeds both packages the same numpy inputs and the same
``numpy_params`` tree (f32, smoke sizes): the layers, attention (prefill
with a cache, then decode), the SSD block, and whole ``smollm-smoke``
and ``mamba2-smoke`` models through prefill and decode.  Tolerance: the
port repeats the reference's f32 math in another summation order, so
values agree to ~1e-6 relative; the bounds below are 2e-5 on
layer outputs and 1e-4 relative to the largest logit on whole models.

Also here: the full-width layout (on the meta device, no allocation)
against ``jax.eval_shape`` of the reference's ``init_params``; the shape
of ``serve_ref.json``; import hygiene; the changes the scope rule once
refused, against the reference; the device rule; and the serve CLI.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_ref import reference
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.models.convert import (numpy_params, param_shapes,
                                        params_from_reference,
                                        reference_tree)

TOL = 2e-5
MODEL_RTOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]
SERVE_REF = ROOT / "src" / "repro_torch" / "testdata" / "serve_ref.json"
SMOKE = ("smollm-135m", "mamba2-1.3b")


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jtree(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


def _err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


# ------------------------------------------------------------------ layers
def test_layers_match_reference(ref):
    import jax.numpy as jnp
    L = ref.layers
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(16)).astype(np.float32)
    assert _err(tl.rmsnorm(_t(scale), _t(x)),
                L.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))) < TOL

    table = rng.standard_normal((11, 16)).astype(np.float32)
    ids = rng.integers(0, 11, (2, 5))
    assert _err(tl.embed(_t(table), _t(ids)),
                L.embed({"table": jnp.asarray(table)}, jnp.asarray(ids))) == 0
    assert _err(tl.unembed(_t(table), _t(x)),
                L.unembed({"table": jnp.asarray(table)}, jnp.asarray(x))) < TOL

    w = {k: rng.standard_normal(s).astype(np.float32) / 4
         for k, s in (("gate", (16, 24)), ("up", (16, 24)),
                      ("down", (24, 16)))}
    mlp = tl.MLP(16, 24, torch.float32, "cpu")
    for k, a in w.items():
        getattr(mlp, k).w.data.copy_(_t(a))
    assert _err(mlp(_t(x)), L.mlp({k: {"w": jnp.asarray(a)}
                                   for k, a in w.items()},
                                  jnp.asarray(x))) < TOL

    xh = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(7, 12)
    for theta in (10_000.0, 500.0):
        assert _err(tl.apply_rope(_t(xh), _t(pos), theta),
                    L.apply_rope(jnp.asarray(xh), jnp.asarray(pos),
                                 theta)) < TOL
    assert _err(tl.softcap(_t(x) * 40, 30.0),
                L.softcap(jnp.asarray(x) * 40, 30.0)) < 1e-4
    assert tl.softcap(_t(x), None) is not None


# --------------------------------------------------------------- attention
def test_attention_prefill_then_decode_matches_reference(ref):
    import jax.numpy as jnp
    d, h, hkv, hd, b, s, alloc = 32, 4, 2, 16, 2, 12, 16
    rng = np.random.default_rng(1)
    w = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
         "wo": (h * hd, d)}
    w = {k: (rng.standard_normal(sh) / math.sqrt(sh[0])).astype(np.float32)
         for k, sh in w.items()}
    jp = {k: {"w": jnp.asarray(a)} for k, a in w.items()}
    mod = tattn.Attention(d, h, hkv, hd, dtype=torch.float32, device="cpu")
    for k, a in w.items():
        getattr(mod, k).w.data.copy_(_t(a))
    kw = dict(n_heads=h, n_kv_heads=hkv, head_dim=hd)

    x = rng.standard_normal((b, s + 3, d)).astype(np.float32)
    jc = ref.attention.init_kv_cache(b, alloc, hkv, hd, jnp.float32)
    tc = tattn.init_kv_cache(b, alloc, hkv, hd, torch.float32, "cpu")
    for lo, hi in ((0, s), (s, s + 1), (s + 1, s + 2), (s + 2, s + 3)):
        pos = np.arange(lo, hi)
        jy, jc = ref.attention.attention(jp, jnp.asarray(x[:, lo:hi]),
                                         jnp.asarray(pos), cache=jc, **kw)
        ty, tc = mod(_t(x[:, lo:hi]), _t(pos), cache=tc)
        assert _err(ty, jy) < TOL, (lo, hi)
        for f in ("k", "v", "pos", "length"):
            assert _err(getattr(tc, f), getattr(jc, f)) < TOL, f

    # training mode (no cache): causal over the fresh K/V
    jy, _ = ref.attention.attention(jp, jnp.asarray(x), jnp.arange(s + 3),
                                    **kw)
    ty, none = mod(_t(x), torch.arange(s + 3))
    assert none is None and _err(ty, jy) < TOL


# --------------------------------------------------------------------- ssd
def _ssd_params(rng, d, n, hd, expand=2):
    di = expand * d
    h = di // hd
    conv_dim = di + 2 * n
    f = np.float32
    return {
        "in_proj": {"w": (rng.standard_normal((d, 2 * di + 2 * n + h))
                          / math.sqrt(d)).astype(f)},
        "conv_w": (0.1 * rng.standard_normal((4, conv_dim))).astype(f),
        "conv_b": (0.1 * rng.standard_normal(conv_dim)).astype(f),
        "A_log": np.log(rng.uniform(1, 8, h)).astype(f),
        "D": rng.uniform(0.5, 1.5, h).astype(f),
        "dt_bias": np.log(np.expm1(rng.uniform(0.01, 0.1, h))).astype(f),
        "out_proj": {"w": (rng.standard_normal((di, d))
                           / math.sqrt(di)).astype(f)},
    }


@pytest.mark.parametrize("s,warm", [(100, False), (64, True)])
def test_ssd_block_prefill_then_decode_matches_reference(ref, s, warm):
    """Prefill through the chunked scan (ragged S, zero or carried state),
    then decode steps through the recurrence."""
    import jax.numpy as jnp
    d, n, hd, b, chunk = 32, 16, 16, 2, 32
    rng = np.random.default_rng(2 + s)
    p = _ssd_params(rng, d, n, hd)
    mod = tssm.SSDBlock(d, d_state=n, head_dim=hd, chunk=chunk,
                        dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for k, a in p.items():
            (getattr(mod, k).w if isinstance(a, dict)
             else getattr(mod, k)).copy_(_t(a["w"] if isinstance(a, dict)
                                            else a))
    jp = _jtree(p)
    jc = ref.ssm.init_ssm_cache(b, d, d_state=n, head_dim=hd,
                                dtype=jnp.float32)
    tc = tssm.init_ssm_cache(b, d, d_state=n, head_dim=hd,
                             dtype=torch.float32, device="cpu")
    if warm:
        st = rng.standard_normal(tc.state.shape).astype(np.float32)
        jc, tc = jc._replace(state=jnp.asarray(st)), tc._replace(state=_t(st))
    x = rng.standard_normal((b, s + 2, d)).astype(np.float32)
    for lo, hi in ((0, s), (s, s + 1), (s + 1, s + 2)):
        jy, jc = ref.ssm.ssd_block(jp, jnp.asarray(x[:, lo:hi]), d_state=n,
                                   head_dim=hd, chunk=chunk, cache=jc)
        ty, tc = mod(_t(x[:, lo:hi]), cache=tc)
        assert _err(ty, jy) < 1e-4, (lo, hi)
        assert _err(tc.conv, jc.conv) < TOL
        assert _err(tc.state, jc.state) < 1e-4


# ------------------------------------------------------------ whole model
def _models(ref, arch, seed=0):
    jcfg = ref.configs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    tree = numpy_params(tcfg, seed)
    return jcfg, tcfg, tree, params_from_reference(tcfg, tree, "cpu")


def _rel(got, want):
    return _err(got, want) / float(np.max(np.abs(np.asarray(want))))


@pytest.mark.parametrize("arch", SMOKE)
def test_model_prefill_and_decode_match_reference(ref, arch):
    import jax.numpy as jnp
    jcfg, tcfg, tree, model = _models(ref, arch)
    jparams = _jtree(tree)
    b, s, steps = 2, 70, 4
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (b, s + steps))
    jl, jc = ref.transformer.prefill(jcfg, jparams,
                                     {"tokens": jnp.asarray(toks[:, :s])},
                                     s + steps)
    with torch.inference_mode():
        tlog, tc = tt.prefill(model, {"tokens": _t(toks[:, :s])}, s + steps)
    assert _rel(tlog, jl) < MODEL_RTOL
    P = len(tcfg.block_pattern)
    for i, c in enumerate(tc):
        jcache = jc[i % P]
        for f in c._fields:
            assert _err(getattr(c, f), getattr(jcache, f)[i // P]) \
                < 1e-4, (i, f)
    for t in range(s, s + steps):
        jl, jc = ref.transformer.decode_step(
            jcfg, jparams, jnp.asarray(toks[:, t:t + 1]), jc,
            pos0=jnp.asarray(t, jnp.int32))
        with torch.inference_mode():
            tlog, tc = tt.decode_step(model, _t(toks[:, t:t + 1]), tc,
                                      pos0=t)
        assert _rel(tlog, jl) < MODEL_RTOL, t


@pytest.mark.parametrize("arch", SMOKE)
def test_forward_matches_reference_and_decode(ref, arch):
    """Training-mode forward against the reference's, and the port's own
    decode-versus-forward consistency (tests/test_models.py's contract)."""
    import jax.numpy as jnp
    jcfg, tcfg, tree, model = _models(ref, arch, seed=1)
    b, s = 2, 40
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (b, s))
    jl, _ = ref.transformer.forward(jcfg, _jtree(tree),
                                    {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tlog = model(_t(toks))
        assert tlog.shape == (b, s, tcfg.vocab)
        assert _rel(tlog, jl) < MODEL_RTOL
        _, caches = tt.prefill(model, {"tokens": _t(toks[:, :s - 1])}, s + 4)
        dec, _ = tt.decode_step(model, _t(toks[:, s - 1:]), caches,
                                pos0=s - 1)
    assert _rel(dec, tlog[:, s - 1]) < MODEL_RTOL


# ------------------------------------------------------- full-width layout
@pytest.mark.parametrize("arch", tconfigs.PORTED)
def test_full_width_layout_matches_reference_init_params(ref, arch):
    """Built on the meta device (nothing allocated): the port's weights in
    the reference layout have exactly the leaf shapes of the reference's
    ``init_params``, its parameter count and its active parameter count
    (MoE: top_k of n_experts)."""
    import jax
    jcfg = ref.configs.get_config(arch)
    tcfg = tconfigs.get_config(arch)
    model = tt.Transformer(tcfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    shapes = jax.eval_shape(
        lambda: ref.transformer.init_params(jcfg, jax.random.key(0)))
    want = jax.tree.map(lambda a: tuple(a.shape), shapes)
    got = jax.tree.map(lambda t: tuple(t.shape), reference_tree(model))
    assert got == want
    assert param_shapes(tcfg) == want
    dtypes = {p.dtype for p in model.parameters()}
    assert dtypes == {torch.bfloat16, torch.float32}
    total = jcfg.param_count()
    assert tcfg.param_count() == total
    assert sum(p.numel() for p in model.parameters()) == total
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert (tcfg.active_param_count() < total) == bool(tcfg.n_experts)


def test_serve_ref_datum_has_the_shape_chip_smoke_reads():
    d = json.loads(SERVE_REF.read_text())
    assert {"what", "script", "command", "rtol", "configs"} <= set(d)
    assert "numpy_params" in d["script"]
    assert 0 < d["rtol"] < 1e-2
    for arch in SMOKE:
        c = d["configs"][arch]
        cfg = tconfigs.get_config(arch)
        b, s = c["batch"], c["prompt_len"]
        prompt = np.asarray(c["prompt"])
        assert prompt.shape == (b, s) and prompt.max() < cfg.vocab
        assert c["seed"] == 0 and c["layers"] >= 1
        assert len(c["steps"]) == c["decode_steps"] + 1
        for step in c["steps"]:
            ids, logits = np.asarray(step["ids"]), np.asarray(step["logits"])
            assert ids.shape == logits.shape == (b, 16)
            assert np.all(np.isfinite(logits))
            assert step["greedy"] == ids[:, 0].tolist()
            assert np.all(np.diff(logits, axis=1) <= 0)


# ------------------------------------------------------- rules of the port
def test_importing_the_port_pulls_in_no_jax_or_reference():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert {'repro_torch.launch.serve', 'repro_torch.models.convert',"
        " 'repro_torch.kernels.ssd_scan', 'repro_torch.persistence.store',"
        " 'repro_torch.persistence.manager', 'repro_torch.optim.adamw',"
        " 'repro_torch.optim.compress', 'repro_torch.data.pipeline',"
        " 'repro_torch.runtime.failures', 'repro_torch.runtime.elastic',"
        " 'repro_torch.runtime.straggler', 'repro_torch.launch.steps',"
        " 'repro_torch.launch.train'} <= set(names), names\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 40


@pytest.mark.parametrize("change", [
    dict(attn_softcap=50.0), dict(final_softcap=30.0), dict(qk_norm=True),
    dict(window=8, block_pattern=(tt.LayerSpec("swa"),)),
    dict(frontend="vision", frontend_seq=4), dict(n_enc_layers=2)])
def test_former_scope_changes_match_reference(ref, change):
    """Each change that the scope guard once refused now builds, and its
    forward matches the reference's on the same tree and inputs."""
    import dataclasses
    import jax.numpy as jnp
    cfg = dataclasses.replace(tconfigs.get_config("smollm-135m", smoke=True),
                              **change)
    jcfg = dataclasses.replace(
        ref.configs.get_config("smollm-135m", smoke=True), **{
            k: (tuple(ref.transformer.LayerSpec(*x) for x in v)
                if k == "block_pattern" else v) for k, v in change.items()})
    tree = numpy_params(cfg, 2)
    model = params_from_reference(cfg, tree, "cpu")
    rng = np.random.default_rng(6)
    b, s = 2, 20
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s))}
    if cfg.is_enc_dec:
        batch["enc_embeds"] = rng.standard_normal(
            (b, 5, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["prefix_embeds"] = rng.standard_normal(
            (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    jl, _ = ref.transformer.forward(jcfg, _jtree(tree),
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    with torch.inference_mode():
        tl, _ = tt.forward(model, {k: _t(v) for k, v in batch.items()})
    assert tl.shape == (b, s, cfg.vocab)
    assert _rel(tl, jl) < MODEL_RTOL


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_config("smollm-135m", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Transformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_reference(cfg, numpy_params(cfg, 0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "smollm-135m", "--smoke"])


@pytest.mark.parametrize("arch", SMOKE)
def test_serve_cli_matches_reference_greedy_decode(ref, arch, capsys):
    """The CLI's tokens are the reference's greedy tokens on the same
    weights and prompt."""
    import jax.numpy as jnp
    b, s, gen = 2, 24, 6
    res = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", str(b), "--prompt-len", str(s),
                       "--gen", str(gen), "--seed", "5"])
    assert "first sequence:" in capsys.readouterr().out
    jcfg = ref.configs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    params = _jtree(numpy_params(tcfg, 5))
    prompt = tserve.random_batch(tcfg, b, s, 5, "cpu")["tokens"].numpy()
    logits, caches = ref.transformer.prefill(
        jcfg, params, {"tokens": jnp.asarray(prompt)}, s + gen)
    want = []
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    for i in range(gen):
        want.append(np.asarray(tok)[:, 0])
        logits, caches = ref.transformer.decode_step(
            jcfg, params, tok, caches, pos0=jnp.asarray(s + i, jnp.int32))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    assert res.tokens.shape == (b, gen)
    assert np.array_equal(res.tokens, np.stack(want, axis=1))
