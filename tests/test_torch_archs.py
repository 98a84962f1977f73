"""The attention family of the port on the CPU, against the JAX reference:
sliding windows and their ring caches, logit softcaps, qk-norm, per-kind
RoPE bases, the prefix-LM mask, cross-attention and the encoder stack
(gemma2-2b, gemma3-12b, paligemma-3b, seamless-m4t-large-v2,
deepseek-67b at smoke size, f32).

Both packages get the same ``numpy_params`` tree and the same numpy
inputs.  Tolerances: ``MODEL_RTOL`` (1e-4) of the largest |logit| on
logits, 2e-5 absolute on cache fields, ``GRAD_RTOL`` (1e-4) of each
leaf's largest |gradient| on gradients, 1e-5 relative on losses and on
a lone ``_sdpa``; masks and greedy tokens exactly.  The port repeats the reference's f32 math in
other summation orders, so values agree to ~1e-6 relative.

Also here: twins of ``tests/test_models.py``'s softcap, qk-norm,
encoder-decoder and vision-prefix tests with the decode-versus-forward
contract (the enc-dec decoding given its encoder output), the kernel's
route per layer contract, the shape of
``testdata/serve_ref_families.json``, and two train steps of the
frontend and softcap configs against the reference's
``make_train_step``.  The serve CLI against the reference's launcher is
in ``tests/test_torch_archs_serve_cli.py``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_ref import reference
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models.convert import (numpy_params, params_from_reference,
                                        stack_layers)

MODEL_RTOL = 1e-4
CACHE_TOL = 2e-5
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
NEW = ("gemma2-2b", "gemma3-12b", "paligemma-3b", "seamless-m4t-large-v2",
       "deepseek-67b")
ROOT = Path(__file__).resolve().parents[1]
FAMILIES_REF = (ROOT / "src" / "repro_torch" / "testdata"
                / "serve_ref_families.json")


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


def _err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


def _rel(got, want):
    return _err(got, want) / float(np.max(np.abs(np.asarray(want))))


def _stubs(cfg, b, s, rng):
    """The config's stub inputs as numpy (f32): frames for an enc-dec,
    patch embeddings for the vision frontend."""
    out = {}
    if cfg.is_enc_dec:
        out["enc_embeds"] = rng.standard_normal(
            (b, max(s // 4, 3), cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = rng.standard_normal(
            (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return out


def _pair(ref, cfg, seed=0):
    """(the reference's twin config, numpy tree, the port's model)."""
    jcfg = ref.transformer.ModelConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name not in ("block_pattern", "dtype")},
        block_pattern=tuple(ref.transformer.LayerSpec(*s)
                            for s in cfg.block_pattern),
        dtype=ref.configs.get_config("smollm-135m", smoke=True).dtype)
    tree = numpy_params(cfg, seed)
    return jcfg, tree, params_from_reference(cfg, tree, "cpu")


def _smoke(ref, arch, seed=0):
    jcfg = ref.configs.get_config(arch, smoke=True)
    cfg = tconfigs.get_config(arch, smoke=True)
    tree = numpy_params(cfg, seed)
    return jcfg, cfg, tree, params_from_reference(cfg, tree, "cpu")


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("smoke", (False, True))
@pytest.mark.parametrize("arch", NEW)
def test_config_equals_reference_field_for_field(ref, arch, smoke):
    want = ref.configs.get_config(arch, smoke=smoke)
    got = tconfigs.get_config(arch, smoke=smoke)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "dtype":
            assert g == dtypes[np.dtype(w).name]
        elif f.name == "block_pattern":
            assert [tuple(s) for s in g] == [tuple(s) for s in w]
        else:
            assert g == w, f.name
    assert got.full_attention_only == want.full_attention_only


# --------------------------------------------------------------------- mask
def test_make_mask_equals_reference(ref):
    import jax.numpy as jnp
    q = np.arange(5, 12)
    ks = {"fresh": np.arange(0, 12),
          "ring": np.array([8, 9, 10, 11, -1, 4, 5, -1, 7]),
          "empty": np.full(6, -1)}
    n = 0
    for k in ks.values():
        for causal in (True, False):
            for window in (None, 1, 3, 8):
                for prefix in (None, 0, 4, 9):
                    kw = dict(causal=causal, window=window, prefix_len=prefix)
                    got = tattn.make_mask(_t(q), _t(k), **kw)
                    want = ref.attention.make_mask(jnp.asarray(q),
                                                   jnp.asarray(k), **kw)
                    assert np.array_equal(got.numpy(), np.asarray(want)), kw
                    n += 1
    assert n == 3 * 2 * 4 * 4


def test_softcapped_sdpa_equals_reference(ref):
    """The softcap on the scaled logits before the mask, with and without
    a mask."""
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 5, 2, 2, 16)).astype(np.float32) * 8
    k, v = (rng.standard_normal((2, 9, 2, 16)).astype(np.float32) * 8
            for _ in range(2))
    mask = rng.random((5, 9)) < 0.7
    mask[:, 0] = True
    for m in (mask, None):
        for cap in (None, 5.0):
            got = tattn._sdpa(_t(q), _t(k), _t(v),
                              mask=None if m is None else _t(m), cap=cap)
            want = ref.attention._sdpa(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                mask=None if m is None else jnp.asarray(m), cap=cap)
            assert _rel(got, want) < LOSS_RTOL, (m is None, cap)


# ------------------------------------------------------------ serving path
@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_past_the_window_match_reference(ref, arch):
    """Prefill, then decode past the smoke window (each ring wraps), every
    step's logits and every cache field against the reference's; the
    enc-dec decodes given the encoder output."""
    import jax.numpy as jnp
    jcfg, cfg, tree, model = _smoke(ref, arch)
    jparams = _j(tree)
    b, s, steps = 2, 12, 10
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (b, s + steps))
    stubs = _stubs(cfg, b, s, rng)
    pre = tserve.prefix_len(cfg)
    max_len = pre + s + steps
    jl, jc = ref.transformer.prefill(
        jcfg, jparams, {"tokens": jnp.asarray(toks[:, :s]), **_j(stubs)},
        max_len)
    enc = dict(enc_out=None, enc_pos=None)
    jenc = dict(enc)
    with torch.inference_mode():
        batch = {"tokens": _t(toks[:, :s]),
                 **{k: _t(v) for k, v in stubs.items()}}
        tl, tc = tt.prefill(model, batch, max_len)
        if cfg.is_enc_dec:
            enc = dict(zip(("enc_out", "enc_pos"),
                           model.encode(batch["enc_embeds"])))
            jenc = dict(zip(("enc_out", "enc_pos"), ref.transformer._encode(
                jcfg, jparams, jnp.asarray(stubs["enc_embeds"]))))
            assert _rel(enc["enc_out"], jenc["enc_out"]) < MODEL_RTOL
    assert _rel(tl, jl) < MODEL_RTOL
    n_pat = len(cfg.block_pattern)
    if cfg.window:
        assert min(c.k.shape[1] for c in tc) == cfg.window < s + pre

    def same_caches():
        for i, c in enumerate(tc):
            for f in c._fields:
                assert _err(getattr(c, f),
                            getattr(jc[i % n_pat], f)[i // n_pat]) \
                    < CACHE_TOL, (i, f)
    same_caches()
    for t in range(s, s + steps):
        pos = pre + t
        jl, jc = ref.transformer.decode_step(
            jcfg, jparams, jnp.asarray(toks[:, t:t + 1]), jc,
            pos0=jnp.asarray(pos, jnp.int32), **jenc)
        with torch.inference_mode():
            tl, tc = tt.decode_step(model, _t(toks[:, t:t + 1]), tc,
                                    pos0=pos, **enc)
        assert _rel(tl, jl) < MODEL_RTOL, t
    same_caches()


def _train_batch(cfg, seed=4, b=2, s=20):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": toks.astype(np.int32),
            "labels": labels.astype(np.int32), **_stubs(cfg, b, s, rng)}


@pytest.mark.parametrize("arch", NEW)
def test_forward_loss_and_every_gradient_match_reference(ref, arch):
    import jax
    jcfg, cfg, tree, model = _smoke(ref, arch, seed=1)
    batch = _train_batch(cfg)
    jlog, _ = ref.transformer.forward(jcfg, _j(tree), _j(batch))
    tbatch = {k: _t(v) for k, v in batch.items()}
    with torch.inference_mode():
        tlog, aux = tt.forward(model, tbatch)
    assert tlog.shape == (2, 20, cfg.vocab) and float(aux) == 0.0
    assert _rel(tlog, jlog) < MODEL_RTOL

    loss, grads = jax.value_and_grad(
        lambda p: ref.transformer.loss_fn(jcfg, p, _j(batch)))(_j(tree))
    tt.set_trainable(model)
    got = tt.loss_fn(model, tbatch)
    params = dict(model.named_parameters())
    g = torch.autograd.grad(got, list(params.values()))
    assert abs(got.item() - float(loss)) <= LOSS_RTOL * abs(float(loss))
    port = jax.tree.map(lambda t: t.numpy(),
                        stack_layers(cfg, dict(zip(params, g))))
    want = jax.tree_util.tree_flatten_with_path(grads)[0]
    have = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    assert len(have) == len(want)
    errs = {jax.tree_util.keystr(p): _rel(have[p], w) for p, w in want}
    assert max(errs.values()) < GRAD_RTOL, errs


# --------------------------------------------- twins of tests/test_models.py
B, S, V = 2, 32, 128
TWINS = {
    "local_global_softcap": dict(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=V,
        window=8, attn_softcap=50.0, final_softcap=30.0,
        block_pattern=(tt.LayerSpec("swa"), tt.LayerSpec("attn"))),
    "five_to_one_qknorm": dict(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=V,
        window=8, qk_norm=True,
        block_pattern=tuple([tt.LayerSpec("swa")] * 5
                            + [tt.LayerSpec("attn")])),
    "enc_dec": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                    d_ff=128, vocab=V, n_enc_layers=2, frontend="audio"),
    "vision_prefix": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                          d_ff=128, vocab=V, frontend="vision",
                          frontend_seq=8),
}


@pytest.mark.parametrize("name", TWINS)
def test_model_family_twin(ref, name):
    """``tests/test_models.py``'s check: finite logits of the right shape,
    a finite loss, decode of the last token after a prefill of the rest
    equal to the forward's last position (2e-2 relative, its bound; the
    enc-dec given its encoder output, which the reference's own test
    skips), and here the forward and loss against the reference."""
    import jax.numpy as jnp
    cfg = tt.ModelConfig(name, remat=False, dtype=torch.float32,
                         **TWINS[name])
    jcfg, tree, model = _pair(ref, cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, V, (B, S))
    stubs = {}
    if cfg.is_enc_dec:
        stubs["enc_embeds"] = rng.standard_normal(
            (B, 16, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        stubs["prefix_embeds"] = rng.standard_normal(
            (B, 8, cfg.d_model)).astype(np.float32)
    batch = {"tokens": toks, "labels": toks, **stubs}
    tbatch = {k: _t(v) for k, v in batch.items()}
    with torch.inference_mode():
        logits, _ = tt.forward(model, tbatch)
        assert logits.shape == (B, S, V)
        assert not bool(torch.isnan(logits).any())
        loss = tt.loss_fn(model, tbatch)
    jlog, _ = ref.transformer.forward(jcfg, _j(tree), _j(batch))
    assert _rel(logits, jlog) < MODEL_RTOL
    want = float(ref.transformer.loss_fn(jcfg, _j(tree), _j(batch)))
    assert np.isfinite(loss.item())
    assert abs(loss.item() - want) <= LOSS_RTOL * abs(want)

    pre = dict(tbatch, tokens=tbatch["tokens"][:, :S - 1])
    p = tserve.prefix_len(cfg)
    with torch.inference_mode():
        _, caches = tt.prefill(model, pre, max_len=p + S + 4)
        enc = {}
        if cfg.is_enc_dec:
            enc = dict(zip(("enc_out", "enc_pos"),
                           model.encode(tbatch["enc_embeds"])))
        dec, _ = tt.decode_step(model, tbatch["tokens"][:, S - 1:], caches,
                                pos0=p + S - 1, **enc)
    last = logits[:, S - 1]
    rel = float((dec - last).abs().max()) / (float(last.abs().max()) + 1e-6)
    assert rel < 2e-2, rel


# ------------------------------------------------------------ kernel route
# prefill launches per smoke model: gemma2 (softcap) and paligemma
# (prefix) none; gemma3 one per layer; seamless its encoder's and its
# decoder's self-attention layers, never cross-attention
PREFILL_CALLS = {"gemma2-2b": 0, "gemma3-12b": 6, "paligemma-3b": 0,
                 "seamless-m4t-large-v2": 4, "deepseek-67b": 3}


@pytest.mark.parametrize("arch", NEW)
def test_kernel_route_is_fixed_by_the_layer_contract(monkeypatch, arch):
    """Prefill calls ``flash_attention`` once per layer whose contract it
    is; decode, cross-attention and calls that record gradients never."""
    calls = []
    real = tattn.flash_attention

    def spy(q, k, v, **kw):
        calls.append(kw)
        return real(q, k, v, **kw)
    monkeypatch.setattr(tattn, "flash_attention", spy)
    cfg = tconfigs.get_config(arch, smoke=True)
    model = params_from_reference(cfg, numpy_params(cfg, 0), "cpu")
    batch = tserve.random_batch(cfg, 2, 16, 0, "cpu")
    with torch.inference_mode():
        _, caches = tt.prefill(model, batch, 40)
        assert len(calls) == PREFILL_CALLS[arch]
        windows = [kw["window"] for kw in calls if kw["window"] is not None]
        n_swa = sum(s.kind == "swa" for s in cfg.block_pattern) * cfg.reps
        assert windows == ([cfg.window] * n_swa if calls else [])
        assert sum(not kw["causal"] for kw in calls) == (
            cfg.n_enc_layers if calls else 0)
        tt.decode_step(model, batch["tokens"][:, :1], caches, pos0=40 - 2)
        tt.forward(model, batch)
    assert len(calls) == 2 * PREFILL_CALLS[arch]
    tt.set_trainable(model)
    tt.loss_fn(model, dict(batch, labels=batch["tokens"])).backward()
    assert len(calls) == 2 * PREFILL_CALLS[arch]


# ------------------------------------------------------------------- datum
def test_serve_ref_families_datum_has_the_shape_chip_smoke_reads():
    """What ``chip_smoke.py`` phase 13a reads: every config's prompt is
    the one ``random_batch`` draws from its seed, longer than its window
    (so the window mask and the ring's wrap are checked), and where the
    path calls the kernel, zeroing it moves the logits past ``rtol``."""
    d = json.loads(FAMILIES_REF.read_text())
    assert {"what", "script", "command", "rtol", "configs", "jax_version",
            "torch_version"} <= set(d)
    assert "numpy_params" in d["script"] and d["rtol"] == 1e-3
    assert set(d["configs"]) == {"gemma2-2b", "gemma3-12b", "paligemma-3b",
                                 "seamless-m4t-large-v2"}
    for arch, c in d["configs"].items():
        cfg = tconfigs.get_config(arch)
        b, s = c["batch"], c["prompt_len"]
        prompt = np.asarray(c["prompt"])
        assert prompt.shape == (b, s) and prompt.max() < cfg.vocab
        assert np.array_equal(
            prompt, tserve.random_batch(cfg, b, s, 0, "cpu")["tokens"].numpy())
        assert c["seed"] == 0 and 1 <= c["layers"] <= cfg.n_layers
        assert c["layers"] % len(cfg.block_pattern) == 0
        assert c["port_cpu_max_rel_err"] < d["rtol"] / 100
        assert c["prefix_len"] == tserve.prefix_len(cfg)
        if cfg.window:
            assert c["window"] == cfg.window < s + c["prefix_len"], arch
        assert c["decode_given_enc_out"] == cfg.is_enc_dec
        if cfg.is_enc_dec:
            assert c["enc_frames"] == s // 4 > 0
        assert c["port_cpu_prefill_kernel_calls"] == {
            "gemma2-2b": 0, "gemma3-12b": 6, "paligemma-3b": 0,
            "seamless-m4t-large-v2": 24}[arch]
        if c["port_cpu_prefill_kernel_calls"]:
            assert c["port_cpu_prefill_rel_change_kernel_zeroed"][
                "flash_attention"] > d["rtol"]
        assert len(c["steps"]) == c["decode_steps"] + 1
        for step in c["steps"]:
            ids, logits = np.asarray(step["ids"]), np.asarray(step["logits"])
            assert ids.shape == logits.shape == (b, 16)
            assert np.all(np.isfinite(logits))
            assert step["greedy"] == ids[:, 0].tolist()
            assert np.all(np.diff(logits, axis=1) <= 0)


@pytest.mark.parametrize("what", ("window - 1", "swa RoPE base = global"))
def test_chip_smoke_planted_faults_move_the_logits_and_come_out(what):
    """``chip_smoke.py`` phase 13a's planted faults, on gemma3-12b at smoke
    size (its full config's global RoPE base) with a prompt past the
    window: each moves the prefill and the decode logits by more than the
    card's limit, and taking it out gives the sound logits back exactly."""
    from chip_smoke import FAMILY_DATUM_RTOL, datum_plants, planted
    cfg = dataclasses.replace(
        tconfigs.get_config("gemma3-12b", smoke=True),
        rope_theta=tconfigs.get_config("gemma3-12b").rope_theta)
    assert what in datum_plants(cfg)
    model = params_from_reference(cfg, numpy_params(cfg, 0), "cpu")
    s = cfg.window + 8
    batch = tserve.random_batch(cfg, 2, s, 0, "cpu")

    def run():
        with torch.inference_mode():
            logits, caches = tt.prefill(model, batch, s + 2)
            step, _ = tt.decode_step(model, logits.argmax(-1)[:, None],
                                     caches, pos0=s)
        return logits, step
    sound = run()
    undo = planted(model, what)
    try:
        fault = run()
    finally:
        undo()
    for a, b, c in zip(sound, fault, run()):
        assert torch.equal(a, c)
        assert _rel(b.numpy(), a.numpy()) > FAMILY_DATUM_RTOL


# ------------------------------------------------------------- training
@pytest.mark.parametrize("arch", ("gemma2-2b", "paligemma-3b",
                                  "seamless-m4t-large-v2"))
def test_train_step_matches_reference(ref, arch):
    """Two AdamW steps through ``launch.steps.make_train_step`` on
    ``SyntheticLMDataset`` batches (with the stub inputs it draws for the
    config's frontend): loss, grad norm and lr within ``LOSS_RTOL`` of
    the reference's, and every parameter within 2e-5 of its leaf's
    largest |value| after the steps."""
    import jax
    import jax.numpy as jnp
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.convert import reference_tree
    from repro_torch.optim import AdamWConfig, adamw_init
    jcfg, cfg, tree, model = _smoke(ref, arch)
    data = SyntheticLMDataset(cfg.vocab, 16, 2, d_model=cfg.d_model,
                              frontend=cfg.frontend,
                              frontend_seq=cfg.frontend_seq)
    batches = [data.next_batch() for _ in range(2)]
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=20)
    ropt = ref.optim.AdamWConfig(lr=1e-3, total_steps=20)
    params = _j(tree)
    jopt = ref.optim.adamw_init(ropt, params)
    jstep = jax.jit(ref.steps.make_train_step(jcfg, ropt))
    opt = adamw_init(opt_cfg, dict(model.named_parameters()))
    step = tsteps.make_train_step(model, opt_cfg)
    for b in batches:
        params, jopt, jm = jstep(params, jopt,
                                 {k: jnp.asarray(v) for k, v in b.items()})
        opt, m = step(opt, b)
        for k in ("loss", "grad_norm", "lr"):
            w = float(jm[k])
            assert abs(float(m[k]) - w) <= LOSS_RTOL * abs(w), k
    got = jax.tree.map(lambda t: t.detach().numpy(), reference_tree(model))
    have = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(params)[0]:
        assert _rel(have[path], w) < CACHE_TOL, jax.tree_util.keystr(path)
