"""The port's MoE on the CPU, against the JAX reference: ``moe_ffn`` itself
(dropping and keeping, one and two routing groups, a capacity that drops
tokens, tied router rows, and its gradients), twins of
``tests/test_models.py``'s ``test_moe`` and ``test_hybrid``, and the
smoke configs of mixtral-8x7b, phi3.5-moe-42b and jamba-1.5-large-398b
(configs field for field; forward, loss with the aux and every gradient
at ``remat`` off and on; prefill and decode against teacher forcing and
the reference's); and the shape of ``testdata/serve_ref_moe.json``.

Both packages get the same numpy inputs and ``numpy_params`` trees (f32).
Tolerances: ``MOE_RTOL`` (1e-5) relative on ``moe_ffn``'s outputs and
aux; ``MODEL_RTOL`` (1e-4) of the largest |logit|, 1e-5 relative on
losses and auxes, ``GRAD_RTOL`` (1e-4) of each leaf's largest |gradient|.
Routing is discrete: where an input sits on a routing tie, both packages
must choose the same expert, and the tied cases pin that.
"""
from __future__ import annotations

import dataclasses
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_ref import reference
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.models.convert import (numpy_params, params_from_reference,
                                        stack_layers)

MOE_RTOL = 1e-5
MODEL_RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
MOE = ("mixtral-8x7b", "phi3.5-moe-42b", "jamba-1.5-large-398b")
ROOT = Path(__file__).resolve().parents[1]
MOE_REF = ROOT / "src" / "repro_torch" / "testdata" / "serve_ref_moe.json"


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


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


# ----------------------------------------------------------------- moe_ffn
D, F, E = 16, 24, 4


def _moe_tree(rng, tie=False):
    """An init_moe-shaped tree (f32).  ``tie``: the router's expert columns
    equal in pairs (0 = 1, 2 = 3), so every token's probabilities tie."""
    w = rng.standard_normal((D, E)).astype(np.float32) / 4.0
    if tie:
        w[:, 1], w[:, 3] = w[:, 0], w[:, 2]
    return {"router": {"w": w},
            "gate": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
            "up": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
            "down": rng.standard_normal((E, F, D)).astype(np.float32) / 5}


def _t_tree(tree):
    return {k: ({"w": _t(v["w"])} if k == "router" else _t(v))
            for k, v in tree.items()}


# name -> (drop, groups, capacity_factor, tied router)
MOE_CASES = {
    "keep": (False, 1, 1.25, False),
    "drop": (True, 1, 1.25, False),
    "keep_groups2": (False, 2, 1.25, False),
    "drop_groups2": (True, 2, 1.25, False),
    "drop_past_capacity": (True, 1, 0.5, False),
    "drop_past_capacity_groups2": (True, 2, 0.5, False),
    "tied_router_rows": (True, 1, 0.75, True),
}


def _dropped(x, tree, top_k, cf, drop):
    """Assignments past their expert's capacity, by the reference's rule
    (numpy, one group)."""
    xt = x.reshape(-1, D)
    n = xt.shape[0]
    cap = n if not drop else max(int(cf * top_k * n / E), 1)
    logits = xt @ tree["router"]["w"]
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    experts, rem = [], probs.copy()
    for _ in range(top_k):
        idx = rem.argmax(1)
        experts.append(idx)
        rem[np.arange(n), idx] = 0.0
    counts = np.bincount(np.concatenate(experts), minlength=E)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_ffn_matches_reference(ref, case):
    """Output, aux and the gradients of ``sum(y * w) + aux`` with respect to
    x and every leaf against ``repro.models.moe.moe_ffn`` on the same
    numpy inputs.  With a small capacity the same assignments must be
    dropped, in the reference's (round, token) order, or the outputs
    differ by whole expert outputs."""
    import jax
    import jax.numpy as jnp
    drop, groups, cf, tie = MOE_CASES[case]
    rng = np.random.default_rng(11)
    tree = _moe_tree(rng, tie)
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    w = rng.standard_normal((2, 12, D)).astype(np.float32)
    kw = dict(top_k=2, capacity_factor=cf, drop=drop, groups=groups)
    if case.startswith("drop_past_capacity") or tie:
        assert _dropped(x, tree, 2, cf, drop) > 0

    def jloss(p, xj):
        y, aux = ref.moe.moe_ffn(p, xj, **kw)
        return jnp.sum(y * jnp.asarray(w)) + aux, (y, aux)
    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(_j(tree), jnp.asarray(x))

    tp = _t_tree(tree)
    leaves = [tp["router"]["w"], tp["gate"], tp["up"], tp["down"]]
    xt = _t(x).requires_grad_(True)
    for leaf in leaves:
        leaf.requires_grad_(True)
    y, aux = tmoe.moe_ffn(tp, xt, **kw)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert _rel(y.detach(), jy) < MOE_RTOL
    assert abs(aux.item() - float(jaux)) <= MOE_RTOL * abs(float(jaux))
    g = torch.autograd.grad(torch.sum(y * _t(w)) + aux, [xt] + leaves)
    want = [jgx, jgp["router"]["w"], jgp["gate"], jgp["up"], jgp["down"]]
    for name, got, wnt in zip(("x", "router", "gate", "up", "down"), g,
                              want):
        assert _rel(got, wnt) < MOE_RTOL, name


def test_argmax_takes_the_first_of_tied_maxima(ref):
    """``torch.argmax`` and ``jnp.argmax`` both take the first maximal
    index, which is what keeps tied routing the reference's."""
    import jax.numpy as jnp
    rows = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                     [0.3, 0.2, 0.2, 0.3], [0.0, 0.5, 0.0, 0.5]],
                    np.float32)
    got = torch.argmax(_t(rows), dim=-1).tolist()
    assert got == np.asarray(jnp.argmax(jnp.asarray(rows), axis=-1)).tolist()
    assert got == [0, 1, 0, 1]


def test_capacity_is_the_reference_float_rule():
    """``cap = max(int(capacity_factor * top_k * n / e), 1)`` in Python
    floats: a capacity factor of 0.1 over 8 tokens and 4 experts keeps
    one assignment an expert; ``drop=False`` keeps all."""
    rng = np.random.default_rng(2)
    tp = _t_tree(_moe_tree(rng))
    x = _t(rng.standard_normal((1, 8, D)).astype(np.float32))
    y_keep, _ = tmoe.moe_ffn(tp, x, capacity_factor=0.1, drop=False)
    y_drop, _ = tmoe.moe_ffn(tp, x, capacity_factor=0.1, drop=True)
    zero_rows = int((y_drop.abs().sum(-1) == 0).sum())
    assert zero_rows >= 8 - 4 and not bool(
        (y_keep.abs().sum(-1) == 0).any())


def test_moe_groups_context_routes_in_groups(ref):
    """``transformer.moe_groups`` (the reference's ``_MOE_GROUPS`` stack)
    reaches every MoE layer of a forward, as the reference's does; the
    groups are read when the forward runs."""
    import jax.numpy as jnp
    cfg = tt.ModelConfig("moe-groups", n_layers=2, d_model=32, n_heads=2,
                         n_kv_heads=2, d_ff=48, vocab=64, n_experts=4,
                         capacity_factor=0.5,
                         block_pattern=(tt.LayerSpec("attn", moe=True),),
                         remat=False, dtype=torch.float32)
    jcfg = _jcfg(ref, cfg)
    tree = numpy_params(cfg, 3)
    model = params_from_reference(cfg, tree, "cpu")
    toks = np.random.default_rng(1).integers(0, 64, (2, 16))
    auxes = {}
    for g in (1, 4):
        with ref.transformer.moe_groups(g):
            jl, jaux = ref.transformer.forward(
                jcfg, _j(tree), {"tokens": jnp.asarray(toks)})
        with tt.moe_groups(g), torch.inference_mode():
            tl, aux = tt.forward(model, {"tokens": _t(toks)})
        assert tt._MOE_GROUPS == [1]
        assert _rel(tl, jl) < MODEL_RTOL
        assert abs(aux.item() - float(jaux)) <= LOSS_RTOL * float(jaux)
        auxes[g] = aux.item()
    assert auxes[1] != auxes[4]


# ------------------------------------------------------------ whole models
def _jcfg(ref, cfg):
    return ref.transformer.ModelConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name not in ("block_pattern", "dtype")},
        block_pattern=tuple(ref.transformer.LayerSpec(*s)
                            for s in cfg.block_pattern),
        dtype=ref.configs.get_config("smollm-135m", smoke=True).dtype)


B, S, V = 2, 32, 128
# tests/test_models.py's test_moe and test_hybrid, and the new smoke ids
TWINS = {
    "moe": dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=V, window=8, n_experts=4, capacity_factor=8.0,
                block_pattern=(tt.LayerSpec("swa", moe=True),)),
    "hybrid": dict(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab=V, n_experts=4, capacity_factor=8.0,
                   ssm_state=16, ssm_head_dim=16,
                   block_pattern=(tt.LayerSpec("ssm"),
                                  tt.LayerSpec("ssm", moe=True),
                                  tt.LayerSpec("attn"),
                                  tt.LayerSpec("ssm", moe=True))),
}
MODELS = tuple(TWINS) + MOE


def _config(name, remat=False):
    if name in TWINS:
        cfg = tt.ModelConfig(name, dtype=torch.float32, **TWINS[name])
    else:
        cfg = tconfigs.get_config(name, smoke=True)
    return dataclasses.replace(cfg, remat=remat)


@pytest.mark.parametrize("smoke", (False, True))
@pytest.mark.parametrize("arch", MOE)
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
    assert tconfigs.PORTED == tuple(dict.fromkeys(tconfigs.PORTED))
    assert set(tconfigs.PORTED) == set(tconfigs.ARCHS)


_JAX_LOSS = {}


def _jax_loss(ref, name, tree, batch):
    """The reference's forward (logits, aux), loss and gradients of model
    ``name`` without remat (``jax.checkpoint`` changes none of them; the
    reference's ``test_remat_matches_no_remat``), once per model."""
    import jax
    if name not in _JAX_LOSS:
        jcfg = _jcfg(ref, _config(name))
        jb = _j(batch)
        fwd = jax.jit(lambda p: ref.transformer.forward(jcfg, p, jb))
        vg = jax.jit(jax.value_and_grad(
            lambda p: ref.transformer.loss_fn(jcfg, p, jb)))
        _JAX_LOSS[name] = (*fwd(_j(tree)), *vg(_j(tree)))
    return _JAX_LOSS[name]


@pytest.mark.parametrize("remat", (False, True))
@pytest.mark.parametrize("name", MODELS)
def test_forward_loss_and_every_gradient_match_reference(ref, name, remat):
    """Forward logits and aux, ``loss_fn`` (cross-entropy + 0.01 * aux)
    and the gradient of every leaf against ``jax.value_and_grad`` of the
    reference's ``loss_fn``, the training forward dropping past capacity.
    With ``remat`` the layers are recomputed in the backward, and the aux
    must still reach the loss: the loss without it misses by 0.01 * aux."""
    import jax
    cfg = _config(name, remat)
    tree = numpy_params(cfg, 1)
    model = params_from_reference(cfg, tree, "cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 20))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": toks.astype(np.int32),
             "labels": labels.astype(np.int32)}
    tbatch = {k: _t(v) for k, v in batch.items()}
    jlog, jaux, loss, grads = _jax_loss(ref, name, tree, batch)
    with torch.inference_mode():
        tlog, aux = tt.forward(model, tbatch)
    assert _rel(tlog, jlog) < MODEL_RTOL
    assert float(jaux) > 0
    assert abs(aux.item() - float(jaux)) <= LOSS_RTOL * float(jaux)

    tt.set_trainable(model)
    got = tt.loss_fn(model, tbatch)
    assert abs(got.item() - float(loss)) <= LOSS_RTOL * abs(float(loss))
    with torch.no_grad():
        logits, _ = tt.forward(model, tbatch)
    valid = tbatch["labels"] >= 0
    nll = (torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, tbatch["labels"].clamp(min=0).long()[..., None])[..., 0])
    ce = float((nll * valid).sum() / valid.sum())
    assert abs(got.item() - ce - 0.01 * float(jaux)) < 0.1 * 0.01 * float(
        jaux)
    params = dict(model.named_parameters())
    g = torch.autograd.grad(got, list(params.values()))
    port = jax.tree.map(lambda t: t.numpy(),
                        stack_layers(cfg, dict(zip(params, g))))
    want = jax.tree_util.tree_flatten_with_path(grads)[0]
    have = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    assert len(have) == len(want)
    errs = {jax.tree_util.keystr(p): _rel(have[p], w) for p, w in want}
    assert max(errs.values()) < GRAD_RTOL, errs


@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_match_teacher_forcing_and_reference(ref, name):
    """``tests/test_models.py``'s contract (decode of the last token after
    a prefill of the rest equals teacher forcing, 2e-2 relative; here the
    last position of a prefill of all the tokens, which keeps every token
    as serving does, where the reference's test takes the training
    forward at a capacity that drops none), and prefill then decode past
    the smoke window, every
    step's logits against the reference's ``prefill`` / ``decode_step``
    on the same tree and tokens."""
    import jax.numpy as jnp
    cfg = _config(name)
    jcfg = _jcfg(ref, cfg)
    tree = numpy_params(cfg, 0)
    model = params_from_reference(cfg, tree, "cpu")
    jparams = _j(tree)
    rng = np.random.default_rng(3)
    s, steps = 12, 10
    toks = rng.integers(0, cfg.vocab, (B, s + steps))
    with torch.inference_mode():
        _, caches = tt.prefill(model, {"tokens": _t(toks[:, :s - 1])},
                               s + 4)
        dec, _ = tt.decode_step(model, _t(toks[:, s - 1:s]), caches,
                                pos0=s - 1)
        last, _ = tt.prefill(model, {"tokens": _t(toks[:, :s])}, s + 4)
    rel = float((dec - last).abs().max()) / (float(last.abs().max()) + 1e-6)
    assert rel < 2e-2, rel

    import jax
    max_len = s + steps
    decode = jax.jit(lambda p, tk, c, q: ref.transformer.decode_step(
        jcfg, p, tk, c, pos0=q))
    jl, jc = jax.jit(lambda p, tk: ref.transformer.prefill(
        jcfg, p, {"tokens": tk}, max_len))(jparams, jnp.asarray(toks[:, :s]))
    with torch.inference_mode():
        tl, tc = tt.prefill(model, {"tokens": _t(toks[:, :s])}, max_len)
    assert _rel(tl, jl) < MODEL_RTOL
    for t in range(s, s + steps):
        jl, jc = decode(jparams, jnp.asarray(toks[:, t:t + 1]), jc,
                        jnp.asarray(t, jnp.int32))
        with torch.inference_mode():
            tl, tc = tt.decode_step(model, _t(toks[:, t:t + 1]), tc, pos0=t)
        assert _rel(tl, jl) < MODEL_RTOL, t


# ------------------------------------------------------------------- datum
def test_serve_ref_moe_datum_has_the_shape_chip_smoke_reads():
    """What ``chip_smoke.py`` phase 14a reads: every config's prompt is the
    one ``random_batch`` draws from its seed, mixtral's longer than its
    window, the port on the CPU within a fifth of ``rtol`` (the card's
    limit), and zeroing the attention kernel moves the prefill by ten
    times it."""
    d = json.loads(MOE_REF.read_text())
    assert {"what", "script", "command", "rtol", "configs", "jax_version",
            "torch_version"} <= set(d)
    assert "numpy_params" in d["script"] and d["rtol"] == 1e-5
    assert set(d["configs"]) == {"mixtral-8x7b", "phi3.5-moe-42b"}
    for arch, c in d["configs"].items():
        cfg = tconfigs.get_config(arch)
        b, s = c["batch"], c["prompt_len"]
        prompt = np.asarray(c["prompt"])
        assert prompt.shape == (b, s) and prompt.max() < cfg.vocab
        assert np.array_equal(
            prompt, tserve.random_batch(cfg, b, s, 0, "cpu")["tokens"].numpy())
        assert c["seed"] == 0 and c["layers"] == len(cfg.block_pattern)
        assert c["port_cpu_max_rel_err"] < d["rtol"] / 5
        if cfg.window:
            assert c["window"] == cfg.window < s, arch
        assert c["port_cpu_prefill_kernel_calls"] == 1
        assert c["port_cpu_prefill_rel_change_kernel_zeroed"][
            "flash_attention"] > 10 * d["rtol"]
        assert len(c["steps"]) == c["decode_steps"] + 1
        for step in c["steps"]:
            ids, logits = np.asarray(step["ids"]), np.asarray(step["logits"])
            assert ids.shape == logits.shape == (b, 16)
            assert np.all(np.isfinite(logits))
            assert step["greedy"] == ids[:, 0].tolist()
            assert np.all(np.diff(logits, axis=1) <= 0)


@pytest.mark.parametrize("kernel", ("flash_attention", "ssd_scan"))
def test_chip_smoke_plain_check_holds_each_kernel_call(kernel):
    """``chip_smoke.py`` 14b's check on jamba at smoke size: with the plain
    versions in the kernels' place it passes and reads 0; with one kernel
    3 % off its plain version it fails on that kernel's calls, which the
    logits alone would not show (each reads within its limit there)."""
    from chip_smoke import (SITE_BF16_RTOL, logits_vs_plain,
                            plain_check_failure)
    from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_ref
    from repro_torch.models import attention as tattn
    from repro_torch.models import ssm as tssm
    cfg = tconfigs.get_config("jamba-1.5-large-398b", smoke=True)
    model = params_from_reference(cfg, numpy_params(cfg, 0), "cpu")
    batch = tserve.random_batch(cfg, 2, 64, 0, "cpu")
    kernels = ["flash_attention", "ssd_scan"]
    sound = logits_vs_plain(torch, model, batch, 80, kernels)
    assert plain_check_failure(sound) is None
    assert sound["site"] == sound["rel"] == dict.fromkeys(kernels, 0.0)
    assert sound["site_calls"] == {"flash_attention": 1, "ssd_scan": 7}

    def off_attn(*a, **kw):
        return flash_attention_ref(*a, **kw) * 1.03

    def off_ssd(*a, **kw):
        y, state = ssd_scan_ref(*a, **kw)
        return y * 1.03, state
    mod, fn = ((tattn, off_attn) if kernel == "flash_attention"
               else (tssm, off_ssd))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, kernel, fn)
        off = logits_vs_plain(torch, model, batch, 80, kernels)
    assert off["site"][kernel] > 0.02 > SITE_BF16_RTOL
    assert off["rel"][kernel] <= off["zeroed_rel"][kernel] / 10
    assert kernel in plain_check_failure(off)


# ------------------------------------------- bf16 gradients (_BmmF32)
def _emulated_bmm(real):
    """``torch.bmm`` with ``out_dtype`` for the CPU, whose build lacks
    ``aten::bmm.dtype``: the operands upcast, an f32 product."""
    def bmm(a, b, *, out_dtype=None):
        if out_dtype is None:
            return real(a, b)
        return real(a.to(out_dtype), b.to(out_dtype))
    return bmm


def test_bf16_moe_model_backward_on_the_meta_device():
    """bf16 training through MoE layers: ``mixtral-8x7b`` at full width,
    two layers, forward and backward on the meta device (shapes only).
    Autograd has no formula for ``bmm`` with ``out_dtype``, so without
    ``_BmmF32`` this raises."""
    cfg = dataclasses.replace(tconfigs.get_config("mixtral-8x7b"),
                              n_layers=2)
    model = tt.Transformer(cfg, device="meta")
    tt.set_trainable(model, True)
    ids = torch.zeros((2, 64), dtype=torch.long, device="meta")
    loss = tt.loss_fn(model, {"tokens": ids, "labels": ids})
    loss.backward()
    assert loss.dtype == torch.float32
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        assert p.grad.shape == p.shape, name


def test_bmm_f32_gradients_in_f32_are_autograds():
    """For f32 operands ``_BmmF32`` gives torch.bmm's output and autograd's
    gradients of it, bit for bit."""
    rng = np.random.default_rng(3)
    a0 = _t(rng.standard_normal((3, 5, 7)).astype(np.float32))
    b0 = _t(rng.standard_normal((3, 7, 4)).astype(np.float32))
    g = _t(rng.standard_normal((3, 5, 4)).astype(np.float32))
    a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    a2, b2 = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    y = tmoe._bmm_f32(a, b)
    y2 = torch.bmm(a2, b2)
    assert torch.equal(y, y2)
    y.backward(g)
    y2.backward(g)
    assert torch.equal(a.grad, a2.grad) and torch.equal(b.grad, b2.grad)
    # one operand alone
    b3 = b0.clone().requires_grad_()
    tmoe._bmm_f32(a0, b3).backward(g)
    assert torch.equal(b3.grad, b2.grad)


def test_bmm_f32_backward_in_bf16_is_jax_grad_of_the_einsum(ref):
    """bf16 operands: the gradients are what ``jax.vjp`` makes of the
    reference's ``einsum("ecd,edf->ecf", ..., preferred_element_type=f32)``
    for an f32 cotangent: bf16, within one bf16 rounding of JAX's (the
    f32 products sum in another order)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    a32 = rng.standard_normal((3, 6, 8)).astype(np.float32)
    b32 = rng.standard_normal((3, 8, 5)).astype(np.float32)
    g = rng.standard_normal((3, 6, 5)).astype(np.float32)
    ja, jb = jnp.asarray(a32, jnp.bfloat16), jnp.asarray(b32, jnp.bfloat16)
    y, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "ecd,edf->ecf", a, b, preferred_element_type=jnp.float32), ja, jb)
    want_a, want_b = vjp(jnp.asarray(g))
    a = _t(a32).to(torch.bfloat16).requires_grad_()
    b = _t(b32).to(torch.bfloat16).requires_grad_()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "bmm", _emulated_bmm(torch.bmm))
        got = tmoe._bmm_f32(a, b)
    assert got.dtype == torch.float32
    assert _rel(got.detach(), np.asarray(y)) <= 1e-6
    got.backward(_t(g))
    for t, want in ((a, want_a), (b, want_b)):
        assert want.dtype == jnp.bfloat16 and t.grad.dtype == torch.bfloat16
        assert _rel(t.grad.float(), np.asarray(want, np.float32)) <= 2 ** -7


def test_moe_grad_bf16_datum_on_the_cpu():
    """``chip_smoke.py`` phase 12d's datum check on the CPU, the bf16
    expert products emulated (f32 products of the upcast operands, what
    XLA's CPU backend computes for the reference): the loss and every
    gradient leaf within the datum's limit, in the reference's dtypes;
    and the datum's shape."""
    from chip_smoke import moe_grad_datum
    d = json.loads((ROOT / "src" / "repro_torch" / "testdata"
                    / "moe_grad_bf16_ref.json").read_text())
    assert d["dtypes"] == {"x": "bfloat16", "router": "float32",
                           "gate": "bfloat16", "up": "bfloat16",
                           "down": "bfloat16"}
    assert d["rel_limit"] == 2.0 ** -6 and d["margin"] > 1e-3
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "bmm", _emulated_bmm(torch.bmm))
        got = moe_grad_datum(torch, np, "cpu")
    assert set(got["rel"]) == {"x", "router", "gate", "up", "down"}
    assert max(got["rel"].values()) <= 1e-4
    assert got["loss_rel"] <= 1e-3


# ------------------------------- the wrappers' three arms, and the meta pass
def _wrapper_inputs(kernel, device):
    """Inputs of ``kernel`` (bf16, a shape its tensor-core route takes) on
    ``device``."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=device)
    if kernel == "flash_attention":
        return (t(1, 2, 64, 64), t(1, 1, 64, 64), t(1, 1, 64, 64)), {}
    return ((t(1, 128, 2, 64), t(1, 128, 2, dtype=torch.float32),
             t(2, dtype=torch.float32), t(1, 128, 64), t(1, 128, 64)),
            {"chunk": 128})


@pytest.mark.parametrize("kernel", ("flash_attention", "ssd_scan"))
def test_wrappers_plain_on_cpu_shapes_on_meta_kernel_on_cuda(kernel):
    """No wrapper falls back.  A CPU tensor takes the plain version; a meta
    tensor takes it too, for the output's shapes alone (no data, no
    launch); a CUDA tensor never does: it goes to its route's kernel
    (here, with no card, as fake tensors, it reaches the library build,
    which the test makes raise)."""
    import warnings
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ssd_scan as kss
    mod = kfa if kernel == "flash_attention" else kss
    wrapper = getattr(mod, kernel)
    plain = getattr(mod, f"{kernel}_ref")
    args, kw = _wrapper_inputs(kernel, "cpu")
    want = plain(*args, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = wrapper(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    before = mod.launches
    margs, kw = _wrapper_inputs(kernel, "meta")
    out = wrapper(*margs, **kw)
    out = out if isinstance(out, tuple) else (out,)
    assert [(o.device.type, o.shape, o.dtype) for o in out] \
        == [("meta", w.shape, w.dtype) for w in want]
    assert mod.launches == before

    def no_plain(*a, **k):
        raise AssertionError("the plain version on a CUDA tensor")

    def library(name):
        raise RuntimeError(f"launch {name}")
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")     # fake tensors' data_ptr
        mp.setattr(mod, f"{kernel}_ref", no_plain)
        mp.setattr(_build, "library", library)
        mp.setattr(torch.cuda, "current_stream",
                   lambda *a: types.SimpleNamespace(cuda_stream=0))
        with FakeTensorMode():
            cargs, kw = _wrapper_inputs(kernel, "cuda")
            lib = (kfa.route(torch.bfloat16, 64)[0]
                   if kernel == "flash_attention" else f"{kernel}_tc")
            with pytest.raises(RuntimeError, match=f"launch {lib}"):
                wrapper(*cargs, **kw)
    assert mod.launches == before


@pytest.mark.parametrize("arch", ("jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"))
def test_meta_prefill_and_decode_trace_shapes_only(arch):
    """A model on the meta device prefills and decodes (``init_caches`` on
    ``"meta"``, both kernels' wrappers taking their meta arm): the logits'
    and every cache leaf's shapes are those of the same calls on the CPU,
    and no kernel counts a launch."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ssd_scan as kss
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    cfg = tconfigs.get_config(arch, smoke=True)
    before = (kfa.launches, kss.launches)
    shapes = {}
    for dev in ("cpu", "meta"):
        model = (params_from_reference(cfg, numpy_params(cfg, 0), "cpu")
                 if dev == "cpu" else tt.Transformer(cfg, device="meta"))
        batch = {k: v.to(dev) for k, v in
                 tserve.random_batch(cfg, 2, 16, 0, "cpu").items()}
        with torch.inference_mode():
            logits, caches = make_prefill_step(model, 20)(batch)
            tok = torch.zeros((2, 1), dtype=torch.long, device=dev)
            logits2, caches = make_decode_step(model)(tok, caches, 16)
        assert all(t.device.type == dev for c in caches for t in c)
        shapes[dev] = ([tuple(logits.shape), tuple(logits2.shape)]
                       + [tuple(t.shape) for c in caches for t in c])
    assert shapes["meta"] == shapes["cpu"]
    assert (kfa.launches, kss.launches) == before
    caches = tt.init_caches(cfg, 2, 20, "meta")
    assert len(caches) == cfg.n_layers
    assert all(t.device.type == "meta" for c in caches for t in c)
    with pytest.raises(ValueError):
        tt.init_caches(cfg, 2, 20, "xpu")
