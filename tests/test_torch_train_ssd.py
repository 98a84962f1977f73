"""Training through SSD layers on the CPU, against the JAX reference:
``models.ssm.ssd_chunked`` (values and gradients, ragged lengths, a
carried-in state), the route of each call (training reaches
``ssd_chunked`` and never the ``ssd_scan`` wrapper; prefill the wrapper
and never ``ssd_chunked``), mamba2's loss and every gradient against
``jax.value_and_grad`` with and without remat (jamba's are in
``test_torch_moe.py``), mamba2-1.3b's and jamba-1.5-large-398b's
smoke models through two AdamW steps of ``launch.steps.make_train_step``
against the reference's, ``launch.train`` at ``--smoke`` for both, and
the shape of ``testdata/train_ref_ssd.json``, which ``chip_smoke.py``
reads.

Both packages get the same numpy inputs and ``numpy_params`` trees (f32).
Tolerances: ``SSD_TOL`` (2e-5) of the largest |value| on ``ssd_chunked``'s
outputs and gradients; 1e-5 relative on losses, grad norms and learning
rates; 1e-4 of each leaf's largest |gradient| on gradients; 2e-5 of
each leaf's largest |value| on parameters after the steps.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_ref import reference
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.models.convert import (numpy_params, params_from_reference,
                                        reference_tree)
from repro_torch.optim import AdamWConfig, adamw_init

SSD_TOL = 2e-5
METRIC_RTOL = 1e-5
STATE_TOL = 2e-5
SSD_ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b")
ROOT = Path(__file__).resolve().parents[1]
TRAIN_REF_SSD = (ROOT / "src" / "repro_torch" / "testdata"
                 / "train_ref_ssd.json")


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


# ------------------------------------------------------------- ssd_chunked
# (b, s, h, p, n, chunk, with an initial state)
CHUNKED = {"aligned": (2, 32, 3, 8, 16, 8, False),
           "ragged": (2, 29, 3, 8, 16, 8, False),
           "ragged_init_state": (1, 21, 2, 16, 8, 16, True),
           "one_chunk_short": (2, 5, 2, 8, 8, 8, False)}


@pytest.mark.parametrize("case", CHUNKED)
def test_ssd_chunked_matches_reference_values_and_gradients(ref, case):
    """y, the final state and the gradients of ``sum(y * wy) +
    sum(final * ws)`` with respect to every input against the reference's
    ``ssd_chunked`` under ``jax.value_and_grad``; a length that is not a
    chunk multiple pads with dt = 0 steps, as the reference does."""
    import jax
    import jax.numpy as jnp
    b, s, h, p, n, chunk, init = CHUNKED[case]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (h,)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    wy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    ws = rng.standard_normal((b, h, p, n)).astype(np.float32)
    args = [x, dt, A, B, C] + ([st] if init else [])

    def jf(*a):
        y, fin = ref.ssm.ssd_chunked(
            *a[:5], chunk=chunk, init_state=a[5] if init else None)
        return jnp.sum(y * wy) + jnp.sum(fin * ws), (y, fin)
    (_, (jy, jfin)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=tuple(range(len(args))), has_aux=True))(
            *map(jnp.asarray, args))

    targs = [_t(a).requires_grad_(True) for a in args]
    y, fin = tssm.ssd_chunked(*targs[:5], chunk=chunk,
                              init_state=targs[5] if init else None)
    assert y.shape == x.shape and fin.shape == (b, h, p, n)
    assert _rel(y.detach(), jy) < SSD_TOL
    assert _rel(fin.detach(), jfin) < SSD_TOL
    g = torch.autograd.grad(torch.sum(y * _t(wy)) + torch.sum(fin * _t(ws)),
                            targs)
    for name, got, want in zip(("x", "dt", "A", "B", "C", "init_state"), g,
                               jg):
        assert _rel(got, want) < SSD_TOL, name


@pytest.mark.parametrize("arch", SSD_ARCHS)
def test_route_training_takes_ssd_chunked_and_prefill_the_wrapper(
        monkeypatch, arch):
    """A forward that records gradients runs ``ssd_chunked`` on every SSD
    layer and never the ``ssd_scan`` wrapper (which would refuse its
    inputs); prefill and the no-grad forward run the wrapper on every SSD
    layer and never ``ssd_chunked``; decode runs neither."""
    calls = {"chunked": 0, "wrapper": 0}
    chunked, wrapper = tssm.ssd_chunked, tssm.ssd_scan

    def spy(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(tssm, "ssd_chunked", spy("chunked", chunked))
    monkeypatch.setattr(tssm, "ssd_scan", spy("wrapper", wrapper))
    cfg = get_config(arch, smoke=True)
    n_ssm = sum(s.kind == "ssm" for s in cfg.block_pattern) * cfg.reps
    model = params_from_reference(cfg, numpy_params(cfg, 0), "cpu")
    batch = tserve.random_batch(cfg, 2, 128, 0, "cpu")
    with torch.inference_mode():
        _, caches = tt.prefill(model, batch, 132)
        assert calls == {"chunked": 0, "wrapper": n_ssm}
        tt.decode_step(model, batch["tokens"][:, :1], caches, pos0=128)
        tt.forward(model, batch)
    assert calls == {"chunked": 0, "wrapper": 2 * n_ssm}
    tt.set_trainable(model)
    tt.loss_fn(model, dict(batch, labels=batch["tokens"])).backward()
    assert calls == {"chunked": n_ssm, "wrapper": 2 * n_ssm}
    assert all(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize("remat", (False, True))
def test_mamba2_loss_and_every_gradient_match_reference(ref, remat):
    """mamba2's smoke model: ``loss_fn`` and the gradient of every leaf
    through ``ssd_chunked`` against ``jax.value_and_grad`` of the
    reference's ``loss_fn``, with the layers recomputed in the backward
    (``remat``) or not; a sequence that is not a chunk multiple."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro_torch.models.convert import stack_layers
    cfg = dataclasses.replace(get_config("mamba2-1.3b", smoke=True),
                              remat=remat)
    jcfg = ref.configs.get_config("mamba2-1.3b", smoke=True)
    tree = numpy_params(cfg, 1)
    model = params_from_reference(cfg, tree, "cpu")
    batch = SyntheticLMDataset(cfg.vocab, 20, 2, seed=3).next_batch()
    loss, grads = jax.value_and_grad(lambda p: ref.transformer.loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}))(
            jax.tree.map(jnp.asarray, tree))
    tt.set_trainable(model)
    got = tt.loss_fn(model, {k: _t(v) for k, v in batch.items()})
    assert abs(got.item() - float(loss)) <= METRIC_RTOL * abs(float(loss))
    params = dict(model.named_parameters())
    g = torch.autograd.grad(got, list(params.values()))
    port = jax.tree.map(lambda t: t.numpy(),
                        stack_layers(cfg, dict(zip(params, g))))
    have = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    want = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(have) == len(want)
    errs = {jax.tree_util.keystr(p): _rel(have[p], w) for p, w in want}
    assert max(errs.values()) < 1e-4, errs


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("arch", SSD_ARCHS)
def test_train_steps_match_reference(ref, arch):
    """Two AdamW steps through ``launch.steps.make_train_step`` on
    ``SyntheticLMDataset`` batches against the reference's: loss (the MoE
    aux included for jamba), grad norm and lr within ``METRIC_RTOL``, and
    every parameter within ``STATE_TOL`` of its leaf's largest |value|
    after the steps."""
    import jax
    import jax.numpy as jnp
    cfg = get_config(arch, smoke=True)
    jcfg = ref.configs.get_config(arch, smoke=True)
    tree = numpy_params(cfg, 0)
    model = params_from_reference(cfg, tree, "cpu")
    data = SyntheticLMDataset(cfg.vocab, 16, 2)
    batches = [data.next_batch() for _ in range(2)]
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=20)
    ropt = ref.optim.AdamWConfig(lr=1e-3, total_steps=20)
    params = jax.tree.map(jnp.asarray, tree)
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
            assert abs(float(m[k]) - w) <= METRIC_RTOL * abs(w), k
    got = jax.tree.map(lambda t: t.detach().numpy(), reference_tree(model))
    have = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(params)[0]:
        assert _rel(have[path], w) < STATE_TOL, jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", SSD_ARCHS)
def test_cli_trains_ssd_models_at_smoke_size(tmp_path, arch):
    """``launch.train`` at ``--smoke`` trains, checkpoints and ends with
    finite losses for both SSD ids."""
    res = ttrain.main(["--arch", arch, "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
                       "--store-delay-ms", "1"])
    assert len(res["metrics"]) == 3 and len(res["persist_s"]) == 2
    assert all(np.isfinite(m["loss"]) for m in res["metrics"])


# ------------------------------------------------------------- the datum
def test_train_ref_ssd_datum_has_the_shape_chip_smoke_reads():
    """What ``chip_smoke.py`` phase 12c reads: mamba2-1.3b at full width,
    cut in depth, three steps of loss, grad norm and lr, the batches'
    tokens, and the port on the CPU within ``rtol``."""
    d = json.loads(TRAIN_REF_SSD.read_text())
    assert {"what", "script", "command", "rtol", "arch", "seed", "batch",
            "seq", "steps", "opt", "metrics", "layers", "tokens"} <= set(d)
    assert "numpy_params" in d["script"] and d["arch"] == "mamba2-1.3b"
    cfg = get_config(d["arch"])
    assert 1 <= d["layers"] < cfg.n_layers and d["rtol"] == 1e-4
    assert d["steps"] == len(d["metrics"]) == 3
    assert set(d["opt"]) == {"lr", "total_steps"}
    for m in d["metrics"]:
        assert set(m) == {"loss", "grad_norm", "lr"}
        assert all(np.isfinite(v) and v > 0 for v in m.values())
    assert 0 <= d["port_cpu_max_rel_err"] < d["rtol"] / 10
    tokens = np.asarray(d["tokens"])
    assert tokens.shape == (d["steps"], d["batch"], d["seq"])
    assert 0 <= tokens.min() and tokens.max() < cfg.vocab
    if np.__version__ == d["numpy_version"]:     # the same zipf stream
        data = SyntheticLMDataset(cfg.vocab, d["seq"], d["batch"],
                                  seed=d["seed"])
        for t in tokens:
            np.testing.assert_array_equal(data.next_batch()["tokens"], t)
