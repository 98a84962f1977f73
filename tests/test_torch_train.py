"""The port's training path on the CPU, against the JAX reference.

Both packages get the same ``numpy_params`` tree (f32, ``smollm-smoke``)
and the same ``SyntheticLMDataset`` batches.  Tolerances: the port
repeats the reference's f32 math in other summation orders, so values
agree to ~1e-6 relative; the bounds are 2e-5 of each leaf's largest
|gradient| on gradients, 1e-5 relative on losses, grad norms and
learning rates, and 2e-5 of each leaf's largest |value| on parameters
and moments after 3 steps.  Checkpoints move between the packages bit
for bit.

Also here: ``remat`` leaves the numbers unchanged; no kernel runs in
training and both kernel wrappers refuse inputs that require grad;
twins of ``tests/test_system.py`` (train, crash,
recover, resume in each scheme; restore by buffer forwarding; the CLI);
and the shape of ``testdata/train_ref.json``, which ``chip_smoke.py``
reads.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_ref import reference
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd_scan as tss
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tt
from repro_torch.models.convert import (numpy_params, opt_state_from_reference,
                                        opt_state_to_reference,
                                        params_from_reference, reference_tree,
                                        stack_layers, unstack_layers)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.persistence import (DurableStore, HostBufferTier,
                                     PCSCheckpointManager, PersistScheme)

ROOT = Path(__file__).resolve().parents[1]
TRAIN_REF = ROOT / "src" / "repro_torch" / "testdata" / "train_ref.json"
GRAD_TOL = 2e-5
METRIC_RTOL = 1e-5
STATE_TOL = 2e-5
SEQ, BATCH, STEPS = 16, 4, 3
CFG = get_config("smollm-135m", smoke=True)
OPT = AdamWConfig(lr=1e-3, total_steps=20)
# (microbatches, compress_ratio)
VARIANTS = [(1, 0.0), (2, 0.0), (1, 0.25)]


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _batches(n, seed=0):
    data = SyntheticLMDataset(CFG.vocab, SEQ, BATCH, seed=seed)
    return [data.next_batch() for _ in range(n)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _leaf_errs(got_tree, want_tree):
    """``{path: max |got - want| / max |want|}`` over two reference-layout
    trees of numpy leaves."""
    import jax
    got = dict(jax.tree_util.tree_flatten_with_path(got_tree)[0])
    out = {}
    for path, want in jax.tree_util.tree_flatten_with_path(want_tree)[0]:
        out[jax.tree_util.keystr(path)] = _rel(got[path], want)
    return out


def _port_model(seed=0, cfg=CFG):
    return params_from_reference(cfg, numpy_params(cfg, seed), "cpu")


@pytest.fixture(scope="module")
def ref_runs(ref):
    """The reference's 3 steps from ``numpy_params(CFG, 0)`` in each
    variant: per-step metrics and the final params and opt state."""
    import jax
    import jax.numpy as jnp
    rcfg = ref.configs.get_config("smollm-135m", smoke=True)
    ropt = ref.optim.AdamWConfig(lr=OPT.lr, total_steps=OPT.total_steps)
    out = {}
    for mb, ratio in VARIANTS:
        params = jax.tree.map(jnp.asarray, numpy_params(CFG, 0))
        opt = ref.optim.adamw_init(ropt, params)
        step = jax.jit(ref.steps.make_train_step(
            rcfg, ropt, compress_ratio=ratio, microbatches=mb))
        metrics = []
        for b in _batches(STEPS):
            params, opt, m = step(params, opt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        out[(mb, ratio)] = dict(metrics=metrics, params=_np_tree(params),
                                opt=_np_tree(opt))
    return out


# ------------------------------------------------------------ loss, grads
def test_loss_and_every_gradient_match_reference(ref):
    import jax
    import jax.numpy as jnp
    rcfg = ref.configs.get_config("smollm-135m", smoke=True)
    tree = numpy_params(CFG, 0)
    b = _batches(1)[0]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bt: ref.transformer.loss_fn(rcfg, p, bt)))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in b.items()})
    model = _port_model()
    tt.set_trainable(model)
    got = tt.loss_fn(model, {k: torch.as_tensor(v) for k, v in b.items()})
    params = dict(model.named_parameters())
    g = torch.autograd.grad(got, list(params.values()))
    assert abs(got.item() - float(loss)) <= METRIC_RTOL * abs(float(loss))
    port = stack_layers(CFG, dict(zip(params, g)))
    port = jax.tree.map(lambda t: t.numpy(), port)
    errs = _leaf_errs(port, _np_tree(grads))
    assert len(errs) == 11 and max(errs.values()) < GRAD_TOL, errs


def test_loss_ignores_minus_one_labels():
    model = _port_model()
    b = {k: torch.as_tensor(v) for k, v in _batches(1)[0].items()}
    with torch.no_grad():
        logits = model(b["tokens"])
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, CFG.vocab), b["labels"].reshape(-1).long(),
            ignore_index=-1)
        assert (b["labels"] == -1).sum() == BATCH
        assert abs(float(tt.loss_fn(model, b)) - float(want)) < 1e-5


def test_remat_leaves_loss_and_gradients_unchanged():
    b = {k: torch.as_tensor(v) for k, v in _batches(1)[0].items()}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(CFG, remat=remat)
        model = _port_model(cfg=cfg)
        tt.set_trainable(model)
        loss = tt.loss_fn(model, b)
        out.append((loss, torch.autograd.grad(loss, list(
            model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, c) for a, c in zip(out[0][1], out[1][1]))


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("mb,ratio", VARIANTS)
def test_train_steps_match_reference(ref_runs, mb, ratio):
    want = ref_runs[(mb, ratio)]
    model = _port_model()
    opt = adamw_init(OPT, dict(model.named_parameters()))
    step = tsteps.make_train_step(model, OPT, compress_ratio=ratio,
                                  microbatches=mb)
    for i, b in enumerate(_batches(STEPS)):
        opt, m = step(opt, b)
        for k in ("loss", "grad_norm", "lr"):
            w = want["metrics"][i][k]
            assert abs(float(m[k]) - w) <= METRIC_RTOL * abs(w), (i, k)
    # the reference drops the error-feedback buffer (F13); so does the port
    assert set(opt) == set(want["opt"]) == {"m", "v", "step"}
    errs = _leaf_errs(reference_tree_np(model), want["params"])
    errs.update(_leaf_errs(opt_state_to_reference(CFG, opt), want["opt"]))
    assert max(errs.values()) < STATE_TOL, errs


def reference_tree_np(model):
    import jax
    return jax.tree.map(lambda t: t.detach().numpy(), reference_tree(model))


def test_training_launches_no_kernel_and_attends_with_plain_softmax(
        monkeypatch):
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr("repro_torch.models.attention.flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    model = _port_model()
    b = _batches(1)[0]
    with torch.no_grad():
        model(torch.as_tensor(b["tokens"]))
    assert len(calls) == CFG.n_layers       # no-grad forward: the kernel
    calls.clear()
    opt = adamw_init(OPT, dict(model.named_parameters()))
    tsteps.make_train_step(model, OPT)(opt, b)
    assert calls == []                      # training: the model's softmax


@pytest.mark.parametrize("which", ["flash_attention", "ssd_scan"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(which):
    g = torch.Generator().manual_seed(0)
    if which == "flash_attention":
        q, k, v = (torch.randn(1, 2, 8, 16, generator=g) for _ in range(3))
        args = [q, k, v]
        call = lambda a: tfa.flash_attention(*a, causal=True)
    else:
        b, s, h, p, n = 1, 8, 2, 4, 8
        args = [torch.randn(b, s, h, p, generator=g),
                torch.rand(b, s, h, generator=g),
                -torch.rand(h, generator=g),
                torch.randn(b, s, n, generator=g),
                torch.randn(b, s, n, generator=g)]
        call = lambda a: tss.ssd_scan(*a, chunk=4)
    call(args)                              # plain inputs: fine
    for i in range(len(args)):
        bad = list(args)
        bad[i] = bad[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="requires grad"):
            call(bad)


# ----------------------------------------- twins of tests/test_system.py
class Args:
    def __init__(self, ckpt_dir, scheme="pb_rf"):
        self.scheme = scheme
        self.buffer_mb = 64
        self.ckpt_dir = ckpt_dir
        self.store_delay_ms = 1.0


def _assert_state_equal(model_a, opt_a, model_b, opt_b):
    for (n, a), (n2, b) in zip(model_a.named_parameters(),
                               model_b.named_parameters()):
        assert n == n2 and torch.equal(a, b), n
    assert set(opt_a) == set(opt_b)
    assert torch.equal(opt_a["step"], opt_b["step"])
    for k in ("m", "v"):
        assert all(torch.equal(opt_a[k][n], opt_b[k][n]) for n in opt_a[k])
    if "err" in opt_a:
        a, b = (stack_layers(CFG, unstack_layers(CFG, o["err"]))
                for o in (opt_a, opt_b))
        assert all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("scheme", ["nopb", "pb", "pb_rf"])
def test_train_crash_resume(tmp_path, scheme):
    model = _port_model(0)
    opt = adamw_init(OPT, dict(model.named_parameters()))
    data = SyntheticLMDataset(CFG.vocab, 16, 2)
    step = tsteps.make_train_step(model, OPT)
    mgr = ttrain.make_manager(Args(str(tmp_path), scheme))
    losses = []
    for i in range(6):
        opt, m = step(opt, data.next_batch())
        losses.append(float(m["loss"]))
        if (i + 1) % 3 == 0:
            ttrain.save_state(mgr, i + 1, model, opt, data.state())
    mgr.crash()
    mgr.recover()

    mgr2 = ttrain.make_manager(Args(str(tmp_path), scheme))
    try:
        m2 = _port_model(1)                          # different weights
        o2 = adamw_init(OPT, dict(m2.named_parameters()))
        rec = ttrain.restore_state(mgr2, m2, o2)
        assert rec is not None
        ver, m2, o2, data_state = rec
        assert ver == 6
        _assert_state_equal(model, opt, m2, o2)
        data2 = SyntheticLMDataset(CFG.vocab, 16, 2)
        data2.restore(data_state)
        _, m = tsteps.make_train_step(m2, OPT)(o2, data2.next_batch())
        assert abs(float(m["loss"]) - losses[-1]) < 1.0
    finally:
        mgr2.close()


def test_restore_prefers_buffer_forwarding(tmp_path):
    buf = HostBufferTier(capacity_bytes=64 << 20)
    store = DurableStore(str(tmp_path / "s"), write_delay_s=0.05)
    mgr = PCSCheckpointManager(buf, store, scheme=PersistScheme.PB_RF)
    mgr.persist("w", 1, np.ones(1000))
    got = mgr.restore("w")                   # store write still in flight
    assert got[0] == 1
    assert mgr.stats["restore_forwarded"] == 1
    mgr.close()


def test_cli_train_runs(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "smollm-135m", "--smoke", "--steps", "4", "--batch", "2",
           "--seq", "16", "--ckpt-every", "2", "--device", "cpu",
           "--ckpt-dir", str(tmp_path / "ck"), "--store-delay-ms", "1"]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "train done" in out.stdout
    # --resume picks the run up at its last checkpoint
    res = ttrain.main(cmd[3:] + ["--resume", "--steps", "6"])
    assert [len(res[k]) for k in ("metrics", "persist_s")] == [2, 1]
    assert res["stats"]["restore_from_store"] > 0


def test_bf16_state_round_trips_bit_for_bit(tmp_path):
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    model = params_from_reference(cfg, numpy_params(cfg, 0), "cpu")
    opt = adamw_init(OPT, dict(model.named_parameters()))
    opt, _ = tsteps.make_train_step(model, OPT)(opt, _batches(1)[0])
    # an error-feedback buffer in the gradients' dtype, as carried by
    # convert.opt_state_*_reference (the step itself drops it, F13)
    opt["err"] = stack_layers(cfg, {n: p.detach() / 3 for n, p in
                                    model.named_parameters()})
    mgr = ttrain.make_manager(Args(str(tmp_path), "pb_rf"))
    ttrain.save_state(mgr, 1, model, opt, {"step": 1, "seed": 0})
    m2 = params_from_reference(cfg, numpy_params(cfg, 1), "cpu")
    try:
        o2 = adamw_init(OPT, dict(m2.named_parameters()))
        ver, m2, o2, _ = ttrain.restore_state(mgr, m2, dict(o2, err=None))
    finally:
        mgr.close()
    assert ver == 1 and mgr.stats["restore_forwarded"] > 0
    assert m2.embed.table.dtype == torch.bfloat16
    assert opt["err"]["embed"]["table"].dtype == torch.bfloat16
    _assert_state_equal(model, opt, m2, o2)


# ------------------------------------------- checkpoints across packages
def test_checkpoints_restore_across_packages(ref, ref_runs, tmp_path):
    """The reference's ``save_state`` output restores into the port equal
    to the JAX state, and the port's into the reference."""
    import jax
    import jax.numpy as jnp
    want = ref_runs[(1, 0.0)]
    jparams = jax.tree.map(jnp.asarray, want["params"])
    jopt = jax.tree.map(jnp.asarray, want["opt"])
    rmgr = ref.train.make_manager(Args(str(tmp_path / "jax")))
    ref.train.save_state(rmgr, 3, jparams, jopt, {"step": 3, "seed": 0})
    rmgr.close()

    pmgr = ttrain.make_manager(Args(str(tmp_path / "jax")))
    model = _port_model(1)
    try:
        ver, model, opt, data_state = ttrain.restore_state(
            pmgr, model, adamw_init(OPT, dict(model.named_parameters())))
    finally:
        pmgr.close()
    assert ver == 3 and data_state == {"step": 3, "seed": 0}
    errs = _leaf_errs(reference_tree_np(model), want["params"])
    errs.update(_leaf_errs(opt_state_to_reference(CFG, opt), want["opt"]))
    assert max(errs.values()) == 0.0, errs

    # and back: the port's checkpoint, read by the reference
    opt2 = opt_state_from_reference(CFG, want["opt"], "cpu")
    pmgr = ttrain.make_manager(Args(str(tmp_path / "port")))
    ttrain.save_state(pmgr, 5, model, opt2, {"step": 5, "seed": 0})
    pmgr.close()
    rmgr = ref.train.make_manager(Args(str(tmp_path / "port")))
    p0 = jax.tree.map(jnp.asarray, numpy_params(CFG, 2))
    rec = ref.train.restore_state(
        rmgr, p0, ref.optim.adamw_init(ref.optim.AdamWConfig(), p0))
    rmgr.close()
    assert rec[0] == 5 and rec[3] == {"step": 5, "seed": 0}
    errs = _leaf_errs(_np_tree(rec[1]), want["params"])
    errs.update(_leaf_errs(_np_tree(rec[2]), want["opt"]))
    assert max(errs.values()) == 0.0, errs


# ------------------------------------------------------------- the datum
def test_train_ref_datum_has_the_shape_chip_smoke_reads():
    d = json.loads(TRAIN_REF.read_text())
    assert {"what", "script", "command", "rtol", "arch", "seed", "batch",
            "seq", "steps", "opt", "metrics"} <= set(d)
    assert "numpy_params" in d["script"] and d["arch"] == "smollm-135m"
    assert 0 < d["rtol"] <= 1e-4
    assert d["batch"] * d["seq"] > 0 and d["steps"] == len(d["metrics"])
    assert set(d["opt"]) == {"lr", "total_steps"}
    for m in d["metrics"]:
        assert set(m) == {"loss", "grad_norm", "lr"}
        assert all(np.isfinite(v) and v > 0 for v in m.values())
    port_cpu = d["port_cpu_max_rel_err"]
    assert 0 <= port_cpu < d["rtol"]
    tokens = np.asarray(d["tokens"])
    assert tokens.shape == (d["steps"], d["batch"], d["seq"])
    cfg = get_config(d["arch"])
    assert 0 <= tokens.min() and tokens.max() < cfg.vocab
    if np.__version__ == d["numpy_version"]:     # the same zipf stream
        data = SyntheticLMDataset(cfg.vocab, d["seq"], d["batch"],
                                  seed=d["seed"])
        for t in tokens:
            np.testing.assert_array_equal(data.next_batch()["tokens"], t)
