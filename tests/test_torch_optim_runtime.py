"""The port's optimizer, data pipeline and runtime substrate on the CPU.

Twins of ``tests/test_runtime.py``'s tests other than
``test_sharding_rules`` (launch/sharding.py is not ported: ROADMAP Queue
A item 11), then against the JAX reference: ``adamw_update`` over 5
steps on the same f32 tree within 1e-6 (relative to each leaf's largest
|value|; the schedules, clipping on and off), ``cosine_schedule`` within
1e-6 relative, ``topk_compress_grads``'s masks exactly equal (ties at
the threshold included) and its values within 1e-7, and
``SyntheticLMDataset`` batches equal bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_ref import reference
from repro_torch.data import SyntheticLMDataset
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm,
                               topk_compress_grads)
from repro_torch.runtime import (FailureDetector, NodeStatus,
                                 StragglerMitigator, plan_mesh)

ADAM_TOL = 1e-6


# ----------------------------------------- twins of tests/test_runtime.py
def test_failure_detector_states():
    t = [0.0]
    det = FailureDetector(["a", "b"], suspect_after_s=1.0, dead_after_s=3.0,
                          clock=lambda: t[0])
    t[0] = 1.5
    det.heartbeat("a")
    t[0] = 2.0
    st = det.sweep()
    assert st["a"] == NodeStatus.HEALTHY
    assert st["b"] == NodeStatus.SUSPECT
    t[0] = 4.0
    st = det.sweep()
    assert st["a"] == NodeStatus.SUSPECT
    assert st["b"] == NodeStatus.DEAD
    assert det.alive() == ["a"]
    assert det.dead() == ["b"]


def test_elastic_plan_shrinks_data_axis():
    plan = plan_mesh(256, model_parallel=16)
    assert plan.shape == (16, 16) and plan.grad_accum == 1
    plan = plan_mesh(255, model_parallel=16)
    assert plan.shape == (15, 16) and plan.grad_accum == 2
    plan = plan_mesh(511, model_parallel=16, pods=2)
    assert plan.shape == (2, 15, 16)
    assert plan_mesh(7, model_parallel=16) is None


def test_straggler_flags_and_catchup():
    m = StragglerMitigator(window=16, deadline_factor=2.0)
    for _ in range(10):
        assert not m.observe(1.0)
    assert m.observe(5.0)
    assert m.take_catchup() == 1
    assert m.take_catchup() == 0


def test_adamw_reduces_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                      total_steps=100, schedule="const")
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(cfg, params)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(cfg, params, grads, state)
    assert float(torch.max(torch.abs(params["w"]))) < 0.5


def test_grad_clip_bounds_update():
    cfg = AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0,
                      warmup_steps=1, schedule="const")
    params = {"w": torch.zeros(4)}
    state = adamw_init(cfg, params)
    _, _, m = adamw_update(cfg, params, {"w": torch.full((4,), 1e6)}, state)
    assert float(m["grad_norm"]) > 1e6  # reported pre-clip


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s))) for s in (1, 10, 100)]
    assert lrs[0] < lrs[1]
    assert lrs[2] < 1e-6


def test_topk_compression_error_feedback():
    g = {"w": torch.tensor([1.0, 0.1, 0.01, 0.001])}
    comp, err = topk_compress_grads(g, None, ratio=0.25)
    assert float(torch.sum(comp["w"] != 0)) == 1
    comp2, err2 = topk_compress_grads(
        {"w": torch.zeros_like(g["w"])}, err, ratio=0.25)
    assert float(comp2["w"][1]) > 0.0


def test_data_pipeline_deterministic_resume():
    d1 = SyntheticLMDataset(1000, 16, 4, seed=7)
    b0 = d1.next_batch()
    st = d1.state()
    b1 = d1.next_batch()
    d2 = SyntheticLMDataset(1000, 16, 4, seed=7)
    d2.restore(st)
    b1b = d2.next_batch()
    np.testing.assert_array_equal(b1["tokens"], b1b["tokens"])
    assert not np.array_equal(b0["tokens"], b1["tokens"])


# -------------------------------------------------- against the reference
@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _tree(rng):
    """A dict-and-list tree like the model's (f32 leaves of mixed
    shapes, one scalar)."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"embed": {"table": f(7, 5)}, "blocks": [
        {"w": f(3, 5, 4), "scale": f(3, 5)}, {"w": f(3, 4, 5)}],
        "bias": f(1)}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _max_rel(got, want):
    import jax
    out = 0.0
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        out = max(out, float(np.max(np.abs(g - w)) / np.max(np.abs(w))))
    return out


@pytest.mark.parametrize("kw", [
    dict(), dict(schedule="linear", clip_norm=None),
    dict(schedule="const", warmup_steps=2, clip_norm=0.5),
    dict(weight_decay=0.0, warmup_steps=1, total_steps=4)],
    ids=["cosine", "linear_noclip", "const_clip", "nodecay"])
def test_adamw_update_matches_reference_over_5_steps(ref, kw):
    import jax.numpy as jnp
    kw = dict(dict(lr=1e-2, warmup_steps=3, total_steps=8), **kw)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    tcfg, rcfg = AdamWConfig(**kw), ref.optim.AdamWConfig(**kw)
    tp, rp = _map(torch.from_numpy, p0), _map(jnp.asarray, p0)
    ts, rs = adamw_init(tcfg, tp), ref.optim.adamw_init(rcfg, rp)
    for g in grads:
        tp, ts, tm = adamw_update(tcfg, tp, _map(torch.from_numpy, g), ts)
        rp, rs, rm = ref.optim.adamw_update(rcfg, rp, _map(jnp.asarray, g),
                                            rs)
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(rm[k])) <= ADAM_TOL * abs(
                float(rm[k])), k
    assert int(ts["step"]) == int(rs["step"]) == 5
    assert ts["step"].dtype == torch.int32
    to_np = lambda t: _map(lambda x: x.numpy(), t)
    assert _max_rel(to_np(tp), rp) < ADAM_TOL
    assert _max_rel(to_np(ts["m"]), rs["m"]) < ADAM_TOL
    assert _max_rel(to_np(ts["v"]), rs["v"]) < ADAM_TOL
    gt = global_norm(_map(torch.from_numpy, grads[0]))
    gr = ref.optim.global_norm(_map(jnp.asarray, grads[0]))
    assert abs(float(gt) - float(gr)) <= ADAM_TOL * float(gr)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_cosine_schedule_matches_reference(ref, schedule):
    import jax.numpy as jnp
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=50, schedule=schedule)
    for s in (0, 1, 5, 10, 11, 30, 50, 80):
        got = float(cosine_schedule(AdamWConfig(**kw), torch.tensor(s)))
        want = float(ref.optim.cosine_schedule(ref.optim.AdamWConfig(**kw),
                                               jnp.asarray(s)))
        assert abs(got - want) <= ADAM_TOL * max(abs(want), 1e-12), s


def test_topk_masks_match_reference_ties_included(ref):
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    ties = np.array([3.0, -1.0, 1.0, 0.5, -1.0, 1.0, 0.25, 2.0],
                    np.float32)       # k = 4 at 0.5: four |x| tie at 1.0
    grads = {"ties": ties, "w": rng.standard_normal((6, 7)).astype(
        np.float32), "blocks": [{"b": np.round(rng.standard_normal(
            (3, 10)), 1).astype(np.float32)}]}
    err = _map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(
        np.float32), grads)
    for e in (None, err):
        for ratio in (0.5, 0.1):
            tc, te = topk_compress_grads(
                _map(torch.from_numpy, grads),
                None if e is None else _map(torch.from_numpy, e), ratio)
            rc, re_ = ref.optim.topk_compress_grads(
                _map(jnp.asarray, grads),
                None if e is None else _map(jnp.asarray, e), ratio)
            for name in ("ties", "w"):
                got, want = tc[name].numpy(), np.asarray(rc[name])
                np.testing.assert_array_equal(got != 0, want != 0)
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
                np.testing.assert_allclose(te[name].numpy(),
                                           np.asarray(re_[name]), atol=1e-7)
            np.testing.assert_array_equal(
                tc["blocks"][0]["b"].numpy() != 0,
                np.asarray(rc["blocks"][0]["b"]) != 0)
    tc, _ = topk_compress_grads({"t": torch.from_numpy(ties)}, None, 0.5)
    assert int((tc["t"] != 0).sum()) == 6     # the k-th's ties all kept


@pytest.mark.parametrize("frontend", [None, "audio", "vision"])
def test_dataset_batches_equal_reference_bit_for_bit(ref, frontend):
    kw = dict(seed=3, d_model=8, frontend=frontend, frontend_seq=4)
    got = SyntheticLMDataset(997, 24, 3, **kw)
    want = ref.data.SyntheticLMDataset(997, 24, 3, **kw)
    for _ in range(4):
        g, w = got.next_batch(), want.next_batch()
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert got.state() == want.state()
