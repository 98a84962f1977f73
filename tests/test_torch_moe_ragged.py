"""The port's ragged expert dispatch (``models.moe``) on the CPU, against
the JAX reference: ``moe_ffn`` at ``drop=False`` with a skewed router
(every first choice on expert 0, one expert with no row) and over several
routing groups; the sort's positions against the reference's cumsum
over the one-hot, exactly, with the capacity rule that drops past them;
and a spy on the expert products, which must see the routed rows alone.

Both packages get the same numpy inputs (f32); ``MOE_RTOL`` is
``tests/test_torch_moe.py``'s (1e-5 relative on outputs, aux and
gradients).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_ref import reference
from repro_torch.models import moe as tmoe

MOE_RTOL = 1e-5
D, F, E = 16, 24, 4


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


def _skewed(rng, b, s, e=E):
    """Inputs and an init_moe-shaped tree (f32) whose router sends every
    token's first choice to expert 0 and never chooses expert ``e - 1``:
    feature 0 of every token is 4, and the router's row 0 is +8 on expert
    0 and -8 on the last, small elsewhere."""
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    x[..., 0] = 4.0
    w = rng.standard_normal((D, e)).astype(np.float32) / 8.0
    w[0] = rng.standard_normal(e).astype(np.float32) / 8.0
    w[0, 0], w[0, e - 1] = 8.0, -8.0
    tree = {"router": {"w": w},
            "gate": rng.standard_normal((e, D, F)).astype(np.float32) / 4,
            "up": rng.standard_normal((e, D, F)).astype(np.float32) / 4,
            "down": rng.standard_normal((e, F, D)).astype(np.float32) / 5}
    return x, tree


def _routes(x, tree, top_k=2):
    """Each round's expert per token, by the reference's rule (numpy)."""
    xt = x.reshape(-1, D)
    logits = xt @ tree["router"]["w"]
    rem = np.exp(logits - logits.max(1, keepdims=True))
    out = []
    for _ in range(top_k):
        idx = rem.argmax(1)
        out.append(idx)
        rem[np.arange(len(idx)), idx] = 0.0
    return out


def _against_reference(ref, x, tree, **kw):
    """``moe_ffn``'s output, aux and the gradients of ``sum(y * w) + aux``
    with respect to x and every leaf, the port's against the
    reference's."""
    import jax
    import jax.numpy as jnp
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xj):
        y, aux = ref.moe.moe_ffn(p, xj, **kw)
        return jnp.sum(y * jnp.asarray(w)) + aux, (y, aux)
    jp = jax.tree.map(jnp.asarray, tree)
    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    leaves = [_t(tree["router"]["w"]), _t(tree["gate"]), _t(tree["up"]),
              _t(tree["down"])]
    for leaf in leaves:
        leaf.requires_grad_(True)
    tp = {"router": {"w": leaves[0]}, "gate": leaves[1], "up": leaves[2],
          "down": leaves[3]}
    xt = _t(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(tp, xt, **kw)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert _rel(y.detach(), jy) < MOE_RTOL
    assert abs(aux.item() - float(jaux)) <= MOE_RTOL * abs(float(jaux))
    g = torch.autograd.grad(torch.sum(y * _t(w)) + aux, [xt] + leaves)
    want = [jgx, jgp["router"]["w"], jgp["gate"], jgp["up"], jgp["down"]]
    for name, got, wnt in zip(("x", "router", "gate", "up", "down"), g,
                              want):
        assert _rel(got, wnt) < MOE_RTOL, name
    return y


@pytest.mark.parametrize("groups", (1, 2))
def test_skewed_router_without_drop_matches_reference(ref, groups):
    """Every first choice on expert 0, expert 3 on no row: the ragged
    path skips it and still gives the reference's output, aux and
    gradients, one routing group or two."""
    x, tree = _skewed(np.random.default_rng(21), 2, 12)
    first, second = _routes(x, tree)
    assert (first == 0).all() and not (second == E - 1).any()
    assert np.bincount(np.concatenate([first, second]),
                       minlength=E)[E - 1] == 0
    _against_reference(ref, x, tree, top_k=2, drop=False, groups=groups)


@pytest.mark.parametrize("groups", (2, 3, 4))
def test_groups_without_drop_match_reference(ref, groups):
    """``drop=False`` over several routing groups (24 tokens in 2, 3 or 4
    groups), each routed on its own rows."""
    rng = np.random.default_rng(30 + groups)
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    tree = {"router": {"w": rng.standard_normal((D, E)).astype(
        np.float32) / 4},
        "gate": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
        "up": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
        "down": rng.standard_normal((E, F, D)).astype(np.float32) / 5}
    _against_reference(ref, x, tree, top_k=2, drop=False, groups=groups)


def _cumsum_positions(ref, expert_flat, e):
    """The reference's positions (``repro/models/moe.py:96-99``), in
    jnp."""
    import jax.numpy as jnp
    ef = jnp.asarray(expert_flat)
    onehot = (ef[:, None] == jnp.arange(e)[None, :]).astype(jnp.int32)
    return np.asarray((jnp.cumsum(onehot, axis=0) - onehot)[
        jnp.arange(ef.shape[0]), ef])


# name -> (assignments, experts, how they are drawn)
DISPATCH_CASES = {
    "uniform": (48, 4, "uniform"),
    "skewed": (48, 4, "skewed"),
    "one_expert": (20, 8, "one"),
    "sixteen_experts_some_empty": (64, 16, "skewed"),
    "single_assignment": (1, 4, "uniform"),
}


@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_sort_positions_equal_the_reference_cumsum(ref, case):
    """``_positions`` are the reference's cumsum positions exactly;
    ``_dispatch``'s order sorts the assignments by expert, stably, and its
    counts are each expert's assignments.  At the capacity the reference
    takes with ``drop=True`` (a factor of 0.5, so some overflow), the
    same assignments are kept and dropped."""
    nk, e, how = DISPATCH_CASES[case]
    rng = np.random.default_rng(7)
    if how == "uniform":
        ef = rng.integers(0, e, nk)
    elif how == "skewed":
        ef = np.minimum(rng.geometric(0.45, nk) - 1, e - 2)
    else:
        ef = np.full(nk, 3)
    expert_flat = _t(ef.astype(np.int64))
    order, counts = tmoe._dispatch(expert_flat, e)
    pos = tmoe._positions(expert_flat, order, counts)
    want = _cumsum_positions(ref, ef, e)
    assert pos.dtype == torch.long and np.array_equal(pos.numpy(), want)
    assert np.array_equal(order.numpy(), np.argsort(ef, kind="stable"))
    assert np.array_equal(counts.numpy(), np.bincount(ef, minlength=e))
    n = max(nk // 2, 1)
    cap = max(int(0.5 * 2 * n / e), 1)
    if how != "uniform":
        assert (want >= cap).any()
    assert np.array_equal((pos < cap).numpy(), want < cap)


def test_drop_past_capacity_with_a_skewed_router_matches_reference(ref):
    """Training's path on the sort's positions: with every first choice on
    expert 0 and a capacity factor of 0.5 (6 assignments an expert), 18
    of expert 0's 24 overflow and are dropped as the reference drops
    them, and some tokens lose both of theirs."""
    x, tree = _skewed(np.random.default_rng(22), 2, 12)
    first, _ = _routes(x, tree)
    assert (first == 0).all() and max(int(0.5 * 2 * 24 / E), 1) == 6
    y = _against_reference(ref, x, tree, top_k=2, capacity_factor=0.5,
                           drop=True)
    assert bool((y.detach().abs().sum(-1) == 0).any())


def _spy(monkeypatch):
    """Every expert product's operand shapes and the data pointer of its
    weight."""
    calls = []
    real = tmoe._bmm_f32

    def spy(a, b, *out):
        calls.append((tuple(a.shape), tuple(b.shape), b.data_ptr()))
        return real(a, b, *out)
    monkeypatch.setattr(tmoe, "_bmm_f32", spy)
    return calls


@pytest.mark.parametrize("skewed", (False, True))
def test_expert_products_see_only_the_routed_rows(monkeypatch, skewed):
    """At ``drop=False`` the products are 2-D, three per expert with a
    row (gate and up expert by expert, then down), and together see
    ``n * k`` rows each: no padded buffer.  An expert with no row is not read.  At ``drop=True`` they
    stay the three batched products over the ``(e, cap, d)`` buffer."""
    rng = np.random.default_rng(23)
    if skewed:
        x, tree = _skewed(rng, 2, 12)
    else:
        x = rng.standard_normal((2, 12, D)).astype(np.float32)
        _, tree = _skewed(rng, 2, 12)
        tree["router"]["w"] = rng.standard_normal((D, E)).astype(
            np.float32) / 4
    tp = {"router": {"w": _t(tree["router"]["w"])}, "gate": _t(tree["gate"]),
          "up": _t(tree["up"]), "down": _t(tree["down"])}
    n, k = 24, 2
    counts = np.bincount(np.concatenate(_routes(x, tree)), minlength=E)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        tmoe.moe_ffn(tp, _t(x), top_k=k, drop=False)
    active = [j for j in range(E) if counts[j]]
    assert len(calls) == 3 * len(active)
    assert all(len(a) == 2 for a, _, _ in calls)
    u = len(active)
    for leaf, (want_b, mine) in {"gate": ((D, F), calls[0:2 * u:2]),
                                 "up": ((D, F), calls[1:2 * u:2]),
                                 "down": ((F, D), calls[2 * u:])}.items():
        assert [b for _, b, _ in mine] == [want_b] * len(active)
        assert sum(a[0] for a, _, _ in mine) == n * k
        assert [a[0] for a, _, _ in mine] == [int(counts[j]) for j in active]
        assert [p for _, _, p in mine] == [tp[leaf][j].data_ptr()
                                           for j in active]
    if skewed:
        assert active == [0, 1, 2] and counts[0] == n
    calls.clear()
    with torch.no_grad():
        tmoe.moe_ffn(tp, _t(x), top_k=k, capacity_factor=1.25, drop=True)
    cap = max(int(1.25 * k * n / E), 1)
    assert [a for a, _, _ in calls] == [(E, cap, D)] * 2 + [(E, cap, F)]


def test_meta_rows_split_evenly_and_sum_to_the_routed_rows(monkeypatch):
    """On the meta device (no counts) each expert takes ``ceil(n * k /
    e)`` rows, the last ones fewer, summing to ``n * k``; the output has
    the routed rows' shape."""
    e, rows = 16, 40
    xs = torch.empty((rows, D), device="meta")
    p = {"gate": torch.empty((e, D, F), device="meta"),
         "up": torch.empty((e, D, F), device="meta"),
         "down": torch.empty((e, F, D), device="meta")}
    calls = _spy(monkeypatch)
    out = tmoe._ragged_experts(p, xs, torch.empty(e, dtype=torch.long,
                                                  device="meta"))
    assert out.shape == (rows, D) and out.device.type == "meta"
    assert [a[0] for a, _, _ in calls[0:28:2]] == [3] * 13 + [1]
    assert [a[0] for a, _, _ in calls[28:]] == [3] * 13 + [1]


def test_chip_smoke_row_check_reads_the_routed_rows():
    """``chip_smoke.py`` 14b's row check on jamba at smoke size: one
    routing group a MoE layer, whose expert products see ``3 * n * k``
    rows (gate, up and down over the routed rows)."""
    from chip_smoke import moe_expert_rows
    from repro_torch import configs as tconfigs
    from repro_torch.launch import serve as tserve
    from repro_torch.models.convert import numpy_params, params_from_reference
    cfg = tconfigs.get_config("jamba-1.5-large-398b", smoke=True)
    model = params_from_reference(cfg, numpy_params(cfg, 0), "cpu")
    batch = tserve.random_batch(cfg, 2, 16, 0, "cpu")
    rows = moe_expert_rows(torch, model, batch, 24)
    n_moe = sum(s.moe for s in cfg.block_pattern) * (
        cfg.n_layers // len(cfg.block_pattern))
    nk = 2 * 16 * cfg.top_k
    assert n_moe > 0 and rows == [[nk, 3 * nk]] * n_moe
