"""The model-side kernels' plain versions on the CPU, against the JAX
reference: ``flash_attention_ref`` against the JAX ``flash_attention_ref``
and the Pallas kernel in interpret mode, ``ssd_scan_ref`` against
``ssd_chunked`` (the JAX ``ssd_scan_ref``), the Pallas kernel and the
sequential recurrence; and the wrappers' dispatch (a CPU tensor takes
the plain version and launches nothing; what the kernel does not take
raises on every device).

The CUDA kernels themselves run only on the card (``chip_smoke.py``
phases 5-6); their source also runs here under the warp emulation
(``tests/test_torch_warp_emul_flash.py``,
``tests/test_torch_warp_emul_ssd.py``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_ref import reference
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_ref

# f32 on the CPU: the same math in another summation order.
TOL = 2e-5
SSD_TOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    with reference() as r:
        yield r


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(seed, b, h, s, d, hkv=None):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None), (False, 40)])
def test_flash_ref_matches_jax_ref_and_pallas(ref, causal, window):
    import jax.numpy as jnp
    q, k, v = _qkv(1, 1, 2, 128, 32)
    got = flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                              window=window).numpy()
    want = ref.kref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        window=window)
    pallas = ref.kflash.flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=64, block_k=64, interpret=True)
    assert np.max(np.abs(got - np.asarray(want))) < TOL
    assert np.max(np.abs(got - np.asarray(pallas))) < TOL


@pytest.mark.parametrize("s", [1, 37, 100])
def test_flash_ref_ragged_length(ref, s):
    """Any S (the Pallas kernel needs a multiple of its block)."""
    import jax.numpy as jnp
    q, k, v = _qkv(2 + s, 2, 2, s, 16)
    got = flash_attention_ref(_t(q), _t(k), _t(v), causal=True).numpy()
    want = ref.kref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True)
    assert np.max(np.abs(got - np.asarray(want))) < TOL


def test_flash_ref_grouped_kv_heads(ref):
    """Query head h reads KV head h // g: the JAX contract on K/V repeated
    per group."""
    import jax.numpy as jnp
    q, k, v = _qkv(3, 2, 6, 64, 32, hkv=2)
    got = flash_attention_ref(_t(q), _t(k), _t(v), causal=True).numpy()
    want = ref.kref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(np.repeat(k, 3, axis=1)),
        jnp.asarray(np.repeat(v, 3, axis=1)), causal=True)
    assert np.max(np.abs(got - np.asarray(want))) < TOL


def _ssd_case(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32),
            (-rng.uniform(0.5, 1.5, (h,))).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


def _close(got, want, tol=SSD_TOL):
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) < tol


def test_ssd_ref_matches_jax_ref_and_pallas(ref):
    import jax.numpy as jnp
    args = _ssd_case(4, 1, 128, 2, 16, 32)
    got = ssd_scan_ref(*map(_t, args), chunk=64)
    jargs = [jnp.asarray(a) for a in args]
    _close(got, ref.kref.ssd_scan_ref(*jargs, chunk=64))
    _close(got, ref.kssd.ssd_scan_pallas(*jargs, chunk=64, interpret=True))


@pytest.mark.parametrize("s,init", [(100, False), (128, True), (77, True)])
def test_ssd_ref_ragged_and_init_state(ref, s, init):
    import jax.numpy as jnp
    args = _ssd_case(5 + s, 2, s, 2, 16, 32)
    st = (np.random.default_rng(s).standard_normal((2, 2, 16, 32))
          .astype(np.float32) if init else None)
    got = ssd_scan_ref(*map(_t, args), chunk=64,
                       init_state=None if st is None else _t(st))
    want = ref.ssm.ssd_chunked(*[jnp.asarray(a) for a in args], chunk=64,
                               init_state=None if st is None
                               else jnp.asarray(st))
    _close(got, want)


def test_ssd_ref_matches_sequential_recurrence(ref):
    """The JAX ``ssd_decode_step`` run token by token."""
    import jax.numpy as jnp
    x, dt, A, B, C = _ssd_case(6, 1, 128, 2, 16, 32)
    st0 = np.random.default_rng(7).standard_normal((1, 2, 16, 32)) \
        .astype(np.float32)
    y, fin = ssd_scan_ref(*map(_t, (x, dt, A, B, C)), chunk=64,
                          init_state=_t(st0))
    state = jnp.asarray(st0)
    ys = []
    for t in range(x.shape[1]):
        yt, state = ref.ssm.ssd_decode_step(
            jnp.asarray(x[:, t]), jnp.asarray(dt[:, t]), jnp.asarray(A),
            jnp.asarray(B[:, t]), jnp.asarray(C[:, t]), state)
        ys.append(np.asarray(yt))
    _close((y, fin), (np.stack(ys, axis=1), state), tol=1e-3)


def test_wrappers_cpu_take_plain_versions():
    q, k, v = map(_t, _qkv(8, 1, 4, 70, 64, hkv=2))
    before = fa.launches
    assert torch.equal(fa.flash_attention(q, k, v, causal=True, window=16),
                       flash_attention_ref(q, k, v, causal=True, window=16))
    assert fa.launches == before
    args = list(map(_t, _ssd_case(9, 1, 100, 2, 16, 32)))
    st = torch.ones(1, 2, 16, 32)
    before = ss.launches
    got = ss.ssd_scan(*args, chunk=64, init_state=st)
    want = ssd_scan_ref(*args, chunk=64, init_state=st)
    assert ss.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", ["flash_attention", "ssd_scan",
                                  "tat_lookup"])
def test_ops_exports_match_reference_ops(ref, name):
    """``kernels.ops`` exports each wrapper under the reference's
    ``kernels.ops`` name, and on CPU tensors it gives what the reference's
    wrapper gives (the Pallas kernel in interpret mode there)."""
    import importlib

    import jax.numpy as jnp
    from repro_torch.kernels import ops
    rops = importlib.import_module("repro.kernels.ops")
    assert ops.__all__ == ["flash_attention", "ssd_scan", "tat_lookup"]
    if name == "flash_attention":
        args = _qkv(11, 1, 2, 128, 32)
        kw = dict(causal=True, window=48)
    elif name == "ssd_scan":
        args = _ssd_case(12, 1, 128, 2, 16, 32)
        kw = dict(chunk=64)
    else:
        rng = np.random.default_rng(13)
        args = (rng.integers(0, 32, 256).astype(np.int32),
                rng.integers(0, 32, 16).astype(np.int32),
                rng.integers(0, 3, 16).astype(np.int32))
        kw = {}
    got = getattr(ops, name)(*map(_t, args), **kw)
    want = getattr(rops, name)(*map(jnp.asarray, args), **kw)
    if name == "flash_attention":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        if name == "tat_lookup":
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            _close((g,), (w,), tol=TOL if name == "flash_attention"
                   else SSD_TOL)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "heads", "window",
                                 "mixed"])
def test_flash_wrapper_raises_on_what_it_does_not_take(bad):
    q, k, v = map(_t, _qkv(10, 1, 2, 32, 32))
    kw = {}
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = (torch.zeros(1, 2, 32, 48) for _ in range(3))
    elif bad == "heads":
        k, v = torch.zeros(1, 3, 32, 32), torch.zeros(1, 3, 32, 32)
    elif bad == "window":
        kw["window"] = 0
    else:
        k = k.bfloat16()
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("bad", ["dtype", "dt_dtype", "shape", "smem",
                                 "init", "tc_chunk", "tc_head_dim"])
def test_ssd_wrapper_raises_on_what_it_does_not_take(bad):
    x, dt, A, B, C = map(_t, _ssd_case(11, 1, 64, 2, 16, 32))
    kw = {"chunk": 64}
    if bad == "dtype":
        x, B, C = x.half(), B.half(), C.half()
    elif bad == "dt_dtype":
        dt = dt.double()
    elif bad == "shape":
        B = B[:, :32]
    elif bad == "smem":
        kw["chunk"] = 1024           # the chunk's tiles exceed 227 KiB
    elif bad == "tc_chunk":          # bf16: one or two 64-row warpgroups
        x, B, C = x.bfloat16(), B.bfloat16(), C.bfloat16()
        kw["chunk"] = 32
    elif bad == "tc_head_dim":       # bf16: P beyond one 64-column tile
        x = torch.zeros(1, 64, 2, 72, dtype=torch.bfloat16)
        B, C = B.bfloat16(), C.bfloat16()
    else:
        kw["init_state"] = torch.zeros(1, 2, 32, 16)
    with pytest.raises(ValueError):
        ss.ssd_scan(x, dt, A, B, C, **kw)
