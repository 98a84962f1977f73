"""The attention kernels, run from their CUDA source on the CPU
(``_warp_emul``) against the plain ``flash_attention_ref``: the FMA
kernel, the tensor-core kernel (its wgmma, copies and swizzle done by
the twin header on the PTX ISA's documented layouts) in bf16 and in f32
on three bf16 parts, at D <= 128 and on its D = 256 entry, the
warp-specialised bf16 kernel (its TMA loads, mbarriers and named
barriers done by the twin header too), and the wrapper's routes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _warp_emul as we
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_ref


@pytest.fixture(scope="module")
def model_libs(tmp_path_factory):
    return we.build(tmp_path_factory.mktemp("warp_emul_flash"),
                    (("flash_attention", "flash_attention",
                      we.FLASH_LAUNCH),
                     ("flash_attention_tc", "flash_attention_tc",
                      we.FLASH_TC_LAUNCH),
                     ("flash_attention_ws", "flash_attention_ws",
                      we.FLASH_WS_LAUNCH)))


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window,dtype", [
    (1, 2, 2, 128, 32, True, None, torch.float32),
    (1, 2, 2, 128, 32, True, 48, torch.float32),
    (1, 2, 2, 128, 32, False, None, torch.float32),
    (1, 2, 2, 96, 16, False, 40, torch.float32),
    (2, 4, 2, 70, 16, True, None, torch.float32),
    (1, 3, 1, 64, 64, True, None, torch.bfloat16)])
def test_emulated_flash_attention_equals_plain(model_libs, b, h, hkv, s, d,
                                               causal, window, dtype):
    """The FMA kernel (f32) and the tensor-core kernel (bf16) on strided
    (B, S, H, D) views, as the model passes them; GQA; ragged S; bf16
    loads and stores."""
    rng = np.random.default_rng(s + d + h)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d))
                                .astype(np.float32)).to(dtype)
               .transpose(1, 2) for n in (h, hkv, hkv))
    out = torch.empty_like(q)
    assert out.stride() == q.stride()
    name, entry = fa.FMA_F32 if dtype == torch.float32 else fa.TC_BF16
    assert fa.launch(model_libs[name], q, k, v, out, causal=causal,
                     window=window, stream=None, entry=entry) == 0
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert float((out.float() - want.float()).abs().max()) < tol



@pytest.mark.parametrize("b,h,hkv,s,d,causal,window,dtype", we.by_dtype([
    (1, 3, 1, 100, 64, True, None, torch.bfloat16),   # GQA g = 3, ragged S
    (1, 3, 1, 200, 64, True, 64, torch.bfloat16),     # window: empty rows
    (1, 2, 2, 96, 128, False, None, torch.bfloat16),
    (1, 2, 1, 130, 128, True, 64, torch.bfloat16),
    (1, 3, 1, 70, 256, True, None, torch.bfloat16),
    (2, 2, 1, 64, 32, True, None, torch.bfloat16),    # D < 64: zero-padded
    (1, 3, 1, 100, 64, True, None, torch.float32),
    (1, 3, 1, 200, 64, True, 64, torch.float32),
    (1, 2, 2, 96, 128, False, None, torch.float32),
    (1, 2, 1, 130, 128, True, 64, torch.float32),
    (2, 2, 1, 64, 32, True, None, torch.float32),
    (1, 2, 1, 70, 16, False, 40, torch.float32),
    (1, 2, 1, 70, 256, True, None, torch.float32),    # D = 256: GQA, tail S
    (1, 2, 2, 100, 256, True, 48, torch.float32),     # window
    (1, 2, 2, 64, 256, False, None, torch.float32),
    # gemma3's local layers cut down: a window over several key tiles
    # with a ragged last tile, and a window inside one tile
    (1, 2, 1, 300, 256, True, 100, torch.bfloat16),
    (1, 2, 1, 200, 256, True, 20, torch.bfloat16),
    (1, 2, 1, 300, 256, True, 100, torch.float32),
    (1, 2, 1, 150, 256, True, 20, torch.float32)]))
def test_emulated_flash_tc_equals_plain(model_libs, b, h, hkv, s, d, causal,
                                        window, dtype):
    """The tensor-core kernel's body, its wgmma, copies and swizzle done
    by the twin header on the PTX ISA's documented layouts, in the
    model's strided (B, S, H, D) layout: GQA, window, ragged S; bf16
    (its own entry, held at every head dim it is built for, on the route
    or not), and f32 in three bf16 parts (the f32 routes' entries) at the
    f32 limit."""
    rng = np.random.default_rng(3 * s + d + h)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d))
                                .astype(np.float32)).to(dtype)
               .transpose(1, 2) for n in (h, hkv, hkv))
    out = torch.empty_like(q)
    name, entry = fa.TC_BF16 if dtype == torch.bfloat16 \
        else fa.route(dtype, d)
    assert name == "flash_attention_tc"
    assert fa.launch(model_libs[name], q, k, v, out, causal=causal,
                     window=window, stream=None, entry=entry) == 0
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert bool(torch.isfinite(out.float()).all())
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert float((out.float() - want.float()).abs().max()) < tol


def test_flash_routes_by_dtype(model_libs, monkeypatch):
    """bf16 takes the tensor-core kernel at D <= 32 and the
    warp-specialised one from D = 64 on (counted by the wrapper under its
    entry), f32 takes the tensor-core kernel up to D = 128 and its wide
    kernel at D = 256 (its own entry, counted by the wrapper); an f32
    input at D = 256 through that route's emulated kernel holds 2e-5,
    the D <= 128 entry refuses it, the wide entry refuses any other D,
    the FMA kernel (on no route) holds it too, and a head dim no route
    takes raises."""
    assert [fa.route(torch.bfloat16, d) for d in fa.HEAD_DIMS] == \
        [fa.TC_BF16] * 2 + [fa.WS_BF16] * 3
    assert [fa.route(torch.float32, d) for d in fa.HEAD_DIMS] == \
        [fa.TC_F32] * 4 + [fa.TC_F32_256]
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 70, n, 256))
                                .astype(np.float32)).transpose(1, 2)
               for n in (3, 1, 1))
    want = flash_attention_ref(q, k, v, causal=True)
    for name, entry in (fa.route(q.dtype, 256), fa.FMA_F32):
        out = torch.empty_like(q)
        assert fa.launch(model_libs[name], q, k, v, out, causal=True,
                         window=None, stream=None, entry=entry) == 0
        assert float((out - want).abs().max()) < 2e-5
    assert fa.launch(model_libs["flash_attention_tc"], q, k, v, out,
                     causal=True, window=None, stream=None,
                     entry=fa.TC_F32[1]) != 0
    assert fa.launch(model_libs["flash_attention_tc"], q[..., :128],
                     k[..., :128], v[..., :128], out[..., :128],
                     causal=True, window=None, stream=None,
                     entry=fa.TC_F32_256[1]) != 0
    with pytest.raises(AttributeError):   # the FMA library has no bf16 entry
        model_libs["flash_attention"].flash_attention_tc_launch
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :48], k[..., :48], v[..., :48])

    # the wrapper's count: a CUDA-only launch, so the route's library and
    # the device are the emulation's here
    class Cuda:
        type = "cuda"
    cuda = Cuda()
    monkeypatch.setattr(fa._build, "library", lambda name: model_libs[name])
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": None}))
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    before = (fa.launches_tc, fa.launches_fma,
              fa.launches_by.get(fa.TC_F32_256[1], 0))
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "device", property(lambda self: cuda))
        got = fa.flash_attention(qc, kc, vc, causal=True)
    assert (fa.launches_tc, fa.launches_fma,
            fa.launches_by.get(fa.TC_F32_256[1], 0)) == \
        (before[0] + 1, before[1], before[2] + 1)
    assert float((got - want).abs().max()) < 2e-5
    qb, kb, vb = (x[..., :128].bfloat16() for x in (qc, kc, vc))
    before = (fa.launches_tc, fa.launches_by.get(fa.WS_BF16[1], 0))
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "device", property(lambda self: cuda))
        got = fa.flash_attention(qb, kb, vb, causal=True)
    assert (fa.launches_tc, fa.launches_by.get(fa.WS_BF16[1], 0)) == \
        (before[0] + 1, before[1] + 1)
    want = flash_attention_ref(qb, kb, vb, causal=True)
    assert float((got.float() - want.float()).abs().max()) < 3e-2


# (b, h, hkv, s, d, causal, window, layout, grid): layout "bshd" is the
# model's strided (B, S, H, D) projections viewed (B, H, S, D), "bhsd" a
# contiguous (B, H, S, D) tensor; grid 0 gives each 128-query work tile a
# block, grid n > 0 at most n blocks that walk the tiles (the K/V ring,
# its phases and the consumers' turns running on across tiles).
WS_CASES = [
    (1, 2, 2, 70, 64, True, None, "bshd", 0),      # ragged S, g = 1
    (1, 4, 2, 200, 64, False, None, "bshd", 0),    # non-causal, g = 2
    (1, 8, 1, 200, 64, True, 50, "bshd", 0),       # window below the tile
    (2, 2, 1, 200, 128, True, None, "bshd", 0),    # ragged S, g = 2
    (1, 2, 2, 70, 128, False, 30, "bshd", 0),      # non-causal window
    (1, 8, 1, 200, 128, True, 150, "bshd", 0),     # window above the tile
    (1, 4, 2, 130, 128, True, None, "bhsd", 0),    # (S, H) map order
    (1, 2, 2, 70, 256, True, None, "bshd", 0),
    (1, 2, 1, 200, 256, True, 100, "bshd", 0),
    (1, 2, 1, 200, 256, False, None, "bshd", 0),
    (1, 3, 1, 300, 128, True, None, "bshd", 2),    # blocks walk tiles
    (1, 2, 2, 200, 256, True, 150, "bshd", 2)]


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window,layout,grid", WS_CASES)
def test_emulated_flash_ws_equals_plain(model_libs, b, h, hkv, s, d,
                                        causal, window, layout, grid):
    """The warp-specialised bf16 kernel's body and its host-side tensor
    maps (``prepare``), its TMA tile loads, mbarriers, named barriers and
    wgmma done by the twin header on the PTX ISA's and the CUDA driver's
    documented layouts, against the plain version: each output within
    3e-2 and each row within 2^-6 of its largest |plain|, at D = 64, 128
    and 256, causal, non-causal and windowed, ragged S, GQA groups of 1,
    2 and 8, both layouts, one block a tile and blocks that walk tiles.
    The emulation runs every copy synchronously, so a missing fence or
    wait on a copy shows only on the card (chip_smoke.py)."""
    rng = np.random.default_rng(5 * s + d + h)
    shape = (lambda n: (b, s, n, d)) if layout == "bshd" \
        else (lambda n: (b, n, s, d))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape(n))
                                .astype(np.float32)).bfloat16()
               for n in (h, hkv, hkv))
    if layout == "bshd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    out = torch.empty_like(q)
    lib = model_libs[fa.WS_BF16[0]]
    lib.flash_ws_emu_grid(grid)
    try:
        assert fa.launch(lib, q, k, v, out, causal=causal, window=window,
                         stream=None, entry=fa.WS_BF16[1]) == 0
    finally:
        lib.flash_ws_emu_grid(0)
    want = flash_attention_ref(q, k, v, causal=causal,
                               window=window).float()
    got = out.float()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) < 3e-2
    assert float(((got - want).abs().amax(-1)
                  / want.abs().amax(-1)).max()) <= 2.0 ** -6


@pytest.mark.parametrize("d", [16, 32])
def test_flash_ws_entry_refuses_head_dim(model_libs, d):
    """The warp-specialised entry takes D = 64, 128 and 256 only: at the
    JAX sweep's D = 16 and 32 (the other tensor-core kernel's) it returns
    a non-zero code and writes nothing."""
    q, k, v = (torch.ones((1, 2, 70, d), dtype=torch.bfloat16)
               for _ in range(3))
    out = torch.full_like(q, 7.0)
    assert fa.route(torch.bfloat16, d) == fa.TC_BF16
    assert fa.launch(model_libs[fa.WS_BF16[0]], q, k, v, out, causal=True,
                     window=None, stream=None, entry=fa.WS_BF16[1]) != 0
    assert bool((out == 7.0).all())
