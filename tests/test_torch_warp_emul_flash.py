"""The attention kernels, run from their CUDA source on the CPU
(``_warp_emul``) against the plain ``flash_attention_ref``: the FMA
kernel, the tensor-core kernel (its wgmma, copies and swizzle done by
the twin header on the PTX ISA's documented layouts) in bf16 and in f32
on three bf16 parts, at D <= 128 and on its D = 256 entry, and the
wrapper's routes."""
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
                      we.FLASH_TC_LAUNCH)))


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
    model's strided (B, S, H, D) layout: GQA, window, ragged S; bf16, and
    f32 in three bf16 parts (its own entry) at the f32 limit."""
    rng = np.random.default_rng(3 * s + d + h)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d))
                                .astype(np.float32)).to(dtype)
               .transpose(1, 2) for n in (h, hkv, hkv))
    out = torch.empty_like(q)
    name, entry = fa.route(dtype, d)
    assert name == "flash_attention_tc"
    assert fa.launch(model_libs[name], q, k, v, out, causal=causal,
                     window=window, stream=None, entry=entry) == 0
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert bool(torch.isfinite(out.float()).all())
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert float((out.float() - want.float()).abs().max()) < tol


def test_flash_routes_by_dtype(model_libs, monkeypatch):
    """bf16 takes the tensor-core kernel at every head dim, f32 takes it up
    to D = 128 and its wide kernel at D = 256 (its own entry, counted by
    the wrapper); an f32 input at D = 256 through that route's emulated
    kernel holds 2e-5, the D <= 128 entry refuses it, the wide entry
    refuses any other D, the FMA kernel (on no route) holds it too, and a
    head dim no route takes raises."""
    assert all(fa.route(torch.bfloat16, d) == fa.TC_BF16
               for d in fa.HEAD_DIMS)
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
