"""``flash_attention``: forward online-softmax attention (CUDA port).

Replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_pallas`` (body
``_kernel``): ``softmax(q kᵀ · D^-0.5) v`` per (batch, head) with a
causal mask and an optional sliding window, accumulated in f32.  The
kernel (``csrc/flash_attention.cu``) gives one block to each
(batch·head, 64-query tile); see its header for the design.

Beyond the Pallas contract, ``k`` and ``v`` may have fewer heads than
``q`` (grouped-query attention: query head ``h`` reads KV head
``h // (H // Hkv)``, the reference model's grouping, so the model needs
no repeated K/V), ``S`` need not be a multiple of the tile (the tail is
masked in the kernel), and the tensors may be strided views as long as
``D`` is the unit-stride axis: the model passes its ``(B, S, H, D)``
projections transposed, without a copy, and the output has ``q``'s
layout.

Dispatch is by device: a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.ref.flash_attention_ref`); a CUDA tensor
launches the kernel or raises.  Both paths refuse what the kernel does
not take.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

# Launches of the kernel (one per wrapper call on CUDA).
launches = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def _check_inputs(q, k, v, window) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-d "
                             f"(B, H, S, D), got {tuple(x.shape)}")
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError("flash_attention: q, k and v differ in dtype "
                             "or device")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         f"{DTYPES}")
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(f"flash_attention: k/v shape {tuple(k.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {k.shape[1]} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")


def _unit_last(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def launch(lib, q, k, v, out, *, causal: bool, window: Optional[int],
           stream) -> int:
    """Call ``flash_attention_launch`` of ``lib`` on checked tensors whose
    last axis is unit-stride; returns the C entry point's error code."""
    b, h, s, d = q.shape
    strides = (ctypes.c_longlong * 12)(*(
        st for x in (q, k, v, out) for st in (x.stride(0), x.stride(1),
                                              x.stride(2))))
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              ctypes.addressof(strides), b, h, s, d, h // k.shape[1],
              int(causal), 0 if window is None else int(window), d ** -0.5,
              int(q.dtype == torch.bfloat16), stream)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S, D), k/v: (B, Hkv, S, D) -> (B, H, S, D) in q's dtype."""
    global launches
    _check_inputs(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    out = torch.empty_like(q)           # q's layout (dense, D unit-stride)
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    rc = launch(_build.library("flash_attention"), q, k, v, out,
                causal=causal, window=window,
                stream=torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention launch")
    launches += 1
    return out
