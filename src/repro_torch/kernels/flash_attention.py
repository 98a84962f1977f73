"""``flash_attention``: forward online-softmax attention (CUDA port).

Replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_pallas`` (body
``_kernel``): ``softmax(q kᵀ · D^-0.5) v`` per (batch, head) with a
causal mask and an optional sliding window, accumulated in f32.  Each
kernel gives one block to each (batch·head, 64-query tile); see the
sources' headers for their designs.

The route is fixed by the dtype:

* **bf16 → the tensor-core kernel** (``csrc/flash_attention_tc.cu``):
  both products on ``wgmma`` with f32 accumulation, P rounded to bf16;
* **f32 → the FMA kernel** (``csrc/flash_attention.cu``): f32 products
  on the FMA units.  ``wgmma`` would read f32 operands as TF32 (about
  three decimal digits), which cannot hold the f32 tolerance of 2e-5.

Each route counts its launches (``launches_tc``, ``launches_fma``;
``launches`` is their sum).  A dtype or head dim that neither kernel
takes raises; a failed build or launch raises too, and nothing falls
back to the other route or to the plain version.

Beyond the Pallas contract, ``k`` and ``v`` may have fewer heads than
``q`` (grouped-query attention: query head ``h`` reads KV head
``h // (H // Hkv)``, the reference model's grouping, so the model needs
no repeated K/V), ``S`` need not be a multiple of the tile (the tail is
masked in the kernel), and the tensors may be strided views as long as
``D`` is the unit-stride axis: the model passes its ``(B, S, H, D)``
projections transposed, without a copy, and the output has ``q``'s
layout.  The tensor-core kernel copies 16-byte chunks, so its inputs'
other strides must be multiples of 8 elements and their data 16-byte
aligned; an input that is not gets a contiguous copy first.

Dispatch is by device: a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.ref.flash_attention_ref`); a CUDA tensor
launches its route's kernel or raises.  Both paths refuse what the
kernels do not take.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

# Launches per route (one per wrapper call on CUDA), and their sum.
launches = 0
launches_tc = 0
launches_fma = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
# The kernel that serves each dtype: csrc/<name>.cu, entry <name>_launch.
ROUTES = {torch.bfloat16: "flash_attention_tc",
          torch.float32: "flash_attention"}
DTYPES = tuple(ROUTES)


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
           stream, entry: str = "flash_attention_launch") -> int:
    """Call ``entry`` of ``lib`` on checked tensors; returns the C entry
    point's error code.  ``flash_attention_launch`` (the FMA kernel) takes
    f32 tensors whose last axis is unit-stride,
    ``flash_attention_tc_launch`` (the tensor-core kernel) bf16 tensors
    that :func:`_for_copies` accepts."""
    b, h, s, d = q.shape
    strides = (ctypes.c_longlong * 12)(*(
        st for x in (q, k, v, out) for st in (x.stride(0), x.stride(1),
                                              x.stride(2))))
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_void_p]
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              ctypes.addressof(strides), b, h, s, d, h // k.shape[1],
              int(causal), 0 if window is None else int(window), d ** -0.5,
              stream)


def _for_copies(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the tensor-core kernel's 16-byte copies can read it (unit
    last stride, other strides multiples of 8 elements, data 16-byte
    aligned), else a contiguous copy."""
    if x.stride(-1) == 1 and all(st % 8 == 0 for st in x.stride()[:-1]) \
            and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S, D), k/v: (B, Hkv, S, D) -> (B, H, S, D) in q's dtype."""
    global launches, launches_tc, launches_fma
    _check_inputs(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    name = ROUTES[q.dtype]
    tc = name == "flash_attention_tc"
    prep = _for_copies if tc else _unit_last
    q, k, v = prep(q), prep(k), prep(v)
    out = torch.empty_like(q)           # q's layout (dense, D unit-stride)
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = launch(_build.library(name), q, k, v, out, causal=causal,
                window=window, stream=stream, entry=f"{name}_launch")
    _build.check(rc, f"{name} launch")
    if tc:
        launches_tc += 1
    else:
        launches_fma += 1
    launches += 1
    return out
