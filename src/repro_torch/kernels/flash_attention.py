"""``flash_attention``: forward online-softmax attention (CUDA port).

Replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_pallas`` (body
``_kernel``): ``softmax(q kᵀ · D^-0.5) v`` per (batch, head) with a
causal mask and an optional sliding window, accumulated in f32.  Each
kernel gives one block to each (batch·head, 64-query tile); see the
sources' headers for their designs.

The route is fixed before launch by the dtype and the head dim (``ROUTES``;
:func:`route`):

* **bf16 → the tensor-core kernel** (``csrc/flash_attention_tc.cu``,
  entry ``flash_attention_tc_launch``): both products on ``wgmma`` with
  f32 accumulation, P in one bf16 part;
* **f32 with D <= 128 → the same tensor-core kernel**
  (``flash_attention_tc_f32_launch``): Q, K, V and P enter the products
  as three bf16 parts each, of whose cross products the six that reach
  f32 precision are kept (the source's Precision note), so the f32
  tolerance of 2e-5 holds on the tensor cores;
* **f32 with D = 256 → the same source's wide kernel**
  (``flash_attention_tc_f32_256_launch``): the same three parts and six
  products over 32-key tiles, so that three parts of Q, K and V fit a
  block's shared memory at that width.

The FMA kernel (``csrc/flash_attention.cu``, ``FMA_F32``) takes f32 at
every head dim but is on no route; ``chip_smoke.py`` holds it and times
it beside the tensor-core routes through :func:`launch`.

Each route counts its launches (``launches_tc`` for every tensor-core
entry, ``launches_fma``; ``launches`` is their sum; ``launches_by``
per entry).  A dtype or head
dim that no route takes raises; a failed build or launch raises too, and
nothing falls back to another route or to the plain version.

Beyond the Pallas contract, ``k`` and ``v`` may have fewer heads than
``q`` (grouped-query attention: query head ``h`` reads KV head
``h // (H // Hkv)``, the reference model's grouping, so the model needs
no repeated K/V), ``S`` need not be a multiple of the tile (the tail is
masked in the kernel), and the tensors may be strided views as long as
``D`` is the unit-stride axis: the model passes its ``(B, S, H, D)``
projections transposed, without a copy, and the output has ``q``'s
layout.  The tensor-core kernel reads 16-byte chunks, so its inputs'
other strides must be multiples of 16 bytes and their data 16-byte
aligned; an input that is not gets a contiguous copy first.

Dispatch is by device: a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.ref.flash_attention_ref`), and so does a meta
tensor, for its shapes alone (the launch layer's dry-run; the meta
device holds no data and runs no kernel); a CUDA tensor
launches its route's kernel or raises.  Both paths refuse what the
kernels do not take, and an input that requires grad: the kernels have
no backward, and an output written through ``ctypes`` would carry no
``grad_fn``, so a backward through it would silently give zero
gradients (the training path attends with the model's own softmax).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import refuse_grad
from repro_torch.kernels.ref import flash_attention_ref

# Launches per route (one per wrapper call on CUDA), their sum, and per
# C entry.
launches = 0
launches_tc = 0
launches_fma = 0
launches_by: dict = {}

HEAD_DIMS = (16, 32, 64, 128, 256)
# A route: the kernel's library (csrc/<lib>.cu) and its C entry point.
TC_BF16 = ("flash_attention_tc", "flash_attention_tc_launch")
TC_F32 = ("flash_attention_tc", "flash_attention_tc_f32_launch")
TC_F32_256 = ("flash_attention_tc", "flash_attention_tc_f32_256_launch")
FMA_F32 = ("flash_attention", "flash_attention_launch")
TC_F32_MAX_D = 128          # fatc::F32_MAX_D in the source
# dtype -> ((largest head dim, route), ...): the first that takes D serves.
ROUTES = {torch.bfloat16: ((256, TC_BF16),),
          torch.float32: ((TC_F32_MAX_D, TC_F32), (256, TC_F32_256))}
DTYPES = tuple(ROUTES)


def route(dtype: torch.dtype, d: int):
    """The (library, entry) that serves ``dtype`` at head dim ``d``."""
    return next(r for dmax, r in ROUTES[dtype] if d <= dmax)


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
    f32 tensors whose last axis is unit-stride, the tensor-core entries
    (``flash_attention_tc_launch`` bf16, ``flash_attention_tc_f32_launch``
    f32 at D <= 128, ``flash_attention_tc_f32_256_launch`` f32 at D =
    256) tensors that :func:`_for_copies` accepts."""
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
    """``x`` if the tensor-core kernel's 16-byte reads can take it (unit
    last stride, other strides multiples of 16 bytes, data 16-byte
    aligned), else a contiguous copy."""
    per = 16 // x.element_size()
    if x.stride(-1) == 1 and all(st % per == 0 for st in x.stride()[:-1]) \
            and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S, D), k/v: (B, Hkv, S, D) -> (B, H, S, D) in q's dtype."""
    global launches, launches_tc, launches_fma
    refuse_grad("flash_attention", q, k, v)
    _check_inputs(q, k, v, window)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    name, entry = route(q.dtype, q.shape[-1])
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
                window=window, stream=stream, entry=entry)
    _build.check(rc, f"{entry}")
    if tc:
        launches_tc += 1
    else:
        launches_fma += 1
    launches += 1
    launches_by[entry] = launches_by.get(entry, 0) + 1
    return out
