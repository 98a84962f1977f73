"""``ssd_scan``: Mamba2 SSD chunked scan (CUDA port).

Replaces the Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan_pallas``
(body ``_kernel``) and takes the initial state of the function it stands
for, ``repro.models.ssm.ssd_chunked``.  The kernel
(``csrc/ssd_scan.cu``) gives one block to each (batch, head) and runs
the chunks in order with the ``(P, N)`` state resident in shared
memory; see its header for the design.  A sequence length that is not a
multiple of ``chunk`` is handled in the kernel by the reference's own
identity (steps past the end read dt = 0 and zero inputs, and their
output is not stored), so no padded copy is made.

Dispatch is by device: a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.ref.ssd_scan_ref`); a CUDA tensor launches
the kernel or raises.  Both paths refuse what the kernel does not take.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_ref

# Launches of the kernel (one per wrapper call on CUDA).
launches = 0

DTYPES = (torch.float32, torch.bfloat16)
RT = 64                    # rows of the Q x Q product built at a time
MAX_SMEM = 232_448         # bytes of shared memory a block can opt into


def smem_bytes(q: int, p: int, n: int) -> int:
    """Shared memory of one block (``ssd::smem_floats`` in the source)."""
    return 4 * (q * p + q * (n + 1) + p * (n + 1) + RT * (n + 1)
                + RT * (q + 1) + 2 * q)


def _check_inputs(x, dt, A, B, C, chunk, init_state) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan: x dtype {x.dtype} not in {DTYPES}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError("ssd_scan: B and C must have x's dtype")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("ssd_scan: dt and A must be float32")
    if dt.shape != (b, s, h) or A.shape != (h,):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)} / A "
                         f"{tuple(A.shape)} do not match x")
    if B.dim() != 3 or B.shape[:2] != (b, s) or C.shape != B.shape:
        raise ValueError(f"ssd_scan: B {tuple(B.shape)} / C "
                         f"{tuple(C.shape)} must be (B, S, N)")
    n = B.shape[-1]
    if init_state is not None and (init_state.shape != (b, h, p, n) or
                                   init_state.dtype != torch.float32):
        raise ValueError("ssd_scan: init_state must be float32 "
                         f"{(b, h, p, n)}")
    if chunk < 1 or smem_bytes(chunk, p, n) > MAX_SMEM:
        raise ValueError(f"ssd_scan: chunk {chunk} with P={p}, N={n} "
                         f"needs {smem_bytes(chunk, p, n)} bytes of "
                         f"shared memory, over {MAX_SMEM}")
    devs = {t.device for t in (x, dt, A, B, C)} | (
        set() if init_state is None else {init_state.device})
    if len(devs) != 1:
        raise ValueError("ssd_scan: tensors on different devices")


def _unit_last(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def launch(lib, x, dt, A, B, C, init, y, fin, *, chunk: int,
           stream) -> int:
    """Call ``ssd_scan_launch`` of ``lib`` on checked tensors (x, B, C
    unit-stride in their last axis; A, init, y and fin contiguous);
    returns the C entry point's error code."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    strides = (ctypes.c_longlong * 10)(
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        B.stride(0), B.stride(1), C.stride(0), C.stride(1))
    fn = lib.ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    return fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
              C.data_ptr(), None if init is None else init.data_ptr(),
              y.data_ptr(), fin.data_ptr(), ctypes.addressof(strides),
              b, s, h, p, n, chunk, int(x.dtype == torch.bfloat16), stream)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``repro.models.ssm.ssd_chunked``.

    x: (B, S, H, P)  dt: (B, S, H) f32  A: (H,) f32  B/C: (B, S, N)
    Returns (y: (B, S, H, P) in x's dtype, final_state: (B, H, P, N) f32).
    """
    global launches
    _check_inputs(x, dt, A, B, C, chunk, init_state)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk=chunk,
                            init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    x, B, C = _unit_last(x), _unit_last(B), _unit_last(C)
    init = None if init_state is None else init_state.contiguous()
    b, s, h, p = x.shape
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    fin = torch.empty((b, h, p, B.shape[-1]), dtype=torch.float32,
                      device=x.device)
    if b * h == 0:
        return y, fin
    rc = launch(_build.library("ssd_scan"), x, dt, A.contiguous(), B, C,
                init, y, fin, chunk=chunk,
                stream=torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "ssd_scan launch")
    launches += 1
    return y, fin
