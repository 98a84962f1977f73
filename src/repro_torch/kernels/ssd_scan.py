"""``ssd_scan``: Mamba2 SSD chunked scan (CUDA port).

Replaces the Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan_pallas``
(body ``_kernel``) and takes the initial state of the function it stands
for, ``repro.models.ssm.ssd_chunked``.  A sequence length that is not a
multiple of ``chunk`` is handled in the kernels by the reference's own
identity (steps past the end read dt = 0 and zero inputs, and their
output is not stored), so no padded copy is made.

The route is fixed before launch by the dtype and the shape (``ROUTES``;
:func:`route`):

* **the tensor-core kernel** (``csrc/ssd_scan_tc.cu``) for bf16 (entry
  ``ssd_scan_tc_launch``) and f32 (``ssd_scan_tc_f32_launch``) at chunk
  64 or 128 with P <= 64 and N <= 128, multiples of 8 (:func:`tc_takes`):
  blocks over (batch, chunk, head), every product on ``wgmma`` with f32
  accumulation, only the f32 carry chained from chunk to chunk.  f32
  operands enter the products as two bf16 parts each (the source's
  Precision note), which holds the f32 tolerance of 1e-3;
* **the FMA kernel** (``csrc/ssd_scan.cu``) for every other f32 shape
  whose chunk fits its shared memory: one block per (batch, head)
  walking its chunks, f32 products on the FMA units.

See the sources' headers for their designs.  Each route counts its
launches (``launches_tc`` for both tensor-core entries,
``launches_fma``; ``launches`` is their sum).  A dtype or shape that no
route takes raises (a bf16 shape outside the tensor-core limits, an f32
chunk too large for the FMA kernel); a failed build or launch raises
too, and nothing falls back to another route or to the plain version.
x, B and C may be strided views with a unit-stride last axis (the model
passes slices of its conv output); the tensor-core kernel reads 16-byte
chunks, so its inputs' other strides must be multiples of 16 bytes and
their data 16-byte aligned, and an input that is not gets a contiguous
copy first.

Dispatch is by device: a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.ref.ssd_scan_ref`); a CUDA tensor launches
its route's kernel or raises.  Both paths refuse what the kernels do
not take.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_ref

# Launches per route (one per wrapper call on CUDA), and their sum.
launches = 0
launches_tc = 0
launches_fma = 0

# A route: the kernel's library (csrc/<lib>.cu) and its C entry point.
TC_BF16 = ("ssd_scan_tc", "ssd_scan_tc_launch")
TC_F32 = ("ssd_scan_tc", "ssd_scan_tc_f32_launch")
FMA_F32 = ("ssd_scan", "ssd_scan_launch")
# dtype -> (route where tc_takes(chunk, P, N), route otherwise or None)
ROUTES = {torch.bfloat16: (TC_BF16, None), torch.float32: (TC_F32, FMA_F32)}
DTYPES = tuple(ROUTES)
RT = 64                    # FMA kernel: rows of the Q x Q product at a time
MAX_SMEM = 232_448         # bytes of shared memory a block can opt into
TC_CHUNKS = (64, 128)      # tensor-core kernel: one or two warpgroups
TC_MAX_P, TC_MAX_N = 64, 128


def tc_takes(chunk: int, p: int, n: int) -> bool:
    """Whether the tensor-core kernel takes this chunk, P and N."""
    return chunk in TC_CHUNKS and p % 8 == 0 and 8 <= p <= TC_MAX_P \
        and n % 8 == 0 and 8 <= n <= TC_MAX_N


def route(dtype: torch.dtype, chunk: int, p: int, n: int):
    """The (library, entry) that serves ``dtype`` at this chunk, P and N,
    or None."""
    tc, other = ROUTES[dtype]
    return tc if tc_takes(chunk, p, n) else other


def smem_bytes(q: int, p: int, n: int) -> int:
    """Shared memory of one FMA block (``ssd::smem_floats`` in the
    source)."""
    return 4 * (q * p + q * (n + 1) + p * (n + 1) + RT * (n + 1)
                + RT * (q + 1) + 2 * q)


def _check_route(dtype, p: int, n: int, chunk: int) -> None:
    r = route(dtype, chunk, p, n)
    if r is None:
        raise ValueError(
            f"ssd_scan: the bf16 kernel takes chunk in {TC_CHUNKS}, "
            f"P <= {TC_MAX_P} and N <= {TC_MAX_N} (multiples of 8), "
            f"got chunk {chunk}, P={p}, N={n}")
    if r == FMA_F32 and (chunk < 1 or smem_bytes(chunk, p, n) > MAX_SMEM):
        raise ValueError(f"ssd_scan: chunk {chunk} with P={p}, N={n} "
                         f"needs {smem_bytes(chunk, p, n)} bytes of "
                         f"shared memory, over {MAX_SMEM}")


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
    _check_route(x.dtype, p, n, chunk)
    devs = {t.device for t in (x, dt, A, B, C)} | (
        set() if init_state is None else {init_state.device})
    if len(devs) != 1:
        raise ValueError("ssd_scan: tensors on different devices")


def _unit_last(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _for_copies(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the tensor-core kernel's 16-byte reads can take it (unit
    last stride, other strides multiples of 16 bytes, data 16-byte
    aligned), else a contiguous copy."""
    per = 16 // x.element_size()
    if x.stride(-1) == 1 and all(st % per == 0 for st in x.stride()[:-1]) \
            and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _strides(x, dt, B, C):
    return (ctypes.c_longlong * 10)(
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        B.stride(0), B.stride(1), C.stride(0), C.stride(1))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch(lib, x, dt, A, B, C, init, y, fin, *, chunk: int,
           stream) -> int:
    """Call ``ssd_scan_launch`` (the FMA kernel) of ``lib`` on checked f32
    tensors (x, B, C unit-stride in their last axis; A, init, y and fin
    contiguous); returns the C entry point's error code."""
    b, s, h, p = x.shape
    strides = _strides(x, dt, B, C)
    fn = lib.ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    return fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
              C.data_ptr(), _ptr(init), y.data_ptr(), fin.data_ptr(),
              ctypes.addressof(strides), b, s, h, p, B.shape[-1], chunk,
              stream)


def sync_buffer(x: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel's zeroed ticket and per-(batch, head) chunk
    flags for an ``x`` of shape (B, S, H, P)."""
    return torch.zeros(1 + x.shape[0] * x.shape[2], dtype=torch.int32,
                       device=x.device)


def launch_tc(lib, x, dt, A, B, C, init, y, fin, sync, *, chunk: int,
              stream) -> int:
    """Call the tensor-core kernel's entry for x's dtype
    (``ssd_scan_tc_launch`` bf16, ``ssd_scan_tc_f32_launch`` f32) of
    ``lib`` on checked tensors that :func:`_for_copies` accepts (A, init,
    y and fin contiguous; ``sync`` from :func:`sync_buffer`, zeroed for
    each call; ``fin`` doubles as the chunk-to-chunk carry); returns the
    C entry point's error code."""
    b, s, h, p = x.shape
    strides = _strides(x, dt, B, C)
    fn = getattr(lib, (TC_F32 if x.dtype == torch.float32 else TC_BF16)[1])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    return fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
              C.data_ptr(), _ptr(init), y.data_ptr(), fin.data_ptr(),
              sync.data_ptr(), ctypes.addressof(strides), b, s, h, p,
              B.shape[-1], chunk, stream)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``repro.models.ssm.ssd_chunked``.

    x: (B, S, H, P)  dt: (B, S, H) f32  A: (H,) f32  B/C: (B, S, N)
    Returns (y: (B, S, H, P) in x's dtype, final_state: (B, H, P, N) f32).
    """
    global launches, launches_tc, launches_fma
    _check_inputs(x, dt, A, B, C, chunk, init_state)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk=chunk,
                            init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    name, entry = route(x.dtype, chunk, x.shape[-1], B.shape[-1])
    tc = name == "ssd_scan_tc"
    prep = _for_copies if tc else _unit_last
    x, B, C = prep(x), prep(B), prep(C)
    init = None if init_state is None else init_state.contiguous()
    b, s, h, p = x.shape
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    fin = torch.empty((b, h, p, B.shape[-1]), dtype=torch.float32,
                      device=x.device)
    if b * h == 0:
        return y, fin
    if tc and s == 0:               # no chunk: the state passes through
        return y, (fin.zero_() if init is None else fin.copy_(init))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.library(name)
    A = A.contiguous()
    if tc:
        rc = launch_tc(lib, x, dt, A, B, C, init, y, fin, sync_buffer(x),
                       chunk=chunk, stream=stream)
    else:
        rc = launch(lib, x, dt, A, B, C, init, y, fin, chunk=chunk,
                    stream=stream)
    _build.check(rc, entry)
    if tc:
        launches_tc += 1
    else:
        launches_fma += 1
    launches += 1
    return y, fin
