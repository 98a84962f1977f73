"""``tat_lookup``: batched fully-associative PB tag match (CUDA port).

Replaces the Pallas kernel ``repro/kernels/tat_lookup.py::tat_lookup_pallas``
(body ``_kernel``).  Per request tag, the first table entry with an
equal tag and a non-Empty state wins: ``(idx or -1, state or 0)``.

The CUDA kernel (``csrc/tat_lookup.cu``) gives one warp to a block of
requests with the tag and state table staged in shared memory; the
match routine (``csrc/tat_match.cuh``) sweeps the table in 32-entry
tiles with ``__ballot_sync`` and takes the lowest set bit (``__ffs``),
so the lowest index wins as in the Pallas ``argmax``.  The same routine
is the cell-scan kernel's PB lookup.  The work is a few integer compares
per (request, entry) pair over a table that fits in shared memory, so
the kernel is bound by the bytes it moves (requests in, two outputs out).

Dispatch is by device: a CPU tensor takes the plain version
(:func:`~repro_torch.kernels.ref.tat_lookup_ref`); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import tat_lookup_ref

# Launches of the kernel (one per wrapper call on CUDA).
launches = 0

MAX_TABLE = 4096        # entries staged in shared memory (32 KiB)
WARPS_PER_BLOCK = 4


def _check_inputs(req_tags, tat, states) -> None:
    for name, x in (("req_tags", req_tags), ("tat", tat),
                    ("states", states)):
        if x.dtype != torch.int32 or x.dim() != 1:
            raise ValueError(f"tat_lookup: {name} must be a 1-d int32 "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
    if tat.shape != states.shape:
        raise ValueError("tat_lookup: tat and states differ in shape")
    if not (req_tags.device == tat.device == states.device):
        raise ValueError("tat_lookup: tensors on different devices")


def tat_lookup(req_tags: torch.Tensor, tat: torch.Tensor,
               states: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R,) int32 requests against an (N,) int32 table -> (idx, state)."""
    global launches
    _check_inputs(req_tags, tat, states)
    if req_tags.device.type == "cpu":
        return tat_lookup_ref(req_tags, tat, states)
    if req_tags.device.type != "cuda":
        raise ValueError(f"tat_lookup: unsupported device {req_tags.device}")
    n = tat.shape[0]
    if not 1 <= n <= MAX_TABLE:
        raise ValueError(f"tat_lookup: table size {n} outside [1, "
                         f"{MAX_TABLE}] (the table is staged in shared "
                         "memory)")
    req_tags, tat, states = (x.contiguous() for x in (req_tags, tat, states))
    r = req_tags.shape[0]
    idx = torch.empty((r,), dtype=torch.int32, device=req_tags.device)
    st = torch.empty((r,), dtype=torch.int32, device=req_tags.device)
    if r == 0:
        return idx, st
    lib = _build.library("tat_lookup")
    fn = lib.tat_lookup_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    rc = fn(req_tags.data_ptr(), tat.data_ptr(), states.data_ptr(),
            idx.data_ptr(), st.data_ptr(), r, n, WARPS_PER_BLOCK,
            torch.cuda.current_stream(req_tags.device).cuda_stream)
    _build.check(rc, "tat_lookup launch")
    launches += 1
    return idx, st
