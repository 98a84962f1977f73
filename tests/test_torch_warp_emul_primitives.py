"""The tag match and the cell scan's warp primitives, run from their
CUDA source on the CPU (``_warp_emul``): the ``tat_lookup`` kernel
against its plain version, the emulation of __clz and __reduce_or_sync
and the chain's warp helpers against their definitions, the chain's
commit-latency sum against the eager ``chain.xla_sum``, and
``wg::split_parts``."""
from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import _warp_emul as we
from _warp_emul import CSRC, EMUL
from repro_torch.kernels.ref import tat_lookup_ref


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return we.build(tmp_path_factory.mktemp("warp_emul"),
                    (we.cell_scan_source("none"),
                     ("tat_lookup", "tat_lookup", we.TAT_LOOKUP_LAUNCH)))


@pytest.mark.parametrize("r,n", [(256, 16), (1024, 256), (8, 16), (37, 5)])
def test_emulated_tat_lookup_equals_plain(libs, r, n):
    rng = np.random.default_rng(r * 7 + n)
    req, tat, st = (torch.tensor(rng.integers(lo, hi, k), dtype=torch.int32)
                    for lo, hi, k in ((0, 2 * n, r), (0, 2 * n, n),
                                      (0, 3, n)))
    idx = torch.empty(r, dtype=torch.int32)
    out = torch.empty(r, dtype=torch.int32)
    fn = libs["tat_lookup"].tat_lookup_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    assert fn(req.data_ptr(), tat.data_ptr(), st.data_ptr(), idx.data_ptr(),
              out.data_ptr(), r, n, 1, None) == 0
    want = tat_lookup_ref(req, tat, st)
    assert torch.equal(idx, want[0]) and torch.equal(out, want[1])



@pytest.mark.parametrize("seed", range(4))
def test_emulated_warp_primitives(libs, seed):
    """The emulation of __clz and __reduce_or_sync, and the chain's
    tat_first_each (the lowest live slot with the lane's tag, or -1),
    nth_set_bit and tat_first_key (the least key over the warp), against
    their definitions."""
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 12, 32).astype(np.int32)
    tag = rng.integers(0, 12, 64).astype(np.int32)
    live = (rng.random(64) < 0.5).astype(np.int32)
    masks = rng.integers(1, 1 << 32, 32, dtype=np.uint64).astype(np.uint32)
    masks[:3] = (1, 1 << 31, 0)
    ks = np.array([rng.integers(0, max(bin(int(m)).count("1"), 1))
                   for m in masks], np.int32)
    keys = np.where(rng.random(32) < 0.7, 0x7fffffff,
                    rng.integers(0, 3 << 8, 32)).astype(np.int32)
    ored = np.zeros(32, np.uint32)
    clz, first, nth, least = (np.zeros(32, np.int32) for _ in range(4))
    fn = libs["cell_scan"].warp_primitives
    fn.argtypes = [ctypes.c_void_p] * 11
    fn(*(a.ctypes.data for a in (req, tag, live, masks, ks, keys, clz,
                                 ored, first, nth, least)))
    assert (ored == np.bitwise_or.reduce(masks)).all()
    assert (least == keys.min()).all()
    for lane in range(32):
        assert clz[lane] == 32 - int(masks[lane]).bit_length()
        hits = [s for s in range(64) if live[s] and tag[s] == req[lane]]
        assert first[lane] == (hits[0] if hits else -1)
        bits = [b for b in range(32) if int(masks[lane]) >> b & 1]
        if bits:
            assert nth[lane] == bits[ks[lane]]


@pytest.mark.parametrize("q", [9, 32, 48, 64, 80, 130, 384])
def test_emulated_chunk_sum_equals_xla_sum(libs, q):
    """The kernel's commit-latency sum adds a batch's addends in the
    order of the eager ``chain.xla_sum`` (the reference's XLA order)."""
    from repro_torch.core.engine.chain import xla_sum
    fn = libs["cell_scan"].chunk_sum
    fn.restype = ctypes.c_double
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    rng = np.random.default_rng(q)
    for _ in range(50):
        v = rng.standard_normal(q) * 10.0 ** rng.integers(-3, 8, q)
        v[rng.random(q) < 0.5] = 0.0
        pos = np.flatnonzero(v).astype(np.int32)
        vals = np.ascontiguousarray(v[pos])
        got = fn(q, len(pos), pos.ctypes.data, vals.ctypes.data)
        assert got == float(xla_sum(torch.tensor(v))), q


@pytest.mark.parametrize("parts", [2, 3])
def test_split_parts_exact(tmp_path, parts):
    """``wg::split_parts`` (csrc/wgmma_tile.cuh): the first part is the
    value rounded to bf16 (as torch rounds), each part rounds what the
    parts before it left, three parts give back every f32 down to 2^-110
    exactly (below, within half of bf16's smallest subnormal, 2^-134)
    and two parts to 2^-17 relative; +-0 keeps its sign."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the emulated kernels")
    cpp = tmp_path / "split.cpp"
    cpp.write_text(f'#include "{EMUL / "cuda_emul.h"}"\n'
                   f'#include "{EMUL / "hopper.cuh"}"\n'
                   f'#include "{CSRC / "wgmma_tile.cuh"}"\n' + we.SPLIT_LAUNCH)
    so = tmp_path / "libsplit.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", f"-I{EMUL}", "-o", str(so),
                    str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    a = we.split_values()
    out = np.zeros(a.size // 2 * parts, np.uint32)
    lib.split_parts_n.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int]
    lib.split_parts_n(a.ctypes.data, out.ctypes.data, a.size, parts)
    words = out.reshape(-1, parts)
    # part s of value 2i is the low half of word s, of value 2i + 1 the high
    halves = np.stack([words & 0xFFFF, words >> 16], axis=1)  # (n/2, 2, P)
    bits = halves.reshape(-1, parts).astype(np.uint32) << 16
    p = bits.view(np.float32).astype(np.float64)             # (n, parts)
    hi = torch.from_numpy(a).bfloat16().float().numpy()
    assert np.array_equal(p[:, 0].astype(np.float32).view(np.uint32),
                          hi.view(np.uint32))
    total = p.sum(axis=1)
    err = np.abs(total - a.astype(np.float64))
    if parts == 3:
        big = np.abs(a) >= 2.0 ** -110
        assert np.all(err[big] == 0)
        assert np.all(err[~big] <= 2.0 ** -134)
    else:
        assert np.all(err <= 2.0 ** -17 * np.abs(a.astype(np.float64))
                      + 2.0 ** -134)
    zero = a == 0
    assert np.array_equal(np.signbit(p[zero, 0]), np.signbit(a[zero]))

