"""The CUDA kernels' own source, run on the CPU against the plain versions.

There is no ``nvcc`` on a CPU-only machine, but the bodies of
``csrc/tat_lookup.cu`` and ``csrc/cell_scan.cu`` are plain C++ apart
from a handful of CUDA constructs.  ``warp_emul/cuda_emul.h`` supplies
those for g++ (one warp = 32 threads, intrinsics through a barrier), so
the kernels' logic — warp reductions, lane-owned slots, the
read-then-write phases — is checked here against the plain versions
with the wrappers' own launch code.  The card itself is checked by
``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as P
from repro_torch.core.engine import grid
from repro_torch.kernels import cell_scan as cs
from repro_torch.kernels import tat_lookup as tl
from repro_torch.kernels.ref import tat_lookup_ref

CSRC = Path(tl.__file__).resolve().parent / "csrc"
EMUL = Path(__file__).resolve().parent / "warp_emul"

CELL_SCAN_LAUNCH = r'''
alignas(16) unsigned char smem_raw[1 << 20];
extern "C" int cell_scan_launch(
    const int* ops, const int* addrs, const float* gaps, const int* lengths,
    const int* cell_trace, const int* cell_cfg, const int* schemes,
    const double* sc_table, const double* ten_table,
    const double* lat_edges, double* runtime, double* stats,
    double* hop_stats, int* durable_ver, double* n_recov,
    double* recov_ns, double* recov_t, long long* steps, long long* lookups,
    int* aver, int n_cells, int C, int L, int P, int B, int A, int T,
    int n_track, cudaStream_t) {
  Args a{ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
         sc_table, ten_table, lat_edges, runtime, stats, hop_stats,
         durable_ver, n_recov, recov_ns, recov_t, steps, lookups, aver,
         C, L, P, B, A, T, n_track};
  Smem m;
  if (carve(m, nullptr, C, P, B, T) > sizeof(smem_raw)) return 1;
  emu_run(n_cells, [&] { cell_scan_kernel(a); });
  return 0;
}
'''

TAT_LOOKUP_LAUNCH = r'''
int table[1 << 16];
extern "C" int tat_lookup_launch(const int* req, const int* tat,
                                 const int* states, int* out_idx,
                                 int* out_state, int r, int n, int,
                                 cudaStream_t) {
  if (2 * n > (1 << 16)) return 1;
  emu_run((r + 31) / 32, [&] {
    tat_lookup_kernel(req, tat, states, out_idx, out_state, r, n);
  });
  return 0;
}
'''


def _emulated_source(name: str, launcher: str) -> str:
    src = (CSRC / f"{name}.cu").read_text()
    body = src.split("// ---- host entry point")[0]
    body = body.replace("#include <cuda_runtime.h>",
                        f'#include "{EMUL / "cuda_emul.h"}"')
    body = body.replace('#include "tat_match.cuh"',
                        f'#include "{CSRC / "tat_match.cuh"}"')
    return body + launcher


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the emulated kernels")
    out = tmp_path_factory.mktemp("warp_emul")
    loaded = {}
    for name, launcher in (("cell_scan", CELL_SCAN_LAUNCH),
                           ("tat_lookup", TAT_LOOKUP_LAUNCH)):
        cpp = out / f"{name}.cpp"
        cpp.write_text(_emulated_source(name, launcher))
        so = out / f"lib{name}.so"
        subprocess.run([gxx, "-std=c++20", "-O2", "-ffp-contract=off",
                        "-fPIC", "-shared", "-pthread", "-o", str(so),
                        str(cpp)], check=True, capture_output=True)
        loaded[name] = ctypes.CDLL(str(so))
    return loaded


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


def _cases():
    S = P.Scheme
    fz = [P.fuzz_trace(seed, n_cores=4, n_slots=100, n_tenants=2)[0]
          for seed in range(2)]
    pols = [P.PBPolicy(alloc=P.AllocPolicy(victim="weighted")),
            P.PBPolicy(alloc=P.AllocPolicy(tenant_quota=(3, 5))),
            P.PBPolicy(drain=P.DrainPolicy(per_tenant=True,
                                           latency_target_ns=300.0))]
    small = [P.make_trace(n, persist_budget=50)
             for n in ("radiosity", "lu_cont")]
    return {
        "schemes": (small, [P.PCSConfig(scheme=s) for s in S], 0),
        "crash": (small, [P.PCSConfig(scheme=s).with_crash(t)
                          for s in S for t in (4e3, 9e3)], 16),
        "tenants": (fz, [P.PCSConfig(scheme=s, n_pbe=8, n_tenants=2,
                                     policy=p)
                         for s in (S.PB, S.PB_RF) for p in pols]
                    + [P.PCSConfig(scheme=S.PB_RF, n_pbe=8, n_tenants=2,
                                   crash_at_ns=2.5e7)], 8),
        "slots": (small[:1], [P.PCSConfig(scheme=s, n_pbe=n, pm_banks=3)
                              for s in (S.PB, S.PB_RF)
                              for n in (1, 33, 128)], 0),
    }


@pytest.mark.parametrize("case", ["schemes", "crash", "tenants", "slots"])
def test_emulated_cell_scan_equals_eager_scan_cell(libs, case):
    traces, configs, track = _cases()[case]
    pairs = [(i, j) for i in range(len(traces)) for j in range(len(configs))]
    args, kw = grid.cell_inputs(traces, configs, [p[0] for p in pairs],
                                [p[1] for p in pairs], track_addrs=track)
    want = cs.cell_scan(*args, **kw)
    got = cs._empty_out(len(pairs), kw["n_tenants_max"], max(track, 1),
                        "cpu")
    assert cs.launch(libs["cell_scan"], list(args), got,
                     max_pbe=kw["max_pbe"], pm_banks=kw["pm_banks"],
                     n_track=track, stream=None) == 0
    for f in cs.CellScanOut._fields:
        if f != "lookups":
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.lookups.sum()) > 0
