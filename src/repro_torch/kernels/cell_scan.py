"""Cell-scan kernel: the timed engine's issue-time merge loop on the GPU.

Replaces the reference's ``repro/core/engine/step.py::scan_cell`` — a
``lax.scan`` under ``jit(vmap(vmap))`` (``repro/core/engine/grid.py``),
the TPU hot path of the simulator (not a Pallas kernel).  Its plain
version is the eager :func:`repro_torch.core.engine.step.scan_cell`.

``csrc/cell_scan.cu`` runs one block of one warp per (trace, config)
cell and every cell of a grid in one launch; the scheme is read per
cell.  The carry lives in shared memory; lanes own PBE slots, and every
``argmin`` is a warp reduction that breaks ties to the lowest index.
The PB lookups call the ``tat_lookup`` kernel's match routine
(``csrc/tat_match.cuh``).  What bounds it: each cell is a chain of
dependent steps (up to 379 029 for the paper's cholesky at
``persist_budget=100_000``), so the kernel is latency bound — one step
costs a few dependent shared-memory round trips, and the paper grid of
21 cells keeps at most 21 of the H100's 132 SMs busy.

Dispatch is by device: CPU tensors run the plain version cell by cell;
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import _build

# Config scalars the depth-1 engine reads, in the kernel's column order
# (csrc/cell_scan.cu, enum ScKey).
SC_KEYS = ("n_pbe", "n_tenants", "threshold_count", "preset_count",
           "drain_scope", "victim_weighted", "low_water", "empty_slack",
           "tag_ns", "data_ns", "pbc_proc_ns", "pbc_occ_ns", "pbc_read_ns",
           "pbc_read_occ", "nvm_read", "nvm_write", "nvm_r_occ", "nvm_w_occ",
           "dram_ns", "fwd_margin", "switch_pipe", "ow_cpu_pm", "ow_cpu_sw1",
           "ow_sw1_pm", "lat_target", "lat_tol", "crash_at")
# Per-tenant rows, (len(TENANT_KEYS), T) per config.
TENANT_KEYS = ("quota", "share", "t_threshold", "t_preset")

MAX_PBE = 128           # 4 slots per lane
MAX_CORES = 1024
MAX_TENANTS = 127       # int8 owner column
MAX_BANKS = 32          # one PM bank per lane

launches = 0


class CellScanOut(NamedTuple):
    """Per-cell outputs (N cells)."""

    runtime: torch.Tensor      # (N,)  f64
    stats: torch.Tensor        # (N, T, N_STATS) f64
    hop_stats: torch.Tensor    # (N, 1, N_HOP_STATS) f64
    durable_ver: torch.Tensor  # (N, A) i32
    n_recov: torch.Tensor      # (N,)  f64
    recov_ns: torch.Tensor     # (N,)  f64
    recov_t: torch.Tensor      # (N, T) f64
    steps: torch.Tensor        # (N,)  i64 executed (valid) steps
    lookups: torch.Tensor      # (N,)  i64 match-routine calls (kernel only;
                               #       0 on the plain path)


def pack_configs(scs: Sequence[dict], n_tenants_max: int, device):
    """Stack per-config ``scalars_from_config`` dicts into the kernel's
    ``(K, len(SC_KEYS))`` and ``(K, len(TENANT_KEYS), T)`` f64 tables."""
    sc_table = torch.stack([torch.stack([sc[k].reshape(()) for k in SC_KEYS])
                            for sc in scs]).to(device)
    ten_table = torch.stack([
        torch.stack([sc[k].reshape(n_tenants_max) for k in TENANT_KEYS])
        for sc in scs]).to(device)
    return sc_table, ten_table


def _config_view(sc_table, ten_table, j):
    row = {k: sc_table[j, i] for i, k in enumerate(SC_KEYS)}
    row.update({k: ten_table[j, i] for i, k in enumerate(TENANT_KEYS)})
    return row


def cell_scan_ref(ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
                  sc_table, ten_table, *, max_pbe, pm_banks, n_track,
                  n_tenants_max) -> CellScanOut:
    """Plain version: the eager ``scan_cell`` over every cell in turn."""
    from repro_torch.core.engine.step import scan_cell
    rows = []
    for tr, cf in zip(cell_trace.tolist(), cell_cfg.tolist()):
        rows.append(scan_cell(
            ops[tr], addrs[tr], gaps[tr], lengths[tr], int(schemes[cf]),
            _config_view(sc_table, ten_table, cf), max_pbe=max_pbe,
            pm_banks=pm_banks, n_track=n_track, n_tenants_max=n_tenants_max))
    dev = ops.device

    def col(k, dtype=None):
        return torch.stack([torch.as_tensor(r[k], device=dev) for r in rows]
                           ).to(dtype or torch.float64)
    return CellScanOut(
        runtime=col(0), stats=col(1), hop_stats=col(6),
        durable_ver=col(2, torch.int32), n_recov=col(3), recov_ns=col(4),
        recov_t=col(5), steps=col(9, torch.int64),
        lookups=torch.zeros((len(rows),), dtype=torch.int64, device=dev))


def _check(ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
           sc_table, ten_table, max_pbe, pm_banks, n_track, n_tenants_max):
    K, C, L = ops.shape
    want = dict(ops=(ops, torch.int32, (K, C, L)),
                addrs=(addrs, torch.int32, (K, C, L)),
                gaps=(gaps, torch.float32, (K, C, L)),
                lengths=(lengths, torch.int32, (K, C)),
                schemes=(schemes, torch.int32, (sc_table.shape[0],)),
                sc_table=(sc_table, torch.float64,
                          (sc_table.shape[0], len(SC_KEYS))),
                ten_table=(ten_table, torch.float64,
                           (sc_table.shape[0], len(TENANT_KEYS),
                            n_tenants_max)),
                cell_trace=(cell_trace, torch.int32, cell_trace.shape),
                cell_cfg=(cell_cfg, torch.int32, cell_trace.shape))
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"cell_scan: {name} must be {dtype} of shape "
                             f"{tuple(shape)}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != ops.device:
            raise ValueError(f"cell_scan: {name} is on {x.device}, ops on "
                             f"{ops.device}")
    if not 1 <= max_pbe <= MAX_PBE:
        raise ValueError(f"cell_scan: max_pbe={max_pbe} outside [1, "
                         f"{MAX_PBE}]")
    if not 1 <= C <= MAX_CORES:
        raise ValueError(f"cell_scan: {C} cores outside [1, {MAX_CORES}]")
    if not 1 <= n_tenants_max <= MAX_TENANTS:
        raise ValueError(f"cell_scan: n_tenants_max={n_tenants_max} outside "
                         f"[1, {MAX_TENANTS}]")
    if not 1 <= pm_banks <= MAX_BANKS:
        raise ValueError(f"cell_scan: pm_banks={pm_banks} outside [1, "
                         f"{MAX_BANKS}]")
    if n_track < 0:
        raise ValueError("cell_scan: n_track must be >= 0")


def cell_scan(ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
              sc_table, ten_table, *, max_pbe: int, pm_banks: int,
              n_track: int, n_tenants_max: int) -> CellScanOut:
    """Run cells ``k = 0..N-1``: trace ``cell_trace[k]`` of the stacked
    ``(K, C, L)`` traces under config ``cell_cfg[k]`` of the packed
    tables (:func:`pack_configs`)."""
    global launches
    _check(ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
           sc_table, ten_table, max_pbe, pm_banks, n_track, n_tenants_max)
    kw = dict(max_pbe=max_pbe, pm_banks=pm_banks, n_track=n_track,
              n_tenants_max=n_tenants_max)
    if ops.device.type == "cpu":
        return cell_scan_ref(ops, addrs, gaps, lengths, cell_trace,
                             cell_cfg, schemes, sc_table, ten_table, **kw)
    if ops.device.type != "cuda":
        raise ValueError(f"cell_scan: unsupported device {ops.device}")
    ins = [x.contiguous() for x in (ops, addrs, gaps, lengths, cell_trace,
                                    cell_cfg, schemes, sc_table, ten_table)]
    out = _empty_out(cell_trace.shape[0], n_tenants_max, max(n_track, 1),
                     ops.device)
    if cell_trace.shape[0] > 0:
        rc = launch(_build.library("cell_scan"), ins, out, max_pbe=max_pbe,
                    pm_banks=pm_banks, n_track=n_track,
                    stream=torch.cuda.current_stream(ops.device).cuda_stream)
        _build.check(rc, "cell_scan launch")
        launches += 1
    return out


def _empty_out(N, T, A, dev) -> CellScanOut:
    from repro_torch.core.engine.state import N_HOP_STATS, N_STATS

    def empty(shape, dtype=torch.float64):
        return torch.empty(shape, dtype=dtype, device=dev)
    return CellScanOut(
        runtime=empty((N,)), stats=empty((N, T, N_STATS)),
        hop_stats=empty((N, 1, N_HOP_STATS)),
        durable_ver=empty((N, A), torch.int32), n_recov=empty((N,)),
        recov_ns=empty((N,)), recov_t=empty((N, T)),
        steps=empty((N,), torch.int64), lookups=empty((N,), torch.int64))


def launch(lib, ins, out: CellScanOut, *, max_pbe, pm_banks, n_track,
           stream) -> int:
    """Call ``cell_scan_launch`` of ``lib`` on contiguous inputs ``ins``
    (the order of :func:`cell_scan`'s tensor arguments) and the
    preallocated ``out``; returns the C entry point's error code."""
    from repro_torch.core.engine.state import LAT_BIN_EDGES
    ops = ins[0]
    _, C, L = ops.shape
    N, T, A = out.recov_t.shape[0], out.recov_t.shape[1], \
        out.durable_ver.shape[1]
    edges = torch.tensor(LAT_BIN_EDGES, dtype=torch.float64,
                         device=ops.device)
    aver = torch.empty((N, A), dtype=torch.int32, device=ops.device)
    # the kernel's argument order: inputs, bin edges, outputs, then the
    # issued-version scratch ``aver``
    ptrs = list(ins) + [edges] + list(out) + [aver]
    fn = lib.cell_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    return fn(*[x.data_ptr() for x in ptrs], N, C, L, max_pbe, pm_banks, A,
              T, n_track, stream)


