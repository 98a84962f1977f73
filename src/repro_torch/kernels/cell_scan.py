"""Cell-scan kernel: the timed engine's issue-time merge loop on the GPU.

Replaces the reference's ``repro/core/engine/step.py::scan_cell`` — a
``lax.scan`` under ``jit(vmap(vmap))`` (``repro/core/engine/grid.py``),
the TPU hot path of the simulator (not a Pallas kernel).  Its plain
version is the eager :func:`repro_torch.core.engine.step.scan_cell`.

``csrc/cell_scan.cu`` runs one block of one warp per (trace, config)
cell and every cell of a grid in one launch; the scheme is read per
cell.  Switch chains of up to ``MAX_DEEP + 1`` switches run through the
deep-hop rows of the kernel's ``D = n_deep_max`` instantiation; a deeper
grid raises.  The carry lives in shared memory; lanes own PBE slots, and every
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

# Config scalars the engine reads, in the kernel's column order
# (csrc/cell_scan.cu, enum ScKey).
SC_KEYS = ("n_pbe", "n_tenants", "threshold_count", "preset_count",
           "drain_scope", "victim_weighted", "low_water", "empty_slack",
           "tag_ns", "data_ns", "pbc_proc_ns", "pbc_occ_ns", "pbc_read_ns",
           "pbc_read_occ", "nvm_read", "nvm_write", "nvm_r_occ", "nvm_w_occ",
           "dram_ns", "fwd_margin", "switch_pipe", "ow_cpu_pm", "ow_cpu_sw1",
           "ow_sw1_pm", "lat_target", "lat_tol", "crash_at")
# Per-tenant rows, (len(TENANT_KEYS), T) per config.
TENANT_KEYS = ("quota", "share", "t_threshold", "t_preset")
# The switch chain: per-config scalars, then one row of D1 = max(n_deep,
# 1) values per deep-hop key (row j of each = switch j+2), flat in one
# (len(CHAIN_KEYS) + len(DEEP_KEYS) * D1,) row per config (enum ChKey).
CHAIN_KEYS = ("n_switches", "hop_ns", "link_ns")
DEEP_KEYS = ("deep_pbe", "deep_thr", "deep_pre", "deep_tag", "deep_data")

MAX_PBE = 128           # 4 slots per lane
MAX_CORES = 1024
MAX_TENANTS = 127       # int8 owner column
MAX_BANKS = 32          # one PM bank per lane
MAX_DEEP = 3            # deep-hop rows: switch chains up to 4 switches

launches = 0


class CellScanOut(NamedTuple):
    """Per-cell outputs (N cells)."""

    runtime: torch.Tensor      # (N,)  f64
    stats: torch.Tensor        # (N, T, N_STATS) f64
    hop_stats: torch.Tensor    # (N, D + 1, N_HOP_STATS) f64
    durable_ver: torch.Tensor  # (N, A) i32
    n_recov: torch.Tensor      # (N,)  f64
    recov_ns: torch.Tensor     # (N,)  f64
    recov_t: torch.Tensor      # (N, T) f64
    recov_h: torch.Tensor      # (N, D + 1) f64 survivors per hop
    steps: torch.Tensor        # (N,)  i64 executed (valid) steps
    lookups: torch.Tensor      # (N,)  i64 match-routine calls (kernel only;
                               #       0 on the plain path)


def pack_configs(scs: Sequence[dict], n_tenants_max: int, device):
    """Stack per-config ``scalars_from_config`` dicts into the kernel's
    ``(K, len(SC_KEYS))``, ``(K, len(TENANT_KEYS), T)`` and
    ``(K, len(CHAIN_KEYS) + len(DEEP_KEYS) * D1)`` f64 tables."""
    sc_table = torch.stack([torch.stack([sc[k].reshape(()) for k in SC_KEYS])
                            for sc in scs]).to(device)
    ten_table = torch.stack([
        torch.stack([sc[k].reshape(n_tenants_max) for k in TENANT_KEYS])
        for sc in scs]).to(device)
    chain_table = torch.stack([
        torch.cat([torch.stack([sc[k].reshape(()) for k in CHAIN_KEYS])]
                  + [sc[k].reshape(-1) for k in DEEP_KEYS])
        for sc in scs]).to(device)
    return sc_table, ten_table, chain_table


def _config_view(sc_table, ten_table, chain_table, j):
    row = {k: sc_table[j, i] for i, k in enumerate(SC_KEYS)}
    row.update({k: ten_table[j, i] for i, k in enumerate(TENANT_KEYS)})
    row.update({k: chain_table[j, i] for i, k in enumerate(CHAIN_KEYS)})
    deep = chain_table[j, len(CHAIN_KEYS):].reshape(len(DEEP_KEYS), -1)
    row.update({k: deep[i] for i, k in enumerate(DEEP_KEYS)})
    return row


def cell_scan_ref(ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
                  sc_table, ten_table, chain_table, *, max_pbe, pm_banks,
                  n_track, n_tenants_max, n_deep_max=0) -> CellScanOut:
    """Plain version: the eager ``scan_cell`` over every cell in turn."""
    from repro_torch.core.engine.step import scan_cell
    rows = []
    for tr, cf in zip(cell_trace.tolist(), cell_cfg.tolist()):
        rows.append(scan_cell(
            ops[tr], addrs[tr], gaps[tr], lengths[tr], int(schemes[cf]),
            _config_view(sc_table, ten_table, chain_table, cf),
            max_pbe=max_pbe, pm_banks=pm_banks, n_track=n_track,
            n_tenants_max=n_tenants_max, n_deep_max=n_deep_max))
    dev = ops.device

    def col(k, dtype=None):
        return torch.stack([torch.as_tensor(r[k], device=dev) for r in rows]
                           ).to(dtype or torch.float64)
    return CellScanOut(
        runtime=col(0), stats=col(1), hop_stats=col(6),
        durable_ver=col(2, torch.int32), n_recov=col(3), recov_ns=col(4),
        recov_t=col(5), recov_h=col(7), steps=col(9, torch.int64),
        lookups=torch.zeros((len(rows),), dtype=torch.int64, device=dev))


def _check(ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
           sc_table, ten_table, chain_table, max_pbe, pm_banks, n_track,
           n_tenants_max, n_deep_max):
    K, C, L = ops.shape
    n_chain = len(CHAIN_KEYS) + len(DEEP_KEYS) * max(n_deep_max, 1)
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
                chain_table=(chain_table, torch.float64,
                             (sc_table.shape[0], n_chain)),
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
    if not 0 <= n_deep_max <= MAX_DEEP:
        raise ValueError(f"cell_scan: n_deep_max={n_deep_max} outside [0, "
                         f"{MAX_DEEP}]: the kernel takes switch chains of "
                         f"up to {MAX_DEEP + 1} switches")


def cell_scan(ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
              sc_table, ten_table, chain_table, *, max_pbe: int,
              pm_banks: int, n_track: int, n_tenants_max: int,
              n_deep_max: int = 0) -> CellScanOut:
    """Run cells ``k = 0..N-1``: trace ``cell_trace[k]`` of the stacked
    ``(K, C, L)`` traces under config ``cell_cfg[k]`` of the packed
    tables (:func:`pack_configs`), with ``n_deep_max`` deep-hop rows."""
    global launches
    _check(ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
           sc_table, ten_table, chain_table, max_pbe, pm_banks, n_track,
           n_tenants_max, n_deep_max)
    kw = dict(max_pbe=max_pbe, pm_banks=pm_banks, n_track=n_track,
              n_tenants_max=n_tenants_max, n_deep_max=n_deep_max)
    if ops.device.type == "cpu":
        return cell_scan_ref(ops, addrs, gaps, lengths, cell_trace,
                             cell_cfg, schemes, sc_table, ten_table,
                             chain_table, **kw)
    if ops.device.type != "cuda":
        raise ValueError(f"cell_scan: unsupported device {ops.device}")
    ins = [x.contiguous() for x in (ops, addrs, gaps, lengths, cell_trace,
                                    cell_cfg, schemes, sc_table, ten_table,
                                    chain_table)]
    out = _empty_out(cell_trace.shape[0], n_tenants_max, max(n_track, 1),
                     n_deep_max, ops.device)
    if cell_trace.shape[0] > 0:
        rc = launch(_build.library("cell_scan"), ins, out, max_pbe=max_pbe,
                    pm_banks=pm_banks, n_track=n_track, n_deep=n_deep_max,
                    stream=torch.cuda.current_stream(ops.device).cuda_stream)
        _build.check(rc, "cell_scan launch")
        launches += 1
    return out


def _empty_out(N, T, A, D, dev) -> CellScanOut:
    from repro_torch.core.engine.state import N_HOP_STATS, N_STATS

    def empty(shape, dtype=torch.float64):
        return torch.empty(shape, dtype=dtype, device=dev)
    return CellScanOut(
        runtime=empty((N,)), stats=empty((N, T, N_STATS)),
        hop_stats=empty((N, D + 1, N_HOP_STATS)),
        durable_ver=empty((N, A), torch.int32), n_recov=empty((N,)),
        recov_ns=empty((N,)), recov_t=empty((N, T)), recov_h=empty((N, D + 1)),
        steps=empty((N,), torch.int64), lookups=empty((N,), torch.int64))


def launch(lib, ins, out: CellScanOut, *, max_pbe, pm_banks, n_track,
           n_deep, stream) -> int:
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
    # the kernel's argument order: the depth-1 inputs, bin edges, the
    # depth-1 outputs, the issued-version scratch ``aver``, then the
    # chain's table and per-hop survivors
    ptrs = list(ins[:9]) + [edges] + [out.runtime, out.stats, out.hop_stats,
                                      out.durable_ver, out.n_recov,
                                      out.recov_ns, out.recov_t, out.steps,
                                      out.lookups, aver, ins[9], out.recov_h]
    fn = lib.cell_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    rc = fn(*[x.data_ptr() for x in ptrs], N, C, L, max_pbe, pm_banks, A,
            T, n_track, n_deep, stream)
    if rc == 0 and n_deep == 0:
        # without a chain the one hop's survivors are the recovery count
        out.recov_h[:, 0].copy_(out.n_recov)
    return rc
