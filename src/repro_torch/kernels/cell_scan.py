"""Cell-scan kernel: the timed engine's issue-time merge loop on the GPU.

Replaces the reference's ``repro/core/engine/step.py::scan_cell`` — a
``lax.scan`` under ``jit(vmap(vmap))`` (``repro/core/engine/grid.py``),
the TPU hot path of the simulator (not a Pallas kernel).  Its plain
version is the eager :func:`repro_torch.core.engine.step.scan_cell`.

``csrc/cell_scan.cu`` runs one block of one warp per (trace, config)
cell and every cell of a grid in one launch; the scheme is read per
cell.  Switch chains of up to ``MAX_DEEP + 1`` switches run through the
deep-hop rows of the kernel's ``D = n_deep_max`` instantiation, a grid
that holds a fan-out fabric of up to ``MAX_LEAVES`` leaves through its
``FAB`` instantiation (leaf windows, per-leaf PBC clocks, spine
backpressure, per-leaf recovery), and a grid that holds a ``Schedule``
of up to ``MAX_EPOCHS`` epochs through its ``EP`` instantiation (each
op sees the rows of the epoch its issue time falls in, copied from the
epoch table when that epoch changes); a deeper, wider or longer grid
raises.  With macro-steps on (``macro=True``) its ``MAC``
instantiation also counts, exactly as the eager ``scan_cell`` does, the
trace slots run as macro-steps and the aborted live windows by reason
(``engine/macro.py``): it collapses dead post-crash runs for real, and
decides each live window's commit or abort by replaying the window's
clocks and guard on a scratch copy, while the state itself advances slot
by slot (a committed window's ops are the next steps of its core, bit
for bit the same).  The carry lives in shared memory; lanes own PBE slots, and
every ``argmin`` is a warp reduction that breaks ties to the lowest
index.
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

from repro_torch.core.engine.state import epoch_rows
from repro_torch.core.params import MACRO_KMAX
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
# The fabric: per-config scalars, then the NL1 = max(n_leaves_max, 1)
# leaf bases and the T tenants' leaves, flat in one
# (len(FAB_KEYS) + NL1 + T,) row per config (enum FabKey).
FAB_KEYS = ("n_leaves", "bp_high")
# Epoch schedules: per config and epoch, the rows a Schedule may change
# (state.EPOCH_KEYS), flat in one (E, len(EPOCH_SC_KEYS) + len(TENANT_KEYS)
# * T + 2 * D1 + T) block (enum EpKey): these scalars, the tenant rows,
# deep_thr and deep_pre, the tenants' leaves; beside it the config's
# E - 1 epoch bounds.  The other tables hold epoch 0's rows.
EPOCH_SC_KEYS = ("threshold_count", "preset_count", "lat_target")
EPOCH_DEEP_KEYS = ("deep_thr", "deep_pre")

MAX_PBE = 128           # 4 slots per lane
MAX_CORES = 1024
MAX_TENANTS = 127       # int8 owner column
MAX_BANKS = 32          # one PM bank per lane
MAX_DEEP = 3            # deep-hop rows: switch chains up to 4 switches
MAX_LEAVES = 32         # fabric leaves (per-leaf clocks and survivors)
MAX_EPOCHS = 8          # schedule epochs

N_REASONS = 6           # engine/macro.py MACRO_ABORT_REASONS
# The MAC instantiation's op words carry the run plan above the op code
# (csrc/cell_scan.cu OPS_MLEN_SHIFT), so a head's window gate reads the
# word the step reads anyway.
OPS_MLEN_SHIFT = 8

launches = 0
# launches per instantiation of cell_scan_kernel<SPL, D, FAB, EP, MAC>
# (:func:`instantiation`), counted where ``launches`` is
launches_by: dict = {}


def instantiation(max_pbe: int, n_deep: int, n_leaves: int,
                  n_epochs: int, macro: bool) -> tuple:
    """The ``(SPL, D, FAB, EP, MAC)`` of the kernel a grid launches: the
    fewest slots a lane that hold ``max_pbe`` (1, 2 or 4), its deep-hop
    rows, whether it holds a multi-leaf fabric, whether a schedule, and
    whether it runs macro-steps (csrc/cell_scan.cu, cell_scan_launch)."""
    spl = 1 if max_pbe <= 32 else (2 if max_pbe <= 64 else 4)
    return spl, n_deep, n_leaves > 1, n_epochs > 1, bool(macro)


# Every instantiation cell_scan_launch can dispatch to: SPL 1, 2, 4 x
# (D = 0, and D = 1..MAX_DEEP with FAB both ways) x EP both ways x MAC
# both ways.
INSTANTIATIONS = tuple((spl, d, fab, ep, mac) for spl in (1, 2, 4)
                       for d in range(MAX_DEEP + 1)
                       for fab in ((False, True) if d else (False,))
                       for ep in (False, True) for mac in (False, True))


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
    recov_l: torch.Tensor      # (N, NL1) f64 hop-1 survivors per leaf
    steps: torch.Tensor        # (N,)  i64 trace slots consumed
    lookups: torch.Tensor      # (N,)  i64 match-routine calls (kernel only;
                               #       0 on the plain path)
    macro_ops: torch.Tensor    # (N,)  i64 trace slots run as macro-steps
    macro_aborts: torch.Tensor  # (N, N_REASONS) i64 aborted live windows
                                #       per reason (0 with macro off)


def pack_ops(ops: torch.Tensor, mlen: torch.Tensor) -> torch.Tensor:
    """The MAC kernel's op words: each op code (``ops``, int32) with the
    run plan's length (``mlen``, int8, ``core.traces.plan_runs``) in the
    bits from ``OPS_MLEN_SHIFT`` up."""
    return ops | (mlen.to(torch.int32) << OPS_MLEN_SHIFT)


def pack_configs(scs: Sequence[dict], n_tenants_max: int, device):
    """Stack per-config ``scalars_from_config`` dicts into the kernel's
    ``(K, len(SC_KEYS))``, ``(K, len(TENANT_KEYS), T)``,
    ``(K, len(CHAIN_KEYS) + len(DEEP_KEYS) * D1)`` and
    ``(K, len(FAB_KEYS) + NL1 + T)`` f64 tables (epoch 0's rows), then
    the ``(K, E, len(EPOCH_SC_KEYS) + len(TENANT_KEYS) * T + 2 * D1 +
    T)`` epoch table and the ``(K, E - 1)`` epoch bounds (``E = 1``
    without a schedule: the bounds are empty and the kernel never reads
    either)."""
    E = scs[0]["epoch_bounds"].shape[0] + 1 if "epoch_bounds" in scs[0] \
        else 1
    ep_table = torch.stack([torch.stack([
        torch.cat([torch.stack([r[k].reshape(()) for k in EPOCH_SC_KEYS])]
                  + [r[k].reshape(-1) for k in TENANT_KEYS + EPOCH_DEEP_KEYS]
                  + [r["leaf_of_t"].reshape(-1)])
        for r in (epoch_rows(sc, e) for e in range(E))]) for sc in scs]
    ).to(device)
    ep_bounds = torch.stack([
        sc["epoch_bounds"] if E > 1 else torch.zeros(0, dtype=torch.float64)
        for sc in scs]).to(device)
    scs = [epoch_rows(sc, 0) for sc in scs]
    sc_table = torch.stack([torch.stack([sc[k].reshape(()) for k in SC_KEYS])
                            for sc in scs]).to(device)
    ten_table = torch.stack([
        torch.stack([sc[k].reshape(n_tenants_max) for k in TENANT_KEYS])
        for sc in scs]).to(device)
    chain_table = torch.stack([
        torch.cat([torch.stack([sc[k].reshape(()) for k in CHAIN_KEYS])]
                  + [sc[k].reshape(-1) for k in DEEP_KEYS])
        for sc in scs]).to(device)
    fab_table = torch.stack([
        torch.cat([torch.stack([sc[k].reshape(()) for k in FAB_KEYS]),
                   sc["leaf_base"].reshape(-1),
                   sc["leaf_of_t"].reshape(n_tenants_max)])
        for sc in scs]).to(device)
    return sc_table, ten_table, chain_table, fab_table, ep_table, ep_bounds


def _config_view(sc_table, ten_table, chain_table, fab_table, ep_table,
                 ep_bounds, j):
    """Config ``j``'s ``scalars_from_config`` dict, from the tables."""
    row = {k: sc_table[j, i] for i, k in enumerate(SC_KEYS)}
    row.update({k: ten_table[j, i] for i, k in enumerate(TENANT_KEYS)})
    row.update({k: chain_table[j, i] for i, k in enumerate(CHAIN_KEYS)})
    deep = chain_table[j, len(CHAIN_KEYS):].reshape(len(DEEP_KEYS), -1)
    row.update({k: deep[i] for i, k in enumerate(DEEP_KEYS)})
    row.update({k: fab_table[j, i] for i, k in enumerate(FAB_KEYS)})
    nl1 = fab_table.shape[1] - len(FAB_KEYS) - ten_table.shape[2]
    row["leaf_base"] = fab_table[j, len(FAB_KEYS):len(FAB_KEYS) + nl1]
    row["leaf_of_t"] = fab_table[j, len(FAB_KEYS) + nl1:]
    if ep_bounds.shape[1] > 0:
        # the epoch rows, each with its leading (E,) axis, and the bounds
        T, D1 = ten_table.shape[2], deep.shape[1]
        ep, o = ep_table[j], len(EPOCH_SC_KEYS)
        row.update({k: ep[:, i] for i, k in enumerate(EPOCH_SC_KEYS)})
        for k in TENANT_KEYS:
            row[k], o = ep[:, o:o + T], o + T
        for k in EPOCH_DEEP_KEYS:
            row[k], o = ep[:, o:o + D1], o + D1
        row["leaf_of_t"] = ep[:, o:o + T]
        row["epoch_bounds"] = ep_bounds[j]
    return row


def cell_scan_ref(ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
                  sc_table, ten_table, chain_table, fab_table, ep_table,
                  ep_bounds, mlen, *, max_pbe, pm_banks, n_track,
                  n_tenants_max, n_deep_max=0, n_leaves_max=1,
                  macro=False) -> CellScanOut:
    """Plain version: the eager ``scan_cell`` over every cell in turn."""
    from repro_torch.core.engine.step import scan_cell
    rows = []
    for tr, cf in zip(cell_trace.tolist(), cell_cfg.tolist()):
        rows.append(scan_cell(
            ops[tr], addrs[tr], gaps[tr], lengths[tr], int(schemes[cf]),
            _config_view(sc_table, ten_table, chain_table, fab_table,
                         ep_table, ep_bounds, cf),
            max_pbe=max_pbe, pm_banks=pm_banks, n_track=n_track,
            n_tenants_max=n_tenants_max, n_deep_max=n_deep_max,
            n_leaves_max=n_leaves_max, mlen=mlen[tr], macro=macro))
    dev = ops.device

    def col(k, dtype=None):
        return torch.stack([torch.as_tensor(r[k], device=dev) for r in rows]
                           ).to(dtype or torch.float64)
    return CellScanOut(
        runtime=col(0), stats=col(1), hop_stats=col(6),
        durable_ver=col(2, torch.int32), n_recov=col(3), recov_ns=col(4),
        recov_t=col(5), recov_h=col(7), recov_l=col(8),
        steps=col(9, torch.int64),
        lookups=torch.zeros((len(rows),), dtype=torch.int64, device=dev),
        macro_ops=col(10, torch.int64), macro_aborts=col(11, torch.int64))


def _check(ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
           sc_table, ten_table, chain_table, fab_table, ep_table, ep_bounds,
           mlen, max_pbe, pm_banks, n_track, n_tenants_max, n_deep_max,
           n_leaves_max, macro):
    K, C, L = ops.shape
    n_chain = len(CHAIN_KEYS) + len(DEEP_KEYS) * max(n_deep_max, 1)
    n_fab = len(FAB_KEYS) + max(n_leaves_max, 1) + n_tenants_max
    E = ep_table.shape[1] if ep_table.dim() == 3 else 0
    n_ep = len(EPOCH_SC_KEYS) + len(TENANT_KEYS) * n_tenants_max \
        + len(EPOCH_DEEP_KEYS) * max(n_deep_max, 1) + n_tenants_max
    want = dict(ops=(ops, torch.int32, (K, C, L)),
                addrs=(addrs, torch.int32, (K, C, L)),
                gaps=(gaps, torch.float32, (K, C, L)),
                lengths=(lengths, torch.int32, (K, C)),
                mlen=(mlen, torch.int8, (K, C, L)),
                schemes=(schemes, torch.int32, (sc_table.shape[0],)),
                sc_table=(sc_table, torch.float64,
                          (sc_table.shape[0], len(SC_KEYS))),
                ten_table=(ten_table, torch.float64,
                           (sc_table.shape[0], len(TENANT_KEYS),
                            n_tenants_max)),
                chain_table=(chain_table, torch.float64,
                             (sc_table.shape[0], n_chain)),
                fab_table=(fab_table, torch.float64,
                           (sc_table.shape[0], n_fab)),
                ep_table=(ep_table, torch.float64,
                          (sc_table.shape[0], E, n_ep)),
                ep_bounds=(ep_bounds, torch.float64,
                           (sc_table.shape[0], max(E - 1, 0))),
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
    if not 1 <= n_leaves_max <= MAX_LEAVES:
        raise ValueError(f"cell_scan: n_leaves_max={n_leaves_max} outside "
                         f"[1, {MAX_LEAVES}]: the kernel takes fabrics of "
                         f"up to {MAX_LEAVES} leaves")
    if n_leaves_max > 1 and n_deep_max < 1:
        raise ValueError("cell_scan: a fabric grid needs its spine's deep "
                         "row (n_deep_max >= 1)")
    if not 1 <= E <= MAX_EPOCHS:
        raise ValueError(f"cell_scan: {E} epochs outside [1, {MAX_EPOCHS}]: "
                         f"the kernel takes schedules of up to {MAX_EPOCHS} "
                         f"epochs")
    if macro and K and C and int(lengths.max()) + MACRO_KMAX > L:
        raise ValueError(f"cell_scan: macro-steps read {MACRO_KMAX} trace "
                         f"slots past a stream; the trace axis L={L} must "
                         f"carry them past the longest stream")


def cell_scan(ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
              sc_table, ten_table, chain_table, fab_table, ep_table,
              ep_bounds, mlen, *, max_pbe: int, pm_banks: int, n_track: int,
              n_tenants_max: int, n_deep_max: int = 0,
              n_leaves_max: int = 1, macro: bool = False) -> CellScanOut:
    """Run cells ``k = 0..N-1``: trace ``cell_trace[k]`` of the stacked
    ``(K, C, L)`` traces under config ``cell_cfg[k]`` of the packed
    tables (:func:`pack_configs`), with ``n_deep_max`` deep-hop rows,
    ``n_leaves_max`` fabric leaves and the epoch table's ``E`` epochs;
    ``macro`` runs the macro-steps over the ``(K, C, L)`` int8 run plan
    ``mlen`` (``core.traces.plan_runs``), whose windows need the trace
    axis to carry ``MACRO_KMAX`` slots past every stream."""
    global launches
    _check(ops, addrs, gaps, lengths, cell_trace, cell_cfg, schemes,
           sc_table, ten_table, chain_table, fab_table, ep_table, ep_bounds,
           mlen, max_pbe, pm_banks, n_track, n_tenants_max, n_deep_max,
           n_leaves_max, macro)
    kw = dict(max_pbe=max_pbe, pm_banks=pm_banks, n_track=n_track,
              n_tenants_max=n_tenants_max, n_deep_max=n_deep_max,
              n_leaves_max=n_leaves_max, macro=macro)
    if ops.device.type == "cpu":
        return cell_scan_ref(ops, addrs, gaps, lengths, cell_trace,
                             cell_cfg, schemes, sc_table, ten_table,
                             chain_table, fab_table, ep_table, ep_bounds,
                             mlen, **kw)
    if ops.device.type != "cuda":
        raise ValueError(f"cell_scan: unsupported device {ops.device}")
    ins = [x.contiguous() for x in (ops, addrs, gaps, lengths, cell_trace,
                                    cell_cfg, schemes, sc_table, ten_table,
                                    chain_table, fab_table, ep_table,
                                    ep_bounds, mlen)]
    out = _empty_out(cell_trace.shape[0], n_tenants_max, max(n_track, 1),
                     n_deep_max, ops.device, n_leaves_max)
    if cell_trace.shape[0] > 0:
        rc = launch(_build.library("cell_scan"), ins, out, max_pbe=max_pbe,
                    pm_banks=pm_banks, n_track=n_track, n_deep=n_deep_max,
                    n_leaves=n_leaves_max, macro=macro,
                    stream=torch.cuda.current_stream(ops.device).cuda_stream)
        _build.check(rc, "cell_scan launch")
        launches += 1
        key = instantiation(max_pbe, n_deep_max, n_leaves_max,
                            ep_table.shape[1], macro)
        launches_by[key] = launches_by.get(key, 0) + 1
    return out


def _empty_out(N, T, A, D, dev, n_leaves=1) -> CellScanOut:
    from repro_torch.core.engine.state import N_HOP_STATS, N_STATS

    def empty(shape, dtype=torch.float64):
        return torch.empty(shape, dtype=dtype, device=dev)
    return CellScanOut(
        runtime=empty((N,)), stats=empty((N, T, N_STATS)),
        hop_stats=empty((N, D + 1, N_HOP_STATS)),
        durable_ver=empty((N, A), torch.int32), n_recov=empty((N,)),
        recov_ns=empty((N,)), recov_t=empty((N, T)), recov_h=empty((N, D + 1)),
        recov_l=empty((N, max(n_leaves, 1))),
        steps=empty((N,), torch.int64), lookups=empty((N,), torch.int64),
        macro_ops=empty((N,), torch.int64),
        macro_aborts=empty((N, N_REASONS), torch.int64))


def launch(lib, ins, out: CellScanOut, *, max_pbe, pm_banks, n_track,
           n_deep, stream, n_leaves=1, macro=False) -> int:
    """Call ``cell_scan_launch`` of ``lib`` on contiguous inputs ``ins``
    (the order of :func:`cell_scan`'s tensor arguments) and the
    preallocated ``out``; returns the C entry point's error code.
    ``n_leaves > 1`` (the grid holds a multi-leaf fabric) launches the
    kernel's fabric instantiation, an epoch table of ``E > 1`` epochs
    (``ins[11]``; the grid holds a schedule) its epoch one, and
    ``macro`` its macro-step one."""
    from repro_torch.core.engine.state import LAT_BIN_EDGES
    ops = ins[0]
    _, C, L = ops.shape
    N, T, A = out.recov_t.shape[0], out.recov_t.shape[1], \
        out.durable_ver.shape[1]
    edges = torch.tensor(LAT_BIN_EDGES, dtype=torch.float64,
                         device=ops.device)
    aver = torch.empty((N, A), dtype=torch.int32, device=ops.device)
    # the kernel's argument order: the depth-1 inputs (with macro-steps
    # on, the op words carry the run plan, ``ins[13]``: pack_ops), bin
    # edges, the depth-1 outputs, the issued-version scratch ``aver``, the
    # chain's table and per-hop survivors, the fabric's table and per-leaf
    # survivors, the epoch table and bounds, then the macro counters
    words = pack_ops(ops, ins[13]) if macro else ops
    ptrs = [words] + list(ins[1:9]) + [edges] + [
        out.runtime, out.stats, out.hop_stats, out.durable_ver, out.n_recov,
        out.recov_ns, out.recov_t, out.steps, out.lookups, aver, ins[9],
        out.recov_h, ins[10], out.recov_l, ins[11], ins[12], out.macro_ops,
        out.macro_aborts]
    fn = lib.cell_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p]
    if not macro:               # only the MAC instantiation writes them
        out.macro_ops.zero_()
        out.macro_aborts.zero_()
    rc = fn(*[x.data_ptr() for x in ptrs], N, C, L, max_pbe, pm_banks, A,
            T, n_track, n_deep, n_leaves, ins[11].shape[1], int(macro),
            stream)
    if rc == 0 and n_deep == 0:
        # without a chain the one hop's survivors are the recovery count
        out.recov_h[:, 0].copy_(out.n_recov)
    if rc == 0 and n_leaves <= 1:
        # without a fabric hop 1 is the one leaf
        out.recov_l[:, 0].copy_(out.recov_h[:, 0])
    return rc
