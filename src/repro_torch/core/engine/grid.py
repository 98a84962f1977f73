"""Batched (trace x config x scheme) front-end and compatibility wrappers.

``simulate_grid`` runs a whole evaluation grid through one cell-scan
launch on CUDA (``repro_torch.kernels.cell_scan``): traces are stacked
into one shared ``(K, C, L)`` block (padded cores get zero-length
streams), configs are lowered by ``scalars_from_config`` and packed into
per-config tables with the scheme id beside them, and the kernel runs
one cell per block.  Mixed schemes in one grid are first-class.  On the
CPU the same wrapper runs the eager ``scan_cell`` cell by cell.

The stacker also runs the macro-run pre-pass (``core.traces.plan_runs``)
and pads the op axis by ``MACRO_KMAX`` slots so a macro-step's window
never reads past a stream; ``macro=True`` (the default, as in the
reference) runs the macro-steps, ``macro=False`` the slot-at-a-time
path alone — the results are identical, and the latest call's
macro telemetry is :func:`last_macro_hit_rate` and
:func:`last_macro_abort_reasons` (on CUDA the kernel's own counters).

``simulate_cells`` is the flat variant (one result per (trace, config)
pair); ``simulate`` and ``simulate_sweep`` are thin wrappers over the
same path.

Scope: switch chains (up to the kernel's ``MAX_DEEP + 1`` switches),
fan-out fabrics (up to the kernel's ``MAX_LEAVES`` leaves) and epoch
schedules (``Schedule`` knobs, a fabric placement included; up to the
kernel's ``MAX_EPOCHS`` epochs).
Entry points run on CUDA unless the caller passes ``device="cpu"``, and
raise where there is no CUDA.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.engine.macro import MACRO_ABORT_REASONS
from repro_torch.core.engine.state import (SimResult, result_from_stats,
                                           scalars_from_config)
from repro_torch.core.params import MACRO_KMAX, PCSConfig
from repro_torch.core.traces import Trace, plan_runs
from repro_torch.device import resolve_device
from repro_torch.kernels import cell_scan as cs

_BUCKET = 16384

# telemetry of the most recent grid/cells call: macro-executed trace
# slots vs total trace slots, plus the per-reason counts of live macro
# windows that failed to commit (MACRO_ABORT_REASONS order, summed over
# all cells)
_LAST_MACRO = {"macro_ops": 0, "total_ops": 0,
               "abort_reasons": [0] * len(MACRO_ABORT_REASONS)}


def last_macro_hit_rate() -> float:
    """Fraction of trace slots the latest simulate_* call ran via
    macro-steps (0.0 when macro was disabled or nothing ran)."""
    total = _LAST_MACRO["total_ops"]
    return (_LAST_MACRO["macro_ops"] / total) if total else 0.0


def last_macro_abort_reasons() -> dict:
    """Per-reason counts of live macro candidates the latest simulate_*
    call failed to commit, keyed by ``MACRO_ABORT_REASONS`` name (all
    zero when macro was disabled or nothing ran)."""
    return dict(zip(MACRO_ABORT_REASONS, _LAST_MACRO["abort_reasons"]))


def _stack_traces(traces: Sequence[Trace]):
    """Pad traces into one shared (C, L) block and stack them, with the
    macro-run plan beside them.

    The op axis carries ``MACRO_KMAX`` slots past the longest stream
    (zeros, as the reference's padding), so a macro-step's window never
    reads past the block.
    """
    C = max(t.ops.shape[0] for t in traces)
    L = max(t.ops.shape[1] for t in traces) + MACRO_KMAX
    K = len(traces)
    ops = np.zeros((K, C, L), np.int32)
    addrs = np.zeros((K, C, L), np.int32)
    gaps = np.zeros((K, C, L), np.float32)
    lengths = np.zeros((K, C), np.int32)
    for k, t in enumerate(traces):
        c, l = t.ops.shape
        ops[k, :c, :l] = t.ops
        addrs[k, :c, :l] = t.addrs
        gaps[k, :c, :l] = t.gaps
        lengths[k, :c] = t.lengths
    mlen = np.stack([plan_runs(ops[k], addrs[k], gaps[k], MACRO_KMAX)
                     for k in range(K)])
    return ops, addrs, gaps, lengths, mlen


def cell_inputs(traces, configs, cell_trace, cell_cfg, *, max_pbe=None,
                track_addrs=0, macro=True, device="cpu"):
    """The cell-scan wrapper's arguments for cells ``k``: trace
    ``traces[cell_trace[k]]`` under config ``configs[cell_cfg[k]]``,
    macro-steps on or off by ``macro``.

    Returns ``(args, kwargs)`` for :func:`repro_torch.kernels.cell_scan
    .cell_scan`, with every tensor on ``device``.
    """
    max_pbe = max_pbe or max(c.max_hop_pbe for c in configs)
    if any(c.max_hop_pbe > max_pbe for c in configs):
        raise ValueError("n_pbe exceeds max_pbe")
    banks = {c.pm_banks for c in configs}
    if len(banks) != 1:
        raise ValueError("grid configs must share pm_banks (array shape)")
    n_tenants_max = max(c.n_tenants for c in configs)
    # deep-hop rows are a grid-wide shape; only PB-bearing configs need
    # them (a deep NOPB chain is pure wire), and a depth-<=1-only grid
    # carries none (n_deep == 0)
    n_deep = max(max((len(c.hop_pbes) - 1 for c in configs), default=0), 0)
    # so is the fabric's leaf axis: 1 (no multi-leaf fabric in the grid)
    # carries no leaf clock and runs no fabric branch
    n_leaves = max((c.fabric.n_leaves if c.fabric is not None else 1
                    for c in configs), default=1)
    # and the epoch axis: 1 (no Schedule in the grid) lowers no epoch
    # rows; any scheduled config gives every config E rows (a static one
    # repeats its own, its bounds INF)
    n_epochs = max((c.n_epochs for c in configs), default=1)
    scs = [scalars_from_config(c, n_tenants_max, n_deep, n_leaves,
                               n_epochs_max=n_epochs)
           for c in configs]
    tables = cs.pack_configs(scs, n_tenants_max, device)
    ops, addrs, gaps, lengths, mlen = (torch.from_numpy(a).to(device)
                                       for a in _stack_traces(traces))
    schemes = torch.tensor([int(c.scheme) for c in configs],
                           dtype=torch.int32, device=device)

    def idx(v):
        return torch.tensor(list(v), dtype=torch.int32, device=device)
    args = (ops, addrs, gaps, lengths, idx(cell_trace), idx(cell_cfg),
            schemes) + tables + (mlen,)
    return args, dict(max_pbe=max_pbe, pm_banks=banks.pop(),
                      n_track=track_addrs, n_tenants_max=n_tenants_max,
                      n_deep_max=n_deep, n_leaves_max=n_leaves, macro=macro)


def _run(traces, configs, cell_trace, cell_cfg, *, max_pbe, track_addrs,
         macro, device):
    args, kw = cell_inputs(traces, configs, cell_trace, cell_cfg,
                           max_pbe=max_pbe, track_addrs=track_addrs,
                           macro=macro, device=device)
    out = cs.cell_scan(*args, **kw)
    host = cs.CellScanOut(*(x.cpu().numpy() for x in out))
    # the telemetry, from the cells' own counters (the kernel's on CUDA)
    _LAST_MACRO["macro_ops"] = int(host.macro_ops.sum())
    _LAST_MACRO["total_ops"] = int(sum(traces[i].total_ops
                                       for i in cell_trace))
    _LAST_MACRO["abort_reasons"] = [int(x)
                                    for x in host.macro_aborts.sum(0)]
    results = []
    for k, j in enumerate(cell_cfg):
        cfg = configs[j]
        fab = cfg.fabric
        results.append(result_from_stats(
            float(host.runtime[k]), host.stats[k],
            crash_at_ns=cfg.crash_at_ns,
            recovery_entries=int(host.n_recov[k]),
            recovery_ns=float(host.recov_ns[k]),
            durable_ver=(host.durable_ver[k][:track_addrs].copy()
                         if track_addrs > 0 else None),
            n_tenants=cfg.n_tenants,
            tenant_recovery=host.recov_t[k],
            n_hops=len(cfg.hop_pbes),
            hop_stats=host.hop_stats[k],
            hop_recovery=host.recov_h[k],
            n_leaves=fab.n_leaves if fab is not None else 1,
            leaf_recovery=host.recov_l[k]))
    return results


def simulate_grid(traces: Sequence[Trace], configs: Sequence[PCSConfig], *,
                  max_pbe: int | None = None,
                  bucket: int = _BUCKET,
                  track_addrs: int = 0,
                  macro: bool = True,
                  device=None) -> List[List[SimResult]]:
    """Simulate every (trace, config) cell; one kernel launch on CUDA.

    Returns a ``len(traces) x len(configs)`` nested list of SimResult.
    Schemes may be mixed freely; ``pm_banks`` must agree.  ``bucket`` is
    accepted for signature compatibility with the reference, whose
    shape padding it controls; results never depend on it.
    ``track_addrs > 0`` additionally returns, per cell, the durable
    version vector over addresses ``[0, track_addrs)``.  ``macro``
    toggles the guarded macro-steps; results are identical either way.
    """
    dev = resolve_device(device)
    if not traces or not configs:
        return [[] for _ in traces]
    nt, nc = len(traces), len(configs)
    flat = _run(traces, configs, [i for i in range(nt) for _ in range(nc)],
                [j for _ in range(nt) for j in range(nc)],
                max_pbe=max_pbe, track_addrs=track_addrs, macro=macro,
                device=dev)
    return [flat[i * nc:(i + 1) * nc] for i in range(nt)]


def simulate_cells(traces: Sequence[Trace], configs: Sequence[PCSConfig], *,
                   max_pbe: int | None = None,
                   bucket: int = _BUCKET,
                   track_addrs: int = 0,
                   macro: bool = True,
                   device=None) -> List[SimResult]:
    """Simulate paired cells: ``result[k]`` is (traces[k], configs[k]).

    Repeated Trace objects are stacked once.
    """
    dev = resolve_device(device)
    if not traces:
        return []
    if len(traces) != len(configs):
        raise ValueError("simulate_cells wants len(traces) == len(configs)")
    uniq: List[Trace] = []
    index = {}
    for t in traces:
        if id(t) not in index:
            index[id(t)] = len(uniq)
            uniq.append(t)
    return _run(uniq, configs, [index[id(t)] for t in traces],
                list(range(len(configs))), max_pbe=max_pbe,
                track_addrs=track_addrs, macro=macro, device=dev)


def simulate(trace: Trace, config: PCSConfig,
             max_pbe: int | None = None, *,
             bucket: int = _BUCKET, track_addrs: int = 0,
             macro: bool = True, device=None) -> SimResult:
    """Simulate one (trace, config) pair and return aggregate metrics."""
    max_pbe = max_pbe or config.max_hop_pbe
    return simulate_grid([trace], [config], max_pbe=max_pbe,
                         bucket=bucket, track_addrs=track_addrs,
                         macro=macro, device=device)[0][0]


def simulate_sweep(trace: Trace, configs: List[PCSConfig], *,
                   bucket: int = _BUCKET, device=None) -> List[SimResult]:
    """One trace over many configs (Fig. 1 / Fig. 8)."""
    if not configs:
        return []
    return simulate_grid([trace], configs, bucket=bucket, device=device)[0]
