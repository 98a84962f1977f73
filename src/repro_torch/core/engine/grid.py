"""Batched (trace x config x scheme) front-end and compatibility wrappers.

``simulate_grid`` runs a whole evaluation grid through one cell-scan
launch on CUDA (``repro_torch.kernels.cell_scan``): traces are stacked
into one shared ``(K, C, L)`` block (padded cores get zero-length
streams), configs are lowered by ``scalars_from_config`` and packed into
per-config tables with the scheme id beside them, and the kernel runs
one cell per block.  Mixed schemes in one grid are first-class.  On the
CPU the same wrapper runs the eager ``scan_cell`` cell by cell.

``simulate_cells`` is the flat variant (one result per (trace, config)
pair); ``simulate`` and ``simulate_sweep`` are thin wrappers over the
same path.

Scope of the port so far: switch chains (up to the kernel's
``MAX_DEEP + 1`` switches), no fabric, one schedule epoch and no
macro-stepping.  Configs outside it raise ``NotImplementedError``.
Entry points run on CUDA unless the caller passes ``device="cpu"``, and
raise where there is no CUDA.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.engine.state import (SimResult, result_from_stats,
                                           scalars_from_config)
from repro_torch.core.params import PCSConfig
from repro_torch.core.traces import Trace
from repro_torch.device import resolve_device
from repro_torch.kernels import cell_scan as cs

_BUCKET = 16384


def check_scope(configs: Sequence[PCSConfig], macro: bool) -> None:
    """Reject what this slice of the port does not run (yet)."""
    if macro:
        raise NotImplementedError(
            "macro-stepping is not ported; run with macro=False (results "
            "are identical)")
    for c in configs:
        if c.fabric is not None:
            raise NotImplementedError("fabric topologies are not ported")
        if c.n_epochs > 1:
            raise NotImplementedError("Schedule knobs are not ported")


def _stack_traces(traces: Sequence[Trace]):
    """Pad traces into one shared (C, L) block and stack them."""
    C = max(t.ops.shape[0] for t in traces)
    L = max(max(t.ops.shape[1] for t in traces), 1)
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
    return ops, addrs, gaps, lengths


def cell_inputs(traces, configs, cell_trace, cell_cfg, *, max_pbe=None,
                track_addrs=0, device="cpu"):
    """The cell-scan wrapper's arguments for cells ``k``: trace
    ``traces[cell_trace[k]]`` under config ``configs[cell_cfg[k]]``.

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
    scs = [scalars_from_config(c, n_tenants_max, n_deep) for c in configs]
    sc_table, ten_table, chain_table = cs.pack_configs(scs, n_tenants_max,
                                                       device)
    ops, addrs, gaps, lengths = (torch.from_numpy(a).to(device)
                                 for a in _stack_traces(traces))
    schemes = torch.tensor([int(c.scheme) for c in configs],
                           dtype=torch.int32, device=device)

    def idx(v):
        return torch.tensor(list(v), dtype=torch.int32, device=device)
    args = (ops, addrs, gaps, lengths, idx(cell_trace), idx(cell_cfg),
            schemes, sc_table, ten_table, chain_table)
    return args, dict(max_pbe=max_pbe, pm_banks=banks.pop(),
                      n_track=track_addrs, n_tenants_max=n_tenants_max,
                      n_deep_max=n_deep)


def _run(traces, configs, cell_trace, cell_cfg, *, max_pbe, track_addrs,
         device):
    args, kw = cell_inputs(traces, configs, cell_trace, cell_cfg,
                           max_pbe=max_pbe, track_addrs=track_addrs,
                           device=device)
    out = cs.cell_scan(*args, **kw)
    host = cs.CellScanOut(*(x.cpu().numpy() for x in out))
    results = []
    for k, j in enumerate(cell_cfg):
        cfg = configs[j]
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
            hop_recovery=host.recov_h[k]))
    return results


def simulate_grid(traces: Sequence[Trace], configs: Sequence[PCSConfig], *,
                  max_pbe: int | None = None,
                  bucket: int = _BUCKET,
                  track_addrs: int = 0,
                  macro: bool = False,
                  device=None) -> List[List[SimResult]]:
    """Simulate every (trace, config) cell; one kernel launch on CUDA.

    Returns a ``len(traces) x len(configs)`` nested list of SimResult.
    Schemes may be mixed freely; ``pm_banks`` must agree.  ``bucket`` is
    accepted for signature compatibility with the reference, whose
    shape padding it controls; results never depend on it.
    ``track_addrs > 0`` additionally returns, per cell, the durable
    version vector over addresses ``[0, track_addrs)``.
    """
    check_scope(configs, macro)
    dev = resolve_device(device)
    if not traces or not configs:
        return [[] for _ in traces]
    nt, nc = len(traces), len(configs)
    flat = _run(traces, configs, [i for i in range(nt) for _ in range(nc)],
                [j for _ in range(nt) for j in range(nc)],
                max_pbe=max_pbe, track_addrs=track_addrs, device=dev)
    return [flat[i * nc:(i + 1) * nc] for i in range(nt)]


def simulate_cells(traces: Sequence[Trace], configs: Sequence[PCSConfig], *,
                   max_pbe: int | None = None,
                   bucket: int = _BUCKET,
                   track_addrs: int = 0,
                   macro: bool = False,
                   device=None) -> List[SimResult]:
    """Simulate paired cells: ``result[k]`` is (traces[k], configs[k]).

    Repeated Trace objects are stacked once.
    """
    check_scope(configs, macro)
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
                track_addrs=track_addrs, device=dev)


def simulate(trace: Trace, config: PCSConfig,
             max_pbe: int | None = None, *,
             bucket: int = _BUCKET, track_addrs: int = 0,
             macro: bool = False, device=None) -> SimResult:
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
