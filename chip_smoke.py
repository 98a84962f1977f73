#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

It imports only ``repro_torch`` (never JAX or the ``repro`` package),
builds the port's kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch/``, and runs four phases, each printing its own
lines:

1. the card (``nvidia-smi`` name and power limit), the kernel build, and
   the latency of one dependent shared-memory load (``smem_probe.cu``),
   the unit of the cell scan's latency bound;
2. the ``tat_lookup`` kernel against its plain version on the card, at
   the Pallas test sweep's shapes and the engine's (R=8, N=16), exact;
3. the cell-scan kernel against the eager ``scan_cell`` (run on the
   host) on the 7 workloads x NoPB/PB/PB_RF at ``persist_budget=2000``,
   on PB/PB_RF crash cells with ``track_addrs=64``, and on the shortest
   workload's three cells of the full-size paper grid (the main path's
   own stacked inputs), exact on every output;
4. the main path: ``simulate_grid`` over the paper grid (7 workloads x 3
   schemes, ``persist_budget=100_000``, Table I config) on the card,
   exact against ``src/repro_torch/testdata/paper_grid_ref.json`` (the
   JAX reference's numbers), with the Fig. 5 rows, the kernels' launch
   counts and the calls of the ``tat_lookup`` match routine made inside
   the cell-scan kernel (the standalone ``tat_lookup`` kernel is not
   launched on this path).

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no result; it also refuses to run
without CUDA.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 peak (NVIDIA data sheet)
SCHEME_KEYS = ("pb", "pb_rf")


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def smem_round_trip_ns(torch) -> float:
    """Device time of one dependent shared-memory load (csrc/smem_probe.cu):
    the unit of the cell scan's latency bound."""
    import ctypes
    from repro_torch.kernels import _build
    fn = _build.library("smem_probe").smem_chase_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    iters = 1 << 20

    def run():
        _build.check(fn(iters, out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream),
                     "smem_chase launch")
    return cuda_ms(run, 3) * 1e6 / iters


def phase_tat_lookup(torch, np):
    from repro_torch.kernels import tat_lookup as tl
    from repro_torch.kernels.ref import tat_lookup_ref
    rng = np.random.default_rng(42)
    rows = {}
    for r, n in ((256, 16), (512, 64), (1024, 256), (8, 16)):
        req = torch.tensor(rng.integers(0, n * 2, r), dtype=torch.int32,
                           device="cuda")
        tat = torch.tensor(rng.integers(0, n * 2, n), dtype=torch.int32,
                           device="cuda")
        st = torch.tensor(rng.integers(0, 3, n), dtype=torch.int32,
                          device="cuda")
        i1, s1 = tl.tat_lookup(req, tat, st)
        i2, s2 = tat_lookup_ref(req, tat, st)
        torch.cuda.synchronize()
        if not (torch.equal(i1, i2) and torch.equal(s1, s2)):
            fail(f"tat_lookup kernel != tat_lookup_ref at R={r}, N={n}")
        err = max(int((i1 - i2).abs().max()), int((s1 - s2).abs().max()))
        ms = cuda_ms(lambda: tl.tat_lookup(req, tat, st), 200)
        plain = cuda_ms(lambda: tat_lookup_ref(req, tat, st), 200)
        # bytes the function must move: requests and table in, idx and
        # state out (int32 each)
        bound = (4 * r + 8 * n + 8 * r) / HBM_BYTES_PER_S * 1e3
        rows[(r, n)] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                            max_abs_err=err)
        print(f"phase 2 tat_lookup R={r} N={n}: exact, kernel {ms:.6f} ms, "
              f"plain {plain:.6f} ms, bound {bound:.9f} ms")
    return rows


def compare_outputs(plain, got, what: str) -> float:
    """Exact equality of every cell-scan output but the kernel-only
    lookup counts; returns the max abs difference (0.0)."""
    from repro_torch.kernels.cell_scan import CellScanOut
    err = 0.0
    for f in CellScanOut._fields:
        if f == "lookups":
            continue
        a, b = getattr(plain, f), getattr(got, f).cpu()
        if not torch_equal(a, b):
            fail(f"{what}: cell-scan kernel != eager scan_cell on {f}")
        err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def torch_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def cell_bytes(traces, n_cells: int, T: int, A: int, n_cfg: int) -> float:
    """Bytes the cell scan must move: each trace op (op, addr, gap) and
    stream length read once, the config tables read once, every output
    written once."""
    from repro_torch.core.engine.state import N_HOP_STATS, N_STATS
    from repro_torch.kernels.cell_scan import SC_KEYS, TENANT_KEYS
    inputs = sum(12 * t.total_ops + 4 * t.n_cores for t in traces)
    inputs += 8 * n_cfg * (len(SC_KEYS) + len(TENANT_KEYS) * T) + 4 * n_cfg
    inputs += 8 * n_cells
    outputs = n_cells * (8 + 8 * T * N_STATS + 8 * N_HOP_STATS + 4 * A
                         + 8 + 8 + 8 * T + 8 + 8)
    return float(inputs + outputs)


def phase_cell_scan(torch, smem_ns):
    from repro_torch.core import PCSConfig, Scheme, WORKLOADS, make_trace
    from repro_torch.core.engine.grid import cell_inputs
    from repro_torch.kernels import cell_scan as cs
    names = list(WORKLOADS)
    traces = [make_trace(n, persist_budget=2000) for n in names]
    configs = [PCSConfig(scheme=s) for s in Scheme]
    pairs = [(i, j) for i in range(len(traces)) for j in range(len(configs))]
    args, kw = cell_inputs(traces, configs, [p[0] for p in pairs],
                           [p[1] for p in pairs], device="cpu")
    t0 = time.time()
    plain = cs.cell_scan(*args, **kw)
    plain_ms = (time.time() - t0) * 1e3
    dargs = [a.cuda() for a in args]
    got = cs.cell_scan(*dargs, **kw)
    torch.cuda.synchronize()
    err = compare_outputs(plain, got, "budget-2000 grid")
    ms = cuda_ms(lambda: cs.cell_scan(*dargs, **kw), 3)
    max_steps = int(plain.steps.max())
    bound = cell_bytes(traces, len(pairs), 1, 1, len(configs)) \
        / HBM_BYTES_PER_S * 1e3
    latency_bound = max_steps * smem_ns / 1e6
    print(f"phase 3 cell_scan grid (7 workloads x 3 schemes, budget 2000): "
          f"exact on {len(pairs)} cells, kernel {ms:.3f} ms, eager "
          f"scan_cell {plain_ms:.1f} ms on the host, longest cell "
          f"{max_steps} steps ({ms * 1e6 / max_steps:.1f} ns/step; latency "
          f"bound {latency_bound:.3f} ms at one {smem_ns:.2f} ns "
          f"shared-memory round trip per step)")

    # crash cells: PB / PB_RF on two workloads, three power-loss points
    # each (fractions of the workload's no-crash PB runtime)
    crash_traces, crash_cfgs, cpairs = [], [], []
    for w in ("radiosity", "lu_cont"):
        i = names.index(w)
        t_pb = float(plain.runtime[i * len(configs) + int(Scheme.PB)])
        crash_traces.append(traces[i])
        for s in (Scheme.PB, Scheme.PB_RF):
            for f in (0.25, 0.5, 0.75):
                cpairs.append((len(crash_traces) - 1, len(crash_cfgs)))
                crash_cfgs.append(PCSConfig(scheme=s).with_crash(f * t_pb))
    cargs, ckw = cell_inputs(crash_traces, crash_cfgs,
                             [p[0] for p in cpairs], [p[1] for p in cpairs],
                             track_addrs=64, device="cpu")
    cplain = cs.cell_scan(*cargs, **ckw)
    cgot = cs.cell_scan(*[a.cuda() for a in cargs], **ckw)
    torch.cuda.synchronize()
    err = max(err, compare_outputs(cplain, cgot, "crash cells"))
    print(f"phase 3 cell_scan crash cells: exact on {len(cpairs)} cells "
          f"(durable_ver, recovery_entries {cplain.n_recov.tolist()}, "
          f"recovery_ns)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, max_abs_err=err,
                max_steps=max_steps, latency_bound_ms=latency_bound)


def paper_grid():
    """The main path's traces and configs: the 7 workloads at
    ``persist_budget=100_000`` x the three schemes (Table I config)."""
    from repro_torch.core import PCSConfig, Scheme, WORKLOADS, make_trace
    t0 = time.time()
    traces = [make_trace(n, persist_budget=100_000) for n in WORKLOADS]
    print(f"phase 3 paper-grid traces built in {time.time() - t0:.1f} s "
          f"({sum(t.total_ops for t in traces)} ops)")
    return traces, [PCSConfig(scheme=s) for s in Scheme]


def phase_cell_scan_full(torch, traces, configs):
    """The kernel on all 21 full-size cells, with the main path's own
    stacked inputs; the shortest workload's three cells also go through
    the eager ``scan_cell`` on a host copy of those inputs."""
    from repro_torch.core.engine.grid import cell_inputs
    from repro_torch.kernels import cell_scan as cs
    pairs = [(i, j) for i in range(len(traces)) for j in range(len(configs))]
    args, kw = cell_inputs(traces, configs, [p[0] for p in pairs],
                           [p[1] for p in pairs], device="cuda")
    got = cs.cell_scan(*args, **kw)
    torch.cuda.synchronize()
    i = min(range(len(traces)), key=lambda k: traces[k].total_ops)
    sel = [k for k, p in enumerate(pairs) if p[0] == i]
    host = [a.cpu() for a in args]
    host[4], host[5] = host[4][sel], host[5][sel]   # cell_trace, cell_cfg
    t0 = time.time()
    plain = cs.cell_scan(*host, **kw)
    plain_s = time.time() - t0
    sel_t = torch.tensor(sel, device="cuda")
    err = compare_outputs(plain, cs.CellScanOut(*(x[sel_t] for x in got)),
                          f"paper grid {traces[i].name}")
    print(f"phase 3 cell_scan full size: exact on the {len(sel)} cells of "
          f"{traces[i].name} ({int(plain.steps.max())} steps, eager "
          f"scan_cell {plain_s:.1f} s on the host)")
    return args, kw, got, err


def phase_main_path(torch, np, smem_ns, traces, configs, full):
    from repro_torch.core import Scheme, simulate_grid
    from repro_torch.core.engine.state import result_from_stats
    from repro_torch.kernels import cell_scan as cs
    from repro_torch.kernels import tat_lookup as tl
    with open(os.path.join(ROOT, "src", "repro_torch", "testdata",
                           "paper_grid_ref.json")) as f:
        ref = json.load(f)["cells"]
    names = [t.name for t in traces]

    cs.launches = tl.launches = 0
    t0 = time.time()
    cells = simulate_grid(traces, configs)          # default device: CUDA
    wall = time.time() - t0
    counts = dict(cell_scan=cs.launches, tat_lookup=tl.launches)
    # The match routine runs inside the cell-scan kernel, which counts
    # its calls on the device; read from the kernel's run on the main
    # path's inputs (phase 3), which the run above repeats exactly.
    args, kw, out, _ = full
    match_calls = int(out.lookups.sum())
    print(f"phase 4 simulate_grid (paper grid, 21 cells) wall {wall:.3f} s; "
          f"launches {json.dumps(counts)}; tat_lookup match-routine calls "
          f"inside cell_scan {match_calls}")
    if counts["cell_scan"] < 1 or match_calls < 1:
        fail(f"main path did not run through the kernels: {counts}, "
             f"{match_calls} match calls")

    for i, n in enumerate(names):
        for j, s in enumerate(Scheme):
            r, d = cells[i][j], ref[n][s.name]
            want = result_from_stats(
                d["runtime_ns"], np.asarray(d["stats"], np.float64),
                recovery_entries=d["recovery_entries"],
                recovery_ns=d["recovery_ns"])
            for f in ("runtime_ns", "persists", "pm_reads", "read_hits",
                      "coalesces", "pm_writes", "stall_ns", "pi_detours",
                      "victim_drains", "acked_persists", "durable_persists",
                      "recovery_entries", "recovery_ns", "slo_violations",
                      "persist_lat_ns", "read_lat_ns"):
                if getattr(r, f) != getattr(want, f):
                    fail(f"paper grid {n}/{s.name}: {f} = {getattr(r, f)!r}"
                         f", reference {getattr(want, f)!r}")
            if not np.array_equal(r.lat_hist, want.lat_hist):
                fail(f"paper grid {n}/{s.name}: latency histogram differs")

    # the raw stats rows, and the kernel's own time on the main path
    pairs = [(i, j) for i in range(len(traces)) for j in range(len(configs))]
    main_ms = cuda_ms(lambda: cs.cell_scan(*args, **kw), 1)
    stats = out.stats.cpu().numpy()
    for k, (i, j) in enumerate(pairs):
        row = np.asarray(ref[names[i]][list(Scheme)[j].name]["stats"])
        if not np.array_equal(stats[k, 0], row):
            fail(f"paper grid {names[i]}: raw stats row differs")
    main_steps = int(out.steps.max())
    latency_bound = main_steps * smem_ns / 1e6
    print(f"phase 4 exact against paper_grid_ref.json on 21 cells "
          f"(runtime, stats rows, recovery); kernel {main_ms:.3f} ms, "
          f"longest cell {main_steps} steps "
          f"({main_ms * 1e6 / main_steps:.1f} ns/step; latency bound "
          f"{latency_bound:.3f} ms)")

    sp = {k: [] for k in SCHEME_KEYS}
    for i, n in enumerate(names):
        nopb = cells[i][0]
        for key, j in (("pb", 1), ("pb_rf", 2)):
            s = 100.0 * (nopb.runtime_ns / cells[i][j].runtime_ns - 1.0)
            sp[key].append(s)
            print(f"fig5_{key}_{n},{round(s, 1)},speedup_%")
    for key, paper in (("pb", 12.0), ("pb_rf", 15.0)):
        print(f"fig5_{key}_mean,{round(sum(sp[key]) / len(sp[key]), 1)},"
              f"paper={paper}%")
    bound = cell_bytes(traces, len(pairs), 1, 1, len(configs)) \
        / HBM_BYTES_PER_S * 1e3
    return dict(counts=counts, match_calls=match_calls,
                main_ms=main_ms, main_bound_ms=bound,
                main_steps=main_steps, wall_s=wall,
                main_latency_bound_ms=latency_bound)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    # ---- phase 1: the card and the build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.time()
    sources = _build.SOURCES + ("smem_probe",)
    _build.build_all(sources)           # one nvcc per source, all at once
    print(f"phase 1 kernels built in {time.time() - t0:.1f} s "
          f"({', '.join(sources)})")

    smem_ns = smem_round_trip_ns(torch)
    print(f"phase 1 one dependent shared-memory load: {smem_ns:.3f} ns")
    tat = phase_tat_lookup(torch, np)
    scan = phase_cell_scan(torch, smem_ns)
    traces, configs = paper_grid()
    full = phase_cell_scan_full(torch, traces, configs)
    main_path = phase_main_path(torch, np, smem_ns, traces, configs, full)

    eng = tat[(8, 16)]
    kernels = [
        dict(name="tat_lookup", route="cuda",
             source="src/repro_torch/kernels/csrc/tat_lookup.cu",
             replaces="src/repro/kernels/tat_lookup.py:35",
             launches=main_path["counts"]["tat_lookup"],
             main_path="not launched: its match routine (tat_match.cuh) "
                       "runs inside cell_scan, whose fused_tat_match_calls "
                       "counts it",
             max_abs_err=max(r["max_abs_err"] for r in tat.values()),
             ms=eng["ms"], plain_ms=eng["plain_ms"],
             bound_ms=eng["bound_ms"], bound_by="bytes", library_ms=None,
             shape="R=8, N=16"),
        dict(name="cell_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/cell_scan.cu",
             replaces="src/repro/core/engine/step.py:102",
             launches=main_path["counts"]["cell_scan"],
             fused_tat_match_calls=main_path["match_calls"],
             max_abs_err=max(scan["max_abs_err"], full[3]), ms=scan["ms"],
             plain_ms=scan["plain_ms"], bound_ms=scan["bound_ms"],
             bound_by="bytes", library_ms=None,
             shape="7 workloads x 3 schemes at persist_budget=2000",
             latency_bound_ms=scan["latency_bound_ms"],
             smem_round_trip_ns=smem_ns,
             main_path_ms=main_path["main_ms"],
             main_path_bound_ms=main_path["main_bound_ms"],
             main_path_latency_bound_ms=main_path[
                 "main_latency_bound_ms"],
             main_path_max_steps=main_path["main_steps"],
             main_path_wall_s=main_path["wall_s"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
