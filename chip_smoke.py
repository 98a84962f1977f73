#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

It imports only ``repro_torch`` (never JAX or the ``repro`` package),
builds the port's kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch/``, and runs eight phases, each printing its own
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
   launched on this path); then the section profile of a step: the
   same kernel built with ``-DCELL_SCAN_PROFILE`` on the three cholesky
   cells (the longest), cycles and ns per step of each section;
5. every route of ``flash_attention`` against the plain version on the
   card: the JAX sweep (bf16 and f32 up to head dim 128 on the
   tensor-core kernel, f32 at 256 on the FMA kernel, causal with and
   without a window, one non-causal case each; 2e-5 / 3e-2; each case's
   route checked by its launch counters), the tensor-core kernel's bf16
   outputs past 3e-2 over 8 seeds at smollm-135m's prefill shape (none
   allowed), and that shape in bf16 (the main path) and f32 (the f32
   tensor-core route beside the FMA kernel, run through ``launch``),
   timed beside the plain version and ``scaled_dot_product_attention``;
6. every route of ``ssd_scan`` against the plain version: the JAX sweep
   in both dtypes (the tensor-core kernel; 1e-3 / 1e-1; each case's
   route checked by its launch counters), a carried-in state on a
   ragged length in each dtype, the sequential recurrence, mamba2-1.3b's
   prefill shape in bf16 (the main path) and f32 (the f32 tensor-core
   route beside the FMA kernel, run through ``launch``), timed beside
   the plain version and the bound, an f32 chunk outside the
   tensor-core limits (the FMA kernel), and the tensor-core kernel's
   bf16 outputs past 1e-1 over 8 seeds at the prefill shape (none
   allowed);
7. the serving path, for smollm-135m and mamba2-1.3b at full width and
   depth: (a) the f32 copy with ``numpy_params(cfg, 0)`` against
   ``src/repro_torch/testdata/serve_ref.json`` (the JAX reference's
   logits and greedy tokens; its prefill takes the f32 tensor-core
   routes), with that prefill's device time by kernel beside the same
   prefill with the FMA route swapped in, (b) the published bf16 config
   serving 4 requests of 1024 prompt tokens with 64 greedy steps through
   ``launch.serve.serve``, with each kernel's launches in that run
   (attention and SSD on their tensor-core routes), and mamba2's bf16
   prefill logits against the same model with the plain
   ``ssd_scan_ref`` swapped in;
8. (run after phase 4, before 5) switch chains through the cell scan's
   deep-hop rows: (a) Fig. 1's depth sweep at its published size
   (``benchmarks/fig1_switch_depth.py``: 1 core, 2000 persist/read
   pairs; NoPB at depths 0-4, PB and PB_RF at 1-4 and crashed at half
   the op span; 21 cells) and (b) the 7 workloads x 3 schemes at
   ``n_switches`` 2-4 and ``persist_budget=100_000`` (63 cells), each
   through ``simulate_grid`` with its launch counts, exact against
   ``src/repro_torch/testdata/chain_ref.json`` (all of (a) and (b)) and
   the eager ``scan_cell`` (all of (a), lu_cont's cells of (b); a pool
   of host processes), with each Fig. 1 row's persist latency over
   depth-0 NoPB and its per-hop recovery; then (d) the section profile
   of a chained step (Fig. 1's PB/4 and PB_RF/4 cells, cholesky's cells
   at ``n_switches`` 4), exact against (a) and (b); then (c) 225 fuzzed
   crash cells at depths 1-3 on the card against the port's untimed
   oracle (``tests/_torch_crash_driver.py``).

Then one JSON line with the serving numbers, one with every kernel's
numbers, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no result; it also refuses to run
without CUDA.

``python3 chip_smoke.py --against OLD.cu`` runs only a comparison of
the package's cell scan with another ``cell_scan.cu`` (an earlier
revision's, its headers beside it or the package's) on Fig. 1's sweep
and the chained paper grid: outputs equal but for the lookup counts,
kernel times in the order other, this, this, other, and both section
profiles (phase 8d's cells); it prints the card and one JSON line.
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


SPIN_CYCLES = 10 ** 8               # ~50 ms of the card's clock


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events).  The
    calls queue behind a spin kernel, so that a kernel shorter than its
    wrapper's host time is timed on the device, not at the host's
    enqueue rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SPIN_CYCLES)
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


def cell_bytes(traces, n_cells: int, T: int, A: int, n_cfg: int,
               D: int = 0) -> float:
    """Bytes the cell scan must move: each trace op (op, addr, gap) and
    stream length read once, the config tables read once, every output
    written once (D: the grid's deep-hop rows)."""
    from repro_torch.core.engine.state import N_HOP_STATS, N_STATS
    from repro_torch.kernels.cell_scan import (CHAIN_KEYS, DEEP_KEYS,
                                               SC_KEYS, TENANT_KEYS)
    inputs = sum(12 * t.total_ops + 4 * t.n_cores for t in traces)
    inputs += 8 * n_cfg * (len(SC_KEYS) + len(TENANT_KEYS) * T
                           + len(CHAIN_KEYS) + len(DEEP_KEYS) * max(D, 1))
    inputs += 4 * n_cfg + 8 * n_cells
    outputs = n_cells * (8 + 8 * T * N_STATS + 8 * (D + 1) * N_HOP_STATS
                         + 4 * A + 8 + 8 + 8 * T + 8 * (D + 1) + 8 + 8)
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


PROF_SECTIONS = ("merge_keys", "merge_argmin", "merge_fetch", "read",
                 "persist_lookup", "occupancy", "victim_select",
                 "drain_policy", "state_writes", "stats", "other_ops",
                 "bookkeeping", "chain_batch", "chain_read", "chain_fifo",
                 "chain_match", "chain_alloc", "chain_writer",
                 "chain_drain_rank", "chain_land")
OP_NAMES = ("compute", "dram_read", "dram_write", "pm_read", "persist",
            "barrier")


def profile_cells(torch, args, kw, got, sel, labels, libs=None):
    """The section profile of a step on cells ``sel`` of the kernel's
    inputs ``args``: ``cell_scan.cu`` built with ``-DCELL_SCAN_PROFILE``
    (``_build.VARIANTS``) beside the uninstrumented build, both exact
    against ``got`` (the main path's outputs; the lookup counts too).
    ``libs``: the (uninstrumented, profile) libraries, the package's by
    default.  Returns ``{label: {ns_per_step, total_ns_per_step, steps,
    ops}}`` (sections with no cycles left out) and both kernel times."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import cell_scan as cs
    plain_lib, prof_lib = libs or (_build.library("cell_scan"),
                                   _build.library("cell_scan_profile"))
    sel_t = torch.tensor(sel, device="cuda")
    ins = [x.contiguous() for x in args]
    ins[4], ins[5] = ins[4][sel_t].contiguous(), ins[5][sel_t].contiguous()
    n_prof = len(PROF_SECTIONS) + len(OP_NAMES) + 1
    prof = torch.zeros((len(sel), n_prof), dtype=torch.int64, device="cuda")
    fn = prof_lib.cell_scan_set_profile
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    _build.check(fn(prof.data_ptr()), "cell_scan_set_profile")
    stream = torch.cuda.current_stream().cuda_stream
    T, A = kw["n_tenants_max"], max(kw["n_track"], 1)
    outs = {}

    def run(name, lib):
        out = cs._empty_out(len(sel), T, A, kw["n_deep_max"], "cuda")
        _build.check(cs.launch(lib, ins, out, max_pbe=kw["max_pbe"],
                               pm_banks=kw["pm_banks"], n_track=kw["n_track"],
                               n_deep=kw["n_deep_max"], stream=stream),
                     f"{name} launch")
        outs[name] = out
    prof_ms = cuda_ms(lambda: run("profile", prof_lib), 1)
    plain_ms = cuda_ms(lambda: run("uninstrumented", plain_lib), 1)
    want = cs.CellScanOut(*(x[sel_t] for x in got))
    for name, out in outs.items():
        for f in cs.CellScanOut._fields:
            if not torch_equal(getattr(out, f), getattr(want, f)):
                fail(f"{name} build on {labels} differs from the main path "
                     f"on {f}")
    rows = prof.cpu().tolist()
    steps = [int(x) for x in want.steps.cpu().tolist()]
    ghz = max(r[-1] for r in rows) / (prof_ms * 1e6)
    cells = {}
    for label, row, n in zip(labels, rows, steps):
        sec = {name: row[k] / n / ghz
               for k, name in enumerate(PROF_SECTIONS) if row[k]}
        cells[label] = dict(ns_per_step=sec, total_ns_per_step=row[-1] / n
                            / ghz, steps=n,
                            ops=dict(zip(OP_NAMES, row[len(PROF_SECTIONS):-1])))
    return dict(cells=cells, ms=plain_ms, profiled_ms=prof_ms,
                ns_per_step=plain_ms * 1e6 / max(steps), ghz=ghz)


def print_profile(phase, what, p):
    for label, c in p["cells"].items():
        print(f"phase {phase} cell_scan section profile {label}: "
              f"{c['steps']} steps ("
              + ", ".join(f"{k} {v}" for k, v in c["ops"].items())
              + "); ns per step: "
              + ", ".join(f"{k} {v:.1f}" for k, v in c["ns_per_step"].items())
              + f"; total {c['total_ns_per_step']:.1f} ns per step")
    print(f"phase {phase} cell_scan profile: instrumented "
          f"{p['profiled_ms']:.3f} ms, uninstrumented {p['ms']:.3f} ms on "
          f"{what} ({p['ns_per_step']:.1f} ns/step); SM clock "
          f"{p['ghz']:.3f} GHz from the loop's cycles over the instrumented "
          f"time; both exact against the main path")


def phase_cell_scan_profile(torch, traces, configs, full):
    """The section profile of a depth-1 step on the paper grid's cholesky
    cells (the longest)."""
    from repro_torch.core import Scheme
    args, kw, got, _ = full
    i = [t.name for t in traces].index("cholesky")
    sel = [k for k in range(len(traces) * len(configs))
           if k // len(configs) == i]
    labels = [f"cholesky/{list(Scheme)[int(args[5][k])].name}" for k in sel]
    p = profile_cells(torch, args, kw, got, sel, labels)
    print_profile(4, "the 3 cholesky cells", p)
    return dict(sections={k.split("/")[1]: c for k, c in p["cells"].items()},
                ms=p["ms"], profiled_ms=p["profiled_ms"],
                ns_per_step=p["ns_per_step"], ghz=p["ghz"])


# ---- phase 8: switch chains ----------------------------------------------
FIG1_DEPTHS = (0, 1, 2, 3, 4)          # benchmarks/fig1_switch_depth.py
FIG1_OPS, FIG1_GAP = 2000, 2000.0
CHAIN_DEPTHS = (2, 3, 4)               # the chained paper grid
ORACLE_CHAINS = ((1, None), (2, (3, 3)), (3, (3, 2, 1)))


def fig1_grid(np):
    """Fig. 1's depth sweep at its published size
    (``benchmarks/fig1_switch_depth.py``): the probe trace (one core,
    2000 persist/read pairs, 2 us apart) and 21 cells: NoPB at depths
    0-4, PB and PB_RF at 1-4, and a replica of every PB cell crashed at
    half the op span.  Returns ``(trace, labels, configs)``; a label is
    ``(scheme name, n_switches, crashed)``."""
    from repro_torch.core import Op, PCSConfig, Scheme, trace_from_arrays
    ops, addrs = [], []
    for i in range(FIG1_OPS):
        ops += [int(Op.PERSIST), int(Op.PM_READ)]
        addrs += [i, (1 << 20) + i]
    tr = trace_from_arrays("fig1_probe", np.array([ops], np.int32),
                           np.array([addrs], np.int32),
                           np.full((1, len(ops)), FIG1_GAP, np.float32),
                           np.array([len(ops)], np.int32))
    labels, configs = [], []
    for n_sw in FIG1_DEPTHS:
        labels.append(("NOPB", n_sw, False))
        configs.append(PCSConfig(scheme=Scheme.NOPB, n_switches=n_sw))
        if n_sw >= 1:
            for s in (Scheme.PB, Scheme.PB_RF):
                labels.append((s.name, n_sw, False))
                configs.append(PCSConfig(scheme=s, n_switches=n_sw))
    crash_at = 0.5 * (2 * FIG1_OPS) * FIG1_GAP
    for s in (Scheme.PB, Scheme.PB_RF):
        for n_sw in FIG1_DEPTHS[1:]:
            labels.append((s.name, n_sw, True))
            configs.append(PCSConfig(scheme=s, n_switches=n_sw)
                           .with_crash(crash_at))
    return tr, labels, configs


def _eager_worker(task):
    """One cell of the eager plain version in a pool process."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.kernels import cell_scan as cs
    k, args, kw = task
    t0 = time.time()
    out = cs.cell_scan_ref(*args, **kw)
    return k, out, time.time() - t0


def eager_cells(torch, args, kw, sel):
    """The eager plain version on cells ``sel`` of the kernel's inputs
    ``args``, a cell per task over a pool of spawned processes (one per
    host core); each task carries only its own trace, cut to its longest
    stream.  Returns ``(CellScanOut over sel, summed seconds of the
    cells, wall seconds of the pool)``."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.kernels import cell_scan as cs
    host = [a.cpu() for a in args]
    tasks = []
    for k in sel:
        tr, cf = int(host[4][k]), int(host[5][k])
        L = max(int(host[3][tr].max()), 1)
        one = [x[tr:tr + 1, ..., :L] if i < 3 else x[tr:tr + 1]
               for i, x in enumerate(host[:4])]
        one += [torch.zeros(1, dtype=torch.int32),
                torch.tensor([cf], dtype=torch.int32)] + host[6:]
        tasks.append((k, one, kw))
    t0 = time.time()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(os.cpu_count() or 1, len(tasks)),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        done = {k: (out, sec) for k, out, sec in ex.map(_eager_worker,
                                                        tasks)}
    wall = time.time() - t0
    outs = [done[k][0] for k in sel]
    plain = cs.CellScanOut(*(torch.cat([getattr(o, f) for o in outs])
                             for f in cs.CellScanOut._fields))
    return plain, sum(done[k][1] for k in sel), wall


def chain_grid_b():
    """The 7 workloads at ``persist_budget=100_000`` x NoPB/PB/PB_RF at
    n_switches 2, 3 and 4 (default PCSConfig): the chained version of
    phase 4's grid, 63 cells.  Returns ``(traces, labels, configs)``."""
    from repro_torch.core import PCSConfig, Scheme, WORKLOADS, make_trace
    traces = [make_trace(n, persist_budget=100_000) for n in WORKLOADS]
    labels, configs = [], []
    for n_sw in CHAIN_DEPTHS:
        for s in Scheme:
            labels.append((s.name, n_sw))
            configs.append(PCSConfig(scheme=s, n_switches=n_sw))
    return traces, labels, configs


def same_as_datum(np, r, d, what):
    """A SimResult equal, field by field, to the one the JAX datum's
    numbers give (runtime, stats, hop rows, recovery)."""
    from repro_torch.core.engine.state import result_from_stats
    hs = np.asarray([[float(x) for x in row] for row in d["hop_stats"]])
    want = result_from_stats(
        float(d["runtime_ns"]), np.asarray([float(x) for x in d["stats"]]),
        crash_at_ns=r.crash_at_ns, recovery_entries=d["recovery_entries"],
        recovery_ns=float(d["recovery_ns"]), n_hops=len(d["hop_recovery"]),
        hop_stats=hs if len(hs) else None,
        hop_recovery=np.asarray(d["hop_recovery"], np.int64))
    for f in ("runtime_ns", "persists", "pm_reads", "read_hits",
              "coalesces", "pm_writes", "stall_ns", "pi_detours",
              "victim_drains", "acked_persists", "durable_persists",
              "recovery_entries", "recovery_ns", "slo_violations",
              "persist_lat_ns", "read_lat_ns", "n_hops"):
        if getattr(r, f) != getattr(want, f) and not (
                getattr(r, f) != getattr(r, f)
                and getattr(want, f) != getattr(want, f)):    # NaN == NaN
            fail(f"{what}: {f} = {getattr(r, f)!r}, reference "
                 f"{getattr(want, f)!r}")
    for f in ("lat_hist", "hop_stats", "hop_recovery"):
        a, b = getattr(r, f), getattr(want, f)
        if (a is None) != (b is None) or (a is not None and
                                          not np.array_equal(a, b)):
            fail(f"{what}: {f} = {a!r}, reference {b!r}")


def phase_chains(torch, np, smem_ns):
    """Phase 8: switch chains through the cell scan's deep-hop rows.
    (a) Fig. 1's depth sweep at its published size and (b) the 7
    workloads x 3 schemes at n_switches 2-4 run through
    ``simulate_grid`` on the card (each with the launch counts zeroed
    just before and read just after), exact against
    ``testdata/chain_ref.json`` (all 21 + 63 cells) and against the
    eager plain version (all of (a); lu_cont's cells of (b)); (d) the
    section profile of a chained step; then fuzzed crash cells at depths
    1-3 on the card against the port's untimed oracle."""
    from repro_torch.core import Scheme, simulate_grid
    from repro_torch.core.engine.grid import cell_inputs
    from repro_torch.kernels import cell_scan as cs
    from repro_torch.kernels import tat_lookup as tl
    with open(os.path.join(ROOT, "src", "repro_torch", "testdata",
                           "chain_ref.json")) as f:
        ref = json.load(f)
    out = {}

    # (a) Fig. 1's depth sweep
    tr, labels, configs = fig1_grid(np)
    cs.launches = tl.launches = 0
    t0 = time.time()
    cells = simulate_grid([tr], configs)[0]          # default device: CUDA
    wall_a = time.time() - t0
    counts_a = dict(cell_scan=cs.launches, tat_lookup=tl.launches)
    if counts_a["cell_scan"] < 1:
        fail(f"Fig. 1 sweep did not run through the kernel: {counts_a}")
    base = cells[labels.index(("NOPB", 0, False))].persist_lat_ns
    for (name, n_sw, crashed), r in zip(labels, cells):
        key = f"{name}/{n_sw}" + ("/crash" if crashed else "")
        same_as_datum(np, r, ref["fig1"][key], f"Fig. 1 {key}")
        rec = None if r.hop_recovery is None else r.hop_recovery.tolist()
        print(f"phase 8a fig1 {key}: persist {r.persist_lat_ns:.1f} ns "
              f"({r.persist_lat_ns / base:.3f}x depth-0 NoPB), runtime "
              f"{r.runtime_ns:.1f} ns, hop_recovery {rec}")
    pairs = list(range(len(configs)))
    args, kw = cell_inputs([tr], configs, [0] * len(pairs), pairs,
                           device="cuda")
    got = cs.cell_scan(*args, **kw)
    torch.cuda.synchronize()
    ms_a = cuda_ms(lambda: cs.cell_scan(*args, **kw), 3)
    plain, plain_s, pool_s = eager_cells(torch, args, kw, pairs)
    err = compare_outputs(plain, got, "Fig. 1 sweep")
    steps_a = int(plain.steps.max())
    bound_a = cell_bytes([tr], len(pairs), 1, 1, len(configs),
                         kw["n_deep_max"]) / HBM_BYTES_PER_S * 1e3
    print(f"phase 8a simulate_grid (Fig. 1 sweep, 21 cells, D = "
          f"{kw['n_deep_max']}) wall {wall_a:.3f} s; launches "
          f"{json.dumps(counts_a)}; exact against chain_ref.json and the "
          f"eager scan_cell on all 21 cells (eager {plain_s:.1f} s of cells, "
          f"{pool_s:.1f} s wall over a pool); kernel {ms_a:.3f} ms, longest "
          f"cell {steps_a} steps ({ms_a * 1e6 / steps_a:.1f} ns/step; "
          f"latency bound {steps_a * smem_ns / 1e6:.3f} ms)")
    out["fig1"] = dict(counts=counts_a, wall_s=wall_a, ms=ms_a,
                       plain_s=plain_s, pool_s=pool_s, bound_ms=bound_a,
                       steps=steps_a, max_abs_err=err,
                       persist_norm={f"{n}/{d}": r.persist_lat_ns / base
                                     for (n, d, c), r in zip(labels, cells)
                                     if not c},
                       hop_recovery={f"{n}/{d}": r.hop_recovery.tolist()
                                     for (n, d, c), r in zip(labels, cells)
                                     if c})

    # (b) the chained paper grid
    t0 = time.time()
    traces, blabels, bconfigs = chain_grid_b()
    print(f"phase 8b traces built in {time.time() - t0:.1f} s")
    names = [t.name for t in traces]
    cs.launches = tl.launches = 0
    t0 = time.time()
    bcells = simulate_grid(traces, bconfigs)
    wall_b = time.time() - t0
    counts_b = dict(cell_scan=cs.launches, tat_lookup=tl.launches)
    if counts_b["cell_scan"] < 1:
        fail(f"chained grid did not run through the kernel: {counts_b}")
    n_datum = 0
    for i, n in enumerate(names):
        for j, (sname, n_sw) in enumerate(blabels):
            same_as_datum(np, bcells[i][j], ref["grid_b"][n][f"{sname}/{n_sw}"],
                          f"chained grid {n}/{sname}/{n_sw}")
            n_datum += 1
    bpairs = [(i, j) for i in range(len(traces))
              for j in range(len(bconfigs))]
    bargs, bkw = cell_inputs(traces, bconfigs, [p[0] for p in bpairs],
                             [p[1] for p in bpairs], device="cuda")
    bgot = cs.cell_scan(*bargs, **bkw)
    torch.cuda.synchronize()
    ms_b = cuda_ms(lambda: cs.cell_scan(*bargs, **bkw), 1)
    sel = [k for k, p in enumerate(bpairs) if names[p[0]] == "lu_cont"]
    bplain, bplain_s, bpool_s = eager_cells(torch, bargs, bkw, sel)
    sel_t = torch.tensor(sel, device="cuda")
    err = max(err, compare_outputs(
        bplain, cs.CellScanOut(*(x[sel_t] for x in bgot)),
        "chained grid lu_cont"))
    steps_b = int(bgot.steps.max())
    bound_b = cell_bytes(traces, len(bpairs), 1, 1, len(bconfigs),
                         bkw["n_deep_max"]) / HBM_BYTES_PER_S * 1e3
    per_depth = {}
    for n_sw in CHAIN_DEPTHS:
        ks = [k for k, (i, j) in enumerate(bpairs) if blabels[j][1] == n_sw]
        per_depth[n_sw] = int(bgot.steps[ks].max())
    print(f"phase 8b simulate_grid (7 workloads x 3 schemes x n_switches "
          f"2-4, budget 100000, 63 cells) wall {wall_b:.3f} s; launches "
          f"{json.dumps(counts_b)}; exact against chain_ref.json on "
          f"{n_datum} cells and against the eager "
          f"scan_cell on lu_cont's {len(sel)} cells ({bplain_s:.1f} s of "
          f"cells, {bpool_s:.1f} s wall over a pool); kernel {ms_b:.3f} ms, "
          f"longest cell {steps_b} steps ({ms_b * 1e6 / steps_b:.1f} "
          f"ns/step; latency bound {steps_b * smem_ns / 1e6:.3f} ms)")
    for i, n in enumerate(names):
        row = []
        for j, (sname, n_sw) in enumerate(blabels):
            if sname != "NOPB":
                nopb = bcells[i][blabels.index(("NOPB", n_sw))].runtime_ns
                row.append(f"{sname}/{n_sw} "
                           f"{100.0 * (nopb / bcells[i][j].runtime_ns - 1.0):.1f}")
        print(f"phase 8b speedup over NoPB at the same depth, {n}: "
              + ", ".join(row) + " %")
    out["grid_b"] = dict(counts=counts_b, wall_s=wall_b, ms=ms_b,
                         plain_s_lu_cont=bplain_s, pool_s=bpool_s,
                         bound_ms=bound_b, steps=steps_b,
                         steps_by_depth=per_depth, datum_cells=n_datum)

    # (d) the section profile of a chained step
    out["profile"] = chain_profile(
        torch, (args, kw, got, labels), (bargs, bkw, bgot, bpairs, names,
                                         blabels))

    # (c) fuzzed crash cells at depths 1-3 against the port's oracle
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_crash_driver import assert_cell_matches, oracle_replay
    from repro_torch.core import PCSConfig, fuzz_crash_ns, fuzz_trace
    n_cells = 0
    t0 = time.time()
    for seed in range(5):
        ftr, sched = fuzz_trace(seed, n_cores=3, n_slots=50, n_addrs=6,
                                p_persist=0.7)
        plan = [(s, d, hp, k) for s in Scheme for d, hp in ORACLE_CHAINS
                for k in (0, 11, 23, 36, 50)]
        fcfg = [PCSConfig(scheme=s, n_pbe=3, n_switches=d,
                          pbe_per_hop=None if s == Scheme.NOPB else hp
                          ).with_crash(fuzz_crash_ns(k))
                for s, d, hp, k in plan]
        fres = simulate_grid([ftr], fcfg, max_pbe=3, track_addrs=6)[0]
        for (s, d, hp, k), r in zip(plan, fres):
            try:
                assert_cell_matches(r, oracle_replay(sched, k, s, 3,
                                                     n_switches=d,
                                                     pbe_per_hop=hp), 6,
                                    label=(seed, s.name, d, hp, k))
            except AssertionError as e:
                fail(f"oracle differential: {e}")
            n_cells += 1
    print(f"phase 8c {n_cells} fuzzed crash cells (3 schemes x depths 1-3 "
          f"x 5 crash points x 5 seeds) on the card agree with the port's "
          f"oracle (durable versions, counts, per-hop survivors and "
          f"telemetry) in {time.time() - t0:.1f} s")
    out["oracle_cells"] = n_cells
    out["max_abs_err"] = err
    return out


def chain_profile(torch, fig1, grid_b, libs=None):
    """Phase 8d: the section profile of a chained step on Fig. 1's PB/4
    and PB_RF/4 cells and on cholesky's chained cells at n_switches 4,
    exact against the main path's outputs (``fig1``: the sweep's inputs,
    outputs and labels; ``grid_b``: the chained grid's, with its cell
    pairs, workload names and labels)."""
    args, kw, got, labels = fig1
    sel = [labels.index((s, 4, False)) for s in ("PB", "PB_RF")]
    pa = profile_cells(torch, args, kw, got, sel,
                       [f"fig1/{s}/4" for s in ("PB", "PB_RF")], libs)
    print_profile("8d", "Fig. 1's PB/4 and PB_RF/4 cells", pa)
    bargs, bkw, bgot, bpairs, names, blabels = grid_b
    sel = [k for k, (i, j) in enumerate(bpairs)
           if names[i] == "cholesky" and blabels[j][1] == 4]
    pb = profile_cells(torch, bargs, bkw, bgot, sel,
                       [f"cholesky/{blabels[bpairs[k][1]][0]}/4"
                        for k in sel], libs)
    print_profile("8d", "cholesky's 3 cells at n_switches 4", pb)
    return dict(fig1=pa, cholesky_4=pb)


def build_against(path: str):
    """The cell scan of another ``cell_scan.cu`` (an earlier revision's),
    uninstrumented and with its section profile, built with the
    package's flags into ``build/repro_torch/against/``; headers beside
    ``path`` first, then the package's."""
    import ctypes
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "against"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in ("cell_scan", "cell_scan_profile"):
        so = out / f"lib{name}.so"
        procs.append((so, subprocess.Popen(
            [_build._nvcc(), *_build.nvcc_flags(name), f"-I{_build.CSRC}",
             "-o", str(so), path])))
    for so, proc in procs:
        if proc.wait() != 0:
            fail(f"building {path} as {so.name} failed")
    return tuple(ctypes.CDLL(str(so)) for so, _ in procs)


def compare_against(torch, np, path: str) -> dict:
    """``chip_smoke.py --against OLD.cu``: the package's cell scan beside
    another source's on Fig. 1's sweep and the chained paper grid —
    outputs equal (all but the lookup counts), kernel times in the order
    other, this, this, other, and both section profiles (phase 8d's
    cells)."""
    from repro_torch.core.engine.grid import cell_inputs
    from repro_torch.kernels import _build
    from repro_torch.kernels import cell_scan as cs
    other = build_against(path)
    this = (_build.library("cell_scan"), _build.library("cell_scan_profile"))
    tr, labels, configs = fig1_grid(np)
    pairs = list(range(len(configs)))
    args, kw = cell_inputs([tr], configs, [0] * len(pairs), pairs,
                           device="cuda")
    traces, blabels, bconfigs = chain_grid_b()
    names = [t.name for t in traces]
    bpairs = [(i, j) for i in range(len(traces))
              for j in range(len(bconfigs))]
    bargs, bkw = cell_inputs(traces, bconfigs, [p[0] for p in bpairs],
                             [p[1] for p in bpairs], device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for grid, (a, k, n, reps) in (("fig1", (args, kw, len(pairs), 3)),
                                  ("grid_b", (bargs, bkw, len(bpairs), 1))):
        ins = [x.contiguous() for x in a]
        outs = {}

        def run(which, lib):
            out = cs._empty_out(n, k["n_tenants_max"], max(k["n_track"], 1),
                                k["n_deep_max"], "cuda")
            _build.check(cs.launch(lib, ins, out, max_pbe=k["max_pbe"],
                                   pm_banks=k["pm_banks"],
                                   n_track=k["n_track"],
                                   n_deep=k["n_deep_max"], stream=stream),
                         f"{which} launch")
            outs[which] = out
        ms = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            lib = (other if which == "other" else this)[0]
            ms[which].append(cuda_ms(lambda: run(which, lib), reps))
        for f in cs.CellScanOut._fields:
            if f != "lookups" and not torch_equal(getattr(outs["other"], f),
                                                  getattr(outs["this"], f)):
                fail(f"{grid}: {path} and the package's cell scan differ "
                     f"on {f}")
        steps = int(outs["this"].steps.max())
        res[grid] = dict(ms=ms, steps=steps,
                         ns_per_step={w: [t * 1e6 / steps for t in v]
                                      for w, v in ms.items()},
                         lookups={w: int(o.lookups.sum())
                                  for w, o in outs.items()})
        print(f"against {grid}: outputs equal on {n} cells; kernel ms "
              f"other {ms['other']}, this {ms['this']} (order other, this, "
              f"this, other); longest cell {steps} steps; lookups "
              f"{res[grid]['lookups']}")
        if grid == "fig1":
            fig1 = {w: (args, kw, o, labels) for w, o in outs.items()}
        else:
            grid_b = {w: (bargs, bkw, o, bpairs, names, blabels)
                      for w, o in outs.items()}
    for which, libs in (("other", other), ("this", this)):
        print(f"against: section profile of {which}")
        res[f"profile_{which}"] = chain_profile(torch, fig1[which],
                                                grid_b[which], libs)
    res["depth1"] = depth1_profiles(torch)
    return res


def depth1_profiles(torch) -> dict:
    """cholesky's depth-1 cells (NoPB, PB, PB_RF; Table I) through the
    cell scan's D = 0 instantiation and through its D = 3 one (beside a
    chained cell of a short trace), both profiled and equal: what the
    chain's instantiation costs the hop-1 work."""
    from repro_torch.core import PCSConfig, Scheme, make_trace
    from repro_torch.core.engine.grid import cell_inputs
    from repro_torch.kernels import cell_scan as cs
    tr = make_trace("cholesky", persist_budget=100_000)
    short = make_trace("lu_cont", persist_budget=50)
    configs = [PCSConfig(scheme=s) for s in Scheme]
    res, outs = {}, {}
    for name, traces, cfgs, pairs in (
            ("D0", [tr], configs, [(0, 0), (0, 1), (0, 2)]),
            ("D3", [tr, short],
             configs + [PCSConfig(scheme=Scheme.PB, n_switches=4)],
             [(0, 0), (0, 1), (0, 2), (1, 3)])):
        args, kw = cell_inputs(traces, cfgs, [p[0] for p in pairs],
                               [p[1] for p in pairs], device="cuda")
        got = cs.cell_scan(*args, **kw)
        outs[name] = got
        p = profile_cells(torch, args, kw, got, [0, 1, 2],
                          [f"cholesky/{s.name}/1 ({name})" for s in Scheme])
        print_profile("against", f"cholesky's depth-1 cells ({name})", p)
        res[name] = p
    for f in ("runtime", "stats", "durable_ver", "n_recov", "steps"):
        if not torch_equal(getattr(outs["D0"], f)[:3],
                           getattr(outs["D3"], f)[:3]):
            fail(f"depth-1 cells differ between D = 0 and D = 3 on {f}")
    return res


# ---- the model side: flash_attention, ssd_scan, serving ----------------
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
FLASH_SWEEP = ((2, 2, 256, 64), (1, 4, 128, 128), (1, 1, 512, 256))
SSD_SWEEP = ((2, 256, 3, 64, 128, 128), (1, 128, 2, 32, 64, 64),
             (2, 512, 1, 64, 128, 128), (1, 256, 4, 64, 64, 128))
TOL = {"float32": (2e-5, 1e-3), "bfloat16": (3e-2, 1e-1)}  # flash, ssd


def bound(flops: float, nbytes: float, flops_per_s: float = BF16_FLOPS_PER_S):
    """The least time for the work: flops at the peak for their type
    (dense bf16 unless given) or bytes at the HBM rate, whichever is
    longer; (ms, what bounds it)."""
    t_op, t_b = flops / flops_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_op, t_b) * 1e3, ("operations" if t_op >= t_b else "bytes")


def max_err(got, want, what: str, tol: float) -> float:
    """Max |got - want| in f32; raises past ``tol`` or on a non-finite
    output."""
    import torch
    g = got.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: non-finite output")
    err = float((g - want.float()).abs().max())
    if not err < tol:
        fail(f"{what}: max abs error {err:.3g}, limit {tol}")
    return err


def flash_exact(torch, q, k, v):
    """Causal attention evaluated in f64 (K/V heads repeated per query
    head), before any rounding."""
    g = q.shape[1] // k.shape[1]
    qd, kd, vd = q.double(), k.double(), v.double()
    kd, vd = kd.repeat_interleave(g, 1), vd.repeat_interleave(g, 1)
    s = q.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", qd, kd) * q.shape[-1] ** -0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1), vd)


def flash_over_counts(torch, np, seeds=range(8), limit=3e-2):
    """``flash_attention_tc``'s outputs past ``limit`` at smollm-135m's
    prefill shape, per seed, against the plain version and against the
    f64 evaluation rounded to bf16 (``phase_flash`` fails on any)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    b, h, hkv, s, d = 4, 9, 3, 1024, 64
    out = dict(limit=limit, seeds=list(seeds), over_plain=[],
               over_exact=[], plain_over_exact=[], max_abs_err=[])
    for seed in seeds:
        rng = np.random.default_rng(seed)
        q, k, v = (torch.tensor(rng.standard_normal((b, s, n, d)),
                                dtype=torch.float32, device="cuda")
                   .bfloat16().transpose(1, 2) for n in (h, hkv, hkv))
        got = fa.flash_attention(q, k, v, causal=True).float()
        plain = flash_attention_ref(q, k, v, causal=True).float()
        exact = flash_exact(torch, q, k, v).bfloat16().float()
        torch.cuda.synchronize()
        out["max_abs_err"].append(float((got - plain).abs().max()))
        out["over_plain"].append(int(((got - plain).abs() > limit).sum()))
        out["over_exact"].append(int(((got - exact).abs() > limit).sum()))
        out["plain_over_exact"].append(int(((plain - exact).abs() > limit)
                                           .sum()))
    print(f"phase 5 flash_attention_tc outputs past {limit} at (4, 9, 1024, "
          f"64) bf16 causal over seeds {out['seeds']}: vs the plain version "
          f"{out['over_plain']}, vs the f64 evaluation rounded to bf16 "
          f"{out['over_exact']} (the plain version vs it "
          f"{out['plain_over_exact']}); max abs error vs the plain version "
          f"per seed {out['max_abs_err']}")
    return out


def phase_flash(torch, np):
    """Every route of ``flash_attention`` against the plain version: the
    JAX sweep (bf16 and f32 up to D = 128 on the tensor-core kernel, f32
    at D = 256 on the FMA kernel; each case's route checked by the
    per-route launch counters), then smollm-135m's prefill shape: the
    bf16 outputs past 3e-2 over 8 seeds, and each dtype's route timed
    beside the plain version and ``scaled_dot_product_attention``; the
    FMA kernel, through ``launch``, is held and timed there in f32 too."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    rng = np.random.default_rng(11)

    def qkv(b, h, hkv, s, d, dtype):
        # the model's layout: (B, S, H, D) projections, viewed (B, H, S, D)
        return [torch.tensor(rng.standard_normal((b, s, n, d)),
                             dtype=torch.float32, device="cuda")
                .to(dtype).transpose(1, 2) for n in (h, hkv, hkv)]

    err = {"float32": 0.0, "bfloat16": 0.0, "fma": 0.0}
    cases = [(sh, dt, True, w) for sh in FLASH_SWEEP
             for dt in (torch.float32, torch.bfloat16) for w in (None, 64)]
    cases.append(((1, 2, 256, 64), torch.float32, False, None))
    cases.append(((1, 2, 256, 64), torch.bfloat16, False, None))
    n_served = {"tc": 0, "fma": 0}
    for (b, h, s, d), dtype, causal, window in cases:
        name = str(dtype).split(".")[1]
        q, k, v = qkv(b, h, h, s, d, dtype)
        tc0, fma0 = fa.launches_tc, fa.launches_fma
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        served = (fa.launches_tc - tc0, fa.launches_fma - fma0)
        tc = fa.route(dtype, d)[0] == "flash_attention_tc"
        if served != ((1, 0) if tc else (0, 1)):
            fail(f"flash_attention {name} D={d} served by (tc, fma) = "
                 f"{served}")
        n_served["tc" if tc else "fma"] += 1
        e = max_err(got, want, f"flash_attention {(b, h, s, d)} {name} "
                    f"causal={causal} window={window}", TOL[name][0])
        key = name if tc else "fma"
        err[key] = max(err[key], e)
    print(f"phase 5 flash_attention sweep ({len(cases)} cases): max abs "
          f"error bf16 {err['bfloat16']:.3g} and f32 {err['float32']:.3g} "
          f"(tensor-core kernel, {n_served['tc']} launches), f32 at D = 256 "
          f"{err['fma']:.3g} (FMA kernel, {n_served['fma']} launches)")
    f8 = flash_over_counts(torch, np)
    if any(f8["over_plain"]) or any(f8["over_exact"]):
        fail(f"flash_attention_tc bf16 outputs past 3e-2: {f8}")

    # the serving shape: smollm-135m prefill, 4 x 1024 tokens, 9 query
    # heads on 3 KV heads, head dim 64, causal; bf16 is the main path,
    # f32 the datum's (phase 7a)
    b, h, hkv, s, d = 4, 9, 3, 1024, 64
    pairs = s * (s + 1) // 2                        # causal (q, k) pairs
    flops = 4.0 * b * h * pairs * d                 # q·k and p·v
    out = {"f8_counts": f8}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        size = 2 if dtype == torch.bfloat16 else 4
        q, k, v = qkv(b, h, hkv, s, d, dtype)
        got = fa.flash_attention(q, k, v, causal=True)
        want = flash_attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        e = max_err(got, want, f"flash_attention serving shape {name}",
                    TOL[name][0])
        err[name] = max(err[name], e)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 50)
        plain = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                        10)
        # the library yardstick on the same inputs with K/V repeated per
        # query head (never called by the port)
        kr, vr = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kr, vr, is_causal=True), 50)
        nbytes = size * (2.0 * b * h * s * d + 2.0 * b * hkv * s * d)
        route, entry = fa.route(dtype, d)
        rec = dict(ms=ms, plain_ms=plain, library_ms=lib,
                   max_abs_err=err[name], serving_shape_err=e)
        if dtype == torch.bfloat16:
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes)
            extra = ""
        else:
            # f32 work: at the f32 FMA rate, or as the six bf16 products
            # of three parts a product at the bf16 tensor-core rate
            rec["bound_f32_fma_ms"] = bound(flops, nbytes,
                                            F32_FLOPS_PER_S)[0]
            rec["bound_ms"], rec["bound_by"] = bound(6 * flops, nbytes)
            # the FMA kernel on the same inputs, through launch()
            lib_fma = _build.library(fa.FMA_F32[0])
            o_fma = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream

            def run_fma():
                _build.check(fa.launch(lib_fma, q, k, v, o_fma, causal=True,
                                       window=None, stream=stream,
                                       entry=fa.FMA_F32[1]), "FMA launch")
            run_fma()
            torch.cuda.synchronize()
            e_fma = max_err(o_fma, want, "flash_attention FMA kernel, "
                            "serving shape f32", TOL[name][0])
            err["fma"] = max(err["fma"], e_fma)
            fma_ms = cuda_ms(run_fma, 50)
            out["fma"] = dict(ms=fma_ms, plain_ms=plain, library_ms=lib,
                              max_abs_err=err["fma"],
                              serving_shape_err=e_fma,
                              bound_ms=rec["bound_ms"],
                              bound_by=rec["bound_by"],
                              bound_f32_fma_ms=rec["bound_f32_fma_ms"])
            extra = (f"; bound at the f32 FMA rate "
                     f"{rec['bound_f32_fma_ms']:.5f} ms; the FMA kernel "
                     f"(flash_attention.cu, through launch) {fma_ms:.4f} ms"
                     f", max abs error {e_fma:.3g}")
        print(f"phase 5 {route} ({entry}) (4, 9, 1024, 64) {name} causal, "
              f"3 KV heads: max abs error {e:.3g}; kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, scaled_dot_product_attention "
              f"{lib:.4f} ms, bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_by']}: {flops / 1e9:.2f} GFLOP"
              + (" x 6 split products" if dtype == torch.float32 else "")
              + f", {nbytes / 1e6:.1f} MB); {ms / rec['bound_ms']:.1f}x the "
              f"bound" + extra)
        out[name] = rec
    return out


def ssd_inputs(torch, rng, b, s, h, p, n, dtype):
    """x, B, C as slices of one (B, S, H·P + 2N) tensor, as the model's
    conv output gives them; dt and A in f32."""
    xbc = torch.tensor(rng.standard_normal((b, s, h * p + 2 * n)),
                       dtype=torch.float32, device="cuda").to(dtype)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.tensor(rng.uniform(0.01, 0.2, (b, s, h)),
                      dtype=torch.float32, device="cuda")
    A = torch.tensor(-rng.uniform(0.5, 1.5, (h,)), dtype=torch.float32,
                     device="cuda")
    return x, dt, A, B, C


# The FMA kernel's time at the serving shape in bf16, measured on the H100
# before bf16 took the tensor-core route (PERF.md §6).
SSD_FMA_BF16_MS = 1.522


def ssd_over_counts(torch, np, seeds=range(8), limit=1e-1):
    """``ssd_scan_tc``'s bf16 outputs past ``limit`` at mamba2-1.3b's
    prefill shape, per seed, against the plain version and against the
    f64 evaluation rounded to bf16, on the inputs of
    ``kernels/ssd_tc_probe.py``; fails on any."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ssd_tc_probe as probe
    from repro_torch.kernels.ref import ssd_scan_ref
    out = dict(limit=limit, seeds=list(seeds), over_plain=[],
               over_exact=[], plain_over_exact=[])
    for seed in seeds:
        x, dt, A, B, C = probe.inputs(torch, np, seed)
        got = ss.ssd_scan(x, dt, A, B, C, chunk=128)[0].float()
        plain = ssd_scan_ref(x, dt, A, B, C, chunk=128)[0].float()
        exact = probe.exact_y(torch, x, dt, A, B, C, 128).bfloat16().float()
        out["over_plain"].append(int(((got - plain).abs() > limit).sum()))
        out["over_exact"].append(int(((got - exact).abs() > limit).sum()))
        out["plain_over_exact"].append(int(((plain - exact).abs() > limit)
                                           .sum()))
    print(f"phase 6 ssd_scan_tc bf16 outputs past {limit} at (4, 1024, 64, "
          f"64) N=128 chunk 128 over seeds {out['seeds']}: vs the plain "
          f"version {out['over_plain']}, vs the f64 evaluation rounded to "
          f"bf16 {out['over_exact']} (the plain version vs it "
          f"{out['plain_over_exact']})")
    if any(out["over_plain"]) or any(out["over_exact"]):
        fail(f"ssd_scan_tc bf16 outputs past {limit}: {out}")
    return out


def phase_ssd(torch, np):
    """Every route of ``ssd_scan`` against the plain version: the JAX sweep
    in both dtypes (the tensor-core kernel; each case's route checked by
    the launch counters), a carried-in state on a ragged length in each
    dtype, the sequential recurrence, mamba2-1.3b's prefill shape in bf16
    (the main path) and f32 (the datum's), timed beside the plain version
    and the bound (the FMA kernel, through ``launch``, held and timed
    there in f32 too), an f32 chunk outside the tensor-core limits (the
    FMA kernel), and the bf16 outputs past 1e-1 over 8 seeds."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.models.ssm import ssd_decode_step
    rng = np.random.default_rng(12)
    err = {"float32": 0.0, "bfloat16": 0.0, "fma": 0.0}
    n_served = {"tc": 0, "fma": 0}

    def check(args, chunk, name, what, init=None):
        tc0, fma0 = ss.launches_tc, ss.launches_fma
        y, fin = ss.ssd_scan(*args, chunk=chunk, init_state=init)
        wy, wfin = ssd_scan_ref(*args, chunk=chunk, init_state=init)
        torch.cuda.synchronize()
        served = (ss.launches_tc - tc0, ss.launches_fma - fma0)
        x, B = args[0], args[3]
        tc = ss.route(x.dtype, chunk, x.shape[-1], B.shape[-1])[0] \
            == "ssd_scan_tc"
        if served != ((1, 0) if tc else (0, 1)):
            fail(f"ssd_scan {what} served by (tc, fma) = {served}")
        n_served["tc" if tc else "fma"] += 1
        tol = TOL[name][1]
        e = max(max_err(y, wy, f"ssd_scan y {what}", tol),
                max_err(fin, wfin, f"ssd_scan state {what}", tol))
        key = name if tc else "fma"
        err[key] = max(err[key], e)
        return e

    n_cases = 0
    for b, s, h, p, n, chunk in SSD_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            check(ssd_inputs(torch, rng, b, s, h, p, n, dtype), chunk, name,
                  f"{(b, s, h, p, n, chunk)} {name}")
            n_cases += 1
    # a carried-in state on a ragged length, in each dtype (the chain of
    # the tensor-core kernel starts from it)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        args = ssd_inputs(torch, rng, 2, 200, 2, 64, 128, dtype)
        init = torch.tensor(rng.standard_normal((2, 2, 64, 128)),
                            dtype=torch.float32, device="cuda")
        check(args, 128, name, f"init_state, S=200 {name}", init)
        n_cases += 1
    # the sequential recurrence, token by token
    x, dt, A, B, C = ssd_inputs(torch, rng, 1, 128, 2, 16, 32,
                                torch.float32)
    y, fin = ss.ssd_scan(x, dt, A, B, C, chunk=64)
    state = torch.zeros((1, 2, 16, 32), device="cuda")
    ys = []
    for t in range(128):
        yt, state = ssd_decode_step(x[:, t], dt[:, t], A, B[:, t], C[:, t],
                                    state)
        ys.append(yt)
    torch.cuda.synchronize()
    e = max(max_err(y, torch.stack(ys, dim=1), "ssd_scan vs sequential y",
                    1e-3),
            max_err(fin, state, "ssd_scan vs sequential state", 1e-3))
    err["float32"] = max(err["float32"], e)
    print(f"phase 6 ssd_scan sweep ({n_cases} cases, init_state in each "
          f"dtype, sequential recurrence): max abs error bf16 "
          f"{err['bfloat16']:.3g} and f32 {err['float32']:.3g} (tensor-core "
          f"kernel, {n_served['tc'] + 1} launches)")

    # the serving shape: mamba2-1.3b prefill, 4 x 1024 tokens, 64 heads of
    # P = 64, N = 128, chunk 128; bf16 is the main path, f32 the datum's
    b, s, h, p, n, q = 4, 1024, 64, 64, 128, 128
    nc = s // q
    tri = q * (q + 1) / 2
    # the chunked algorithm's operations: C·Bᵀ (lower triangle, shared by
    # the heads) per (batch, chunk); per (batch, head, chunk) the masked
    # product with x, C·stateᵀ and the state update
    flops = 2.0 * (b * nc * tri * n + b * h * nc * (tri * p + 2 * q * n * p))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        size = 2 if dtype == torch.bfloat16 else 4
        args = ssd_inputs(torch, rng, b, s, h, p, n, dtype)
        e = check(args, q, name, f"serving shape {name}")
        y64, _ = ssd_scan_ref(*args, chunk=64)
        y128, _ = ssd_scan_ref(*args, chunk=128)
        floor = float((y64.float() - y128.float()).abs().max())
        ms = cuda_ms(lambda: ss.ssd_scan(*args, chunk=q), 20)
        plain = cuda_ms(lambda: ssd_scan_ref(*args, chunk=q), 5)
        nbytes = (size * 2.0 * b * s * h * p + 4.0 * b * s * h + 4.0 * h
                  + size * 2.0 * b * s * n + 4.0 * b * h * p * n)
        route, entry = ss.route(dtype, q, p, n)
        rec = dict(ms=ms, plain_ms=plain, library_ms=None,
                   max_abs_err=err[name], serving_shape_err=e,
                   plain_order_floor=floor)
        if dtype == torch.bfloat16:
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes)
            extra = (f"; the FMA kernel took {SSD_FMA_BF16_MS} ms on this "
                     f"shape in bf16 ({SSD_FMA_BF16_MS / ms:.1f}x this "
                     f"kernel's time)")
        else:
            # f32 work: at the f32 FMA rate, or as the three bf16 products
            # of two parts a product at the bf16 tensor-core rate
            rec["bound_f32_fma_ms"] = bound(flops, nbytes,
                                            F32_FLOPS_PER_S)[0]
            rec["bound_ms"], rec["bound_by"] = bound(3 * flops, nbytes)
            # the FMA kernel on the same inputs, through launch()
            x, dt, A, B, C = args
            lib_fma = _build.library(ss.FMA_F32[0])
            y_fma = torch.empty(x.shape, dtype=x.dtype, device="cuda")
            fin_fma = torch.empty((b, h, p, n), dtype=torch.float32,
                                  device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def run_fma():
                _build.check(ss.launch(lib_fma, x, dt, A, B, C, None, y_fma,
                                       fin_fma, chunk=q, stream=stream),
                             "FMA launch")
            run_fma()
            wy, wfin = ssd_scan_ref(*args, chunk=q)
            torch.cuda.synchronize()
            e_fma = max(max_err(y_fma, wy, "ssd_scan FMA kernel y, serving "
                                "shape", TOL[name][1]),
                        max_err(fin_fma, wfin, "ssd_scan FMA kernel state, "
                                "serving shape", TOL[name][1]))
            err["fma"] = max(err["fma"], e_fma)
            fma_ms = cuda_ms(run_fma, 20)
            out["fma"] = dict(ms=fma_ms, plain_ms=plain, library_ms=None,
                              max_abs_err=err["fma"],
                              serving_shape_err=e_fma,
                              bound_ms=rec["bound_ms"],
                              bound_by=rec["bound_by"],
                              bound_f32_fma_ms=rec["bound_f32_fma_ms"])
            extra = (f"; bound at the f32 FMA rate "
                     f"{rec['bound_f32_fma_ms']:.5f} ms; the FMA kernel "
                     f"(ssd_scan.cu, through launch) {fma_ms:.4f} ms, max "
                     f"abs error {e_fma:.3g}")
        print(f"phase 6 {route} ({entry}) (4, 1024, 64, 64) N=128 chunk 128 "
              f"{name}: max abs error {e:.3g} (limit {TOL[name][1]}; the "
              f"plain version at chunk 64 vs 128 differs by {floor:.3g}, "
              f"|y| up to {float(y128.float().abs().max()):.1f}); kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}: "
              f"{flops / 1e9:.2f} GFLOP"
              + (" x 3 split products" if dtype == torch.float32 else "")
              + f", {nbytes / 1e6:.1f} MB); {ms / rec['bound_ms']:.1f}x the "
              f"bound" + extra)
        out[name] = rec
    # f32 outside the tensor-core limits (chunk 32): the FMA kernel
    init = torch.tensor(rng.standard_normal((1, 3, 64, 128)),
                        dtype=torch.float32, device="cuda")
    e = check(ssd_inputs(torch, rng, 1, 200, 3, 64, 128, torch.float32), 32,
              "float32", "chunk 32, init_state, S=200 float32", init)
    print(f"phase 6 ssd_scan f32 at chunk 32 (outside the tensor-core "
          f"limits), init_state, S=200: the FMA kernel, max abs error "
          f"{e:.3g}")
    out["f7_counts"] = ssd_over_counts(torch, np)
    return out


def device_ms_by_kernel(torch, fn):
    """Device time of the kernels ``fn()`` launches (``torch.profiler``,
    CUDA activity): (total ms, the six largest as (name, ms, calls))."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:6]


def f32_prefill_device(torch, cfg, model, prompt, max_len):
    """Device time by kernel of one f32 datum prefill on its routes (the
    tensor-core kernels), and of the same prefill with the f32 routes of
    the config's kernel set to the FMA kernel (here only, restored after):
    ((total ms, largest), (total ms, largest))."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import transformer as T

    def run():
        with torch.inference_mode():
            T.prefill(model, {"tokens": prompt}, max_len)
    run()
    tc = device_ms_by_kernel(torch, run)
    mod = ss if cfg.attn_free else fa
    routes = mod.ROUTES
    fma = ((mod.FMA_F32, mod.FMA_F32) if cfg.attn_free
           else ((256, mod.FMA_F32),))
    try:
        mod.ROUTES = {**routes, torch.float32: fma}
        run()
        fma_run = device_ms_by_kernel(torch, run)
    finally:
        mod.ROUTES = routes
    return tc, fma_run


def breakdown(torch, model, prompt, steps: int):
    """Device ms of one prefill and of ``steps`` greedy decode steps."""
    from repro_torch.models import transformer as T
    s = prompt.shape[1]
    with torch.inference_mode():
        pre = device_ms_by_kernel(torch, lambda: T.prefill(
            model, {"tokens": prompt}, s + steps))
        logits, caches = T.prefill(model, {"tokens": prompt}, s + steps)

        def decode():
            tok, c = logits.argmax(dim=-1)[:, None], caches
            for i in range(steps):
                out, c = T.decode_step(model, tok, c, pos0=s + i)
                tok = out.argmax(dim=-1)[:, None]
        dec = device_ms_by_kernel(torch, decode)
    return pre, dec


# The bf16 serve's prefill logits on the tensor-core SSD route may differ
# from the same model's with the plain version swapped in by at most this
# share of each row's largest |logit|: a tenth of the 11 % that zeroing the
# SSD kernel moves them (serve_ref.json), see PERF.md.
SSD_BF16_SERVE_RTOL = 0.011


def ssd_plain_check(torch, model, prompt):
    """mamba2's bf16 prefill logits on the tensor-core route against the
    same model with ``ssd_scan_ref`` swapped into ``models.ssm`` (here
    only, never on the main path), and the same with the plain version at
    chunk 64 against chunk 128 (the bf16 model's own order floor)."""
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    s = prompt.shape[1]

    def logits():
        with torch.inference_mode():
            return T.prefill(model, {"tokens": prompt}, s + 1)[0].float()

    def rel(a, b):
        return float(((a - b).abs().max(dim=1).values
                      / b.abs().max(dim=1).values).max())

    kernel = logits()
    route = ssm.ssd_scan
    try:
        ssm.ssd_scan = lambda *a, **k: ssd_scan_ref(*a, **k)
        plain = logits()
        ssm.ssd_scan = lambda *a, **k: ssd_scan_ref(*a, **dict(k, chunk=64))
        plain64 = logits()
    finally:
        ssm.ssd_scan = route
    r, floor = rel(kernel, plain), rel(plain64, plain)
    agree = int((kernel.argmax(dim=1) == plain.argmax(dim=1)).sum())
    print(f"phase 7b mamba2-1.3b bf16 prefill logits, tensor-core SSD route "
          f"vs the plain version swapped in: largest relative difference "
          f"{r:.3g} (limit {SSD_BF16_SERVE_RTOL}; plain at chunk 64 vs 128: "
          f"{floor:.3g}); greedy tokens agree on {agree}/{kernel.shape[0]}")
    if not r <= SSD_BF16_SERVE_RTOL:
        fail(f"mamba2 bf16 prefill logits off the plain version by {r:.3g} "
             f"relative (limit {SSD_BF16_SERVE_RTOL})")
    return dict(rel=r, plain_order_floor=floor, greedy_agree=agree,
                rows=kernel.shape[0])


def phase_serve(torch, np):
    """Phase 7: each config at full width and depth: (a) the f32 copy
    against serve_ref.json; (b) the published bf16 config served."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import cell_scan as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import tat_lookup as tl
    from repro_torch.launch.serve import random_prompt, serve
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import numpy_params, params_from_reference
    with open(os.path.join(ROOT, "src", "repro_torch", "testdata",
                           "serve_ref.json")) as f:
        ref = json.load(f)
    rtol = ref["rtol"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch in ("smollm-135m", "mamba2-1.3b"):
        d = ref["configs"][arch]
        cfg = get_config(arch)
        t0 = time.time()
        tree = numpy_params(cfg, d["seed"])
        fill_s = time.time() - t0

        # (a) the datum, f32, teacher-forced on the reference's tokens
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        model = params_from_reference(cfg32, tree, "cuda")
        prompt = torch.tensor(d["prompt"], device="cuda")
        worst, checked, agree = 0.0, 0, 0
        fa.launches_fma = fa.launches_tc = 0
        ss.launches_fma = ss.launches_tc = 0
        with torch.inference_mode():
            logits, caches = T.prefill(model, {"tokens": prompt},
                                       d["prompt_len"] + d["decode_steps"])
            for i, st in enumerate(d["steps"]):
                ids = torch.tensor(st["ids"], device="cuda")
                want = torch.tensor(st["logits"], device="cuda")
                got = torch.gather(logits, 1, ids)
                scale = want.abs().max(dim=1).values
                rel = float(((got - want).abs().max(dim=1).values
                             / scale).max())
                worst = max(worst, rel)
                if rel > rtol or not bool(torch.isfinite(logits).all()):
                    fail(f"{arch} f32 step {i}: logits off the reference "
                         f"by {rel:.3g} relative (limit {rtol})")
                margin = (want[:, 0] - want[:, 1]) / scale
                top1 = logits.argmax(dim=1)
                for j in range(ids.shape[0]):
                    if float(margin[j]) > rtol:
                        checked += 1
                        if int(top1[j]) != int(ids[j, 0]):
                            fail(f"{arch} f32 step {i} seq {j}: greedy "
                                 f"{int(top1[j])}, reference "
                                 f"{int(ids[j, 0])}")
                    agree += int(top1[j]) == int(ids[j, 0])
                if i == d["decode_steps"]:
                    break
                logits, caches = T.decode_step(model, ids[:, :1], caches,
                                               pos0=d["prompt_len"] + i)
        torch.cuda.synchronize()
        del caches, logits
        routes32 = dict(flash_attention_fma=fa.launches_fma,
                        flash_attention_tc=fa.launches_tc,
                        ssd_scan_fma=ss.launches_fma,
                        ssd_scan_tc=ss.launches_tc)
        want32 = dict(flash_attention_fma=0,
                      flash_attention_tc=0 if cfg.attn_free
                      else cfg.n_layers, ssd_scan_fma=0,
                      ssd_scan_tc=cfg.n_layers if cfg.attn_free else 0)
        if routes32 != want32:
            fail(f"{arch} f32 prefill took routes {routes32}, expected "
                 f"{want32}")
        print(f"phase 7a {arch} f32 ({cfg.n_layers} layers, {d['batch']} x "
              f"{d['prompt_len']} prompt + {d['decode_steps']} decode steps)"
              f": logits within {worst:.3g} relative of serve_ref.json "
              f"(limit {rtol}); greedy tokens equal on {checked} checked "
              f"(margin > limit), {agree}/{len(d['steps']) * d['batch']} "
              f"in all; kernel routes {json.dumps(routes32)}; numpy weight "
              f"fill {fill_s:.1f} s")
        (pre32_ms, pre32_top), (fma32_ms, fma32_top) = f32_prefill_device(
            torch, cfg, model, prompt, d["prompt_len"] + d["decode_steps"])
        print(f"phase 7a {arch} f32 datum prefill device time "
              f"(torch.profiler): {pre32_ms:.2f} ms on the tensor-core "
              f"routes; {fma32_ms:.2f} ms with the FMA route swapped in")
        for what, top in (("tensor-core routes", pre32_top),
                          ("FMA route", fma32_top)):
            for name, ms, calls in top:
                print(f"  f32 prefill, {what}: {ms:9.3f} ms {calls:6d} calls"
                      f"  {name[:80]}")
        del model

        # (b) the published bf16 config, served: 4 x 1024 prompt, 64 steps
        torch.cuda.empty_cache()
        model = params_from_reference(cfg, tree, "cuda")
        del tree
        prompt = random_prompt(cfg.vocab, 4, 1024, 0, "cuda")
        # warm-up at the served shape: builds, and the caching allocator's
        # blocks, so the timed run's prefill wall holds no first-call
        # cudaMalloc
        serve(model, prompt, 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches_tc = fa.launches_fma = 0
        ss.launches_tc = ss.launches_fma = 0
        tl.launches = cs.launches = 0
        res = serve(model, prompt, 64)
        counts = dict(flash_attention_tc=fa.launches_tc,
                      flash_attention_fma=fa.launches_fma,
                      ssd_scan_tc=ss.launches_tc,
                      ssd_scan_fma=ss.launches_fma, tat_lookup=tl.launches,
                      cell_scan=cs.launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if res.tokens.shape != (4, 64) or res.tokens.min() < 0 \
                or res.tokens.max() >= cfg.vocab:
            fail(f"{arch} served tokens of shape {res.tokens.shape}")
        want = dict(flash_attention_tc=cfg.n_layers if not cfg.attn_free
                    else 0, flash_attention_fma=0,
                    ssd_scan_tc=cfg.n_layers if cfg.attn_free else 0,
                    ssd_scan_fma=0, tat_lookup=0, cell_scan=0)
        if counts != want:
            fail(f"{arch} serve launched {counts}, expected {want} (one "
                 f"prefill launch per layer)")
        tok_s = 4 * 64 / res.decode_s
        print(f"phase 7b {arch} bf16 served 4 x 1024 prompt + 64 greedy "
              f"steps: prefill {res.prefill_s * 1e3:.1f} ms, decode "
              f"{res.decode_s * 1e3:.1f} ms ({tok_s:.1f} tokens/s); "
              f"launches {json.dumps(counts)}; peak memory {peak:.2f} GiB; "
              f"first tokens {res.tokens[0, :8].tolist()}")
        (pre_ms, pre_top), (dec_ms, dec_top) = breakdown(torch, model,
                                                         prompt, 8)
        step_wall = res.decode_s * 1e3 / 64
        print(f"phase 7b {arch} device time (torch.profiler): prefill "
              f"{pre_ms:.2f} ms, {100 * pre_ms / (res.prefill_s * 1e3):.1f}"
              f" % of its wall; decode {dec_ms / 8:.3f} ms per step, "
              f"{100 * dec_ms / 8 / step_wall:.1f} % of its "
              f"{step_wall:.2f} ms wall")
        for what, top in (("prefill", pre_top), ("decode x8", dec_top)):
            for name, ms, calls in top:
                print(f"  {what}: {ms:9.3f} ms {calls:6d} calls  "
                      f"{name[:90]}")
        plain_check = (ssd_plain_check(torch, model, prompt)
                       if cfg.attn_free else None)
        out[arch] = dict(counts=counts, counts_f32_datum=routes32,
                         f32_prefill_device_ms=pre32_ms,
                         f32_prefill_device_ms_fma_route=fma32_ms,
                         bf16_vs_plain_ssd=plain_check,
                         prefill_ms=res.prefill_s * 1e3,
                         decode_ms=res.decode_s * 1e3, decode_tok_s=tok_s,
                         peak_gib=peak, datum_rel=worst,
                         prefill_device_ms=pre_ms,
                         decode_step_device_ms=dec_ms / 8)
        del model
        torch.cuda.empty_cache()
    return out


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
    if len(sys.argv) == 3 and sys.argv[1] == "--against":
        _build.build_all(("cell_scan", "cell_scan_profile"))
        print(json.dumps({"against": compare_against(torch, np,
                                                     sys.argv[2])}))
        return 0
    t0 = time.time()
    sources = _build.SOURCES + ("smem_probe",) + tuple(_build.VARIANTS)
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
    scan_profile = phase_cell_scan_profile(torch, traces, configs, full)
    chains = phase_chains(torch, np, smem_ns)
    flash = phase_flash(torch, np)
    ssd = phase_ssd(torch, np)
    served = phase_serve(torch, np)

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
             main_path_wall_s=main_path["wall_s"],
             main_path_ns_per_step=main_path["main_ms"] * 1e6
             / main_path["main_steps"],
             cholesky_section_ns_per_step=scan_profile["sections"]),
        dict(name="cell_scan_chain", route="cuda",
             source="src/repro_torch/kernels/csrc/cell_scan.cu",
             replaces="src/repro/core/engine/step.py:102",
             entry="cell_scan_launch with n_deep > 0 (the deep-hop rows "
                   "of engine/chain.py)",
             launches=chains["fig1"]["counts"]["cell_scan"],
             main_path="phase 8a: simulate_grid over Fig. 1's depth sweep "
                       "at its published size (21 cells, D = 3); phase 8b "
                       "launched it once more over the chained paper grid",
             launches_chained_grid=chains["grid_b"]["counts"]["cell_scan"],
             max_abs_err=chains["max_abs_err"], ms=chains["fig1"]["ms"],
             plain_ms=chains["fig1"]["plain_s"] * 1e3,
             plain_note="the eager scan_cell's seconds summed over the 21 "
                        "cells (run on the host, a pool of processes)",
             bound_ms=chains["fig1"]["bound_ms"], bound_by="bytes",
             library_ms=None,
             shape="Fig. 1 sweep: 1 core, 2000 persist/read pairs, NoPB "
                   "depths 0-4, PB and PB_RF depths 1-4 and crashed",
             fig1_steps=chains["fig1"]["steps"],
             fig1_latency_bound_ms=chains["fig1"]["steps"] * smem_ns / 1e6,
             fig1_persist_norm=chains["fig1"]["persist_norm"],
             fig1_hop_recovery=chains["fig1"]["hop_recovery"],
             chained_grid_ms=chains["grid_b"]["ms"],
             chained_grid_steps=chains["grid_b"]["steps"],
             chained_grid_ns_per_step=chains["grid_b"]["ms"] * 1e6
             / chains["grid_b"]["steps"],
             chained_grid_bound_ms=chains["grid_b"]["bound_ms"],
             chained_grid_latency_bound_ms=chains["grid_b"]["steps"]
             * smem_ns / 1e6,
             chained_grid_wall_s=chains["grid_b"]["wall_s"],
             chain_section_ns_per_step={
                 k: {c: v["ns_per_step"] for c, v in p["cells"].items()}
                 for k, p in chains["profile"].items()},
             oracle_cells=chains["oracle_cells"]),
        dict(name="flash_attention_tc", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
             replaces="src/repro/kernels/flash_attention.py:68",
             entry="flash_attention_tc_launch",
             launches=served["smollm-135m"]["counts"]["flash_attention_tc"],
             main_path="smollm-135m bf16 serve, 4 x 1024 prompt + 64 "
                       "decode steps: one launch per layer at prefill "
                       "(the bf16 route of flash_attention)",
             f8_counts=flash["f8_counts"],
             max_abs_err=flash["bfloat16"]["max_abs_err"],
             ms=flash["bfloat16"]["ms"],
             plain_ms=flash["bfloat16"]["plain_ms"],
             bound_ms=flash["bfloat16"]["bound_ms"],
             bound_by=flash["bfloat16"]["bound_by"],
             library_ms=flash["bfloat16"]["library_ms"],
             library="scaled_dot_product_attention (K/V repeated per "
                     "query head)",
             shape="q (4, 9, 1024, 64), k/v (4, 3, 1024, 64), bf16, "
                   "causal"),
        dict(name="flash_attention_tc_f32", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
             replaces="src/repro/kernels/flash_attention.py:68",
             entry="flash_attention_tc_f32_launch",
             launches=served["smollm-135m"]["counts_f32_datum"][
                 "flash_attention_tc"],
             main_path="smollm-135m f32 datum prefill of phase 7a "
                       "(2 x 256 prompt): one launch per layer (the f32 "
                       "route of flash_attention at D <= 128)",
             max_abs_err=flash["float32"]["max_abs_err"],
             ms=flash["float32"]["ms"],
             plain_ms=flash["float32"]["plain_ms"],
             bound_ms=flash["float32"]["bound_ms"],
             bound_by=flash["float32"]["bound_by"],
             bound_note="six bf16 products a product at the bf16 "
                        "tensor-core peak; bound_f32_fma_ms: the f32 work "
                        "at the f32 FMA rate",
             bound_f32_fma_ms=flash["float32"]["bound_f32_fma_ms"],
             library_ms=flash["float32"]["library_ms"],
             library="scaled_dot_product_attention in f32 (K/V repeated "
                     "per query head)",
             shape="q (4, 9, 1024, 64), k/v (4, 3, 1024, 64), f32, "
                   "causal"),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:68",
             entry="flash_attention_launch",
             launches=served["smollm-135m"]["counts"]["flash_attention_fma"]
             + served["smollm-135m"]["counts_f32_datum"][
                 "flash_attention_fma"],
             main_path="the f32 route of flash_attention at D = 256: not "
                       "launched by the bf16 serve or the f32 datum "
                       "prefill (D = 64); held and timed through launch() "
                       "at the serving shape in phase 5",
             max_abs_err=flash["fma"]["max_abs_err"],
             ms=flash["fma"]["ms"], plain_ms=flash["fma"]["plain_ms"],
             bound_ms=flash["fma"]["bound_ms"],
             bound_by=flash["fma"]["bound_by"],
             bound_f32_fma_ms=flash["fma"]["bound_f32_fma_ms"],
             library_ms=flash["fma"]["library_ms"],
             library="scaled_dot_product_attention in f32 (K/V repeated "
                     "per query head)",
             shape="q (4, 9, 1024, 64), k/v (4, 3, 1024, 64), f32, "
                   "causal"),
        dict(name="ssd_scan_tc", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan_tc.cu",
             replaces="src/repro/kernels/ssd_scan.py:68",
             entry="ssd_scan_tc_launch",
             launches=served["mamba2-1.3b"]["counts"]["ssd_scan_tc"],
             main_path="mamba2-1.3b bf16 serve, 4 x 1024 prompt + 64 "
                       "decode steps: one launch per layer at prefill "
                       "(the bf16 route of ssd_scan)",
             f7_counts=ssd["f7_counts"],
             max_abs_err=ssd["bfloat16"]["max_abs_err"],
             serving_shape_err=ssd["bfloat16"]["serving_shape_err"],
             plain_order_floor=ssd["bfloat16"]["plain_order_floor"],
             ms=ssd["bfloat16"]["ms"], plain_ms=ssd["bfloat16"]["plain_ms"],
             bound_ms=ssd["bfloat16"]["bound_ms"],
             bound_by=ssd["bfloat16"]["bound_by"], library_ms=None,
             serve_logits_vs_plain=served["mamba2-1.3b"][
                 "bf16_vs_plain_ssd"],
             shape="x (4, 1024, 64, 64), N=128, chunk 128, bf16"),
        dict(name="ssd_scan_tc_f32", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan_tc.cu",
             replaces="src/repro/kernels/ssd_scan.py:68",
             entry="ssd_scan_tc_f32_launch",
             launches=served["mamba2-1.3b"]["counts_f32_datum"][
                 "ssd_scan_tc"],
             main_path="mamba2-1.3b f32 datum prefill of phase 7a "
                       "(2 x 256 prompt): one launch per layer (the f32 "
                       "route of ssd_scan inside the tensor-core limits)",
             max_abs_err=ssd["float32"]["max_abs_err"],
             serving_shape_err=ssd["float32"]["serving_shape_err"],
             ms=ssd["float32"]["ms"], plain_ms=ssd["float32"]["plain_ms"],
             bound_ms=ssd["float32"]["bound_ms"],
             bound_by=ssd["float32"]["bound_by"],
             bound_note="bytes at 3.35 TB/s or three bf16 products a "
                        "product at the bf16 tensor-core peak; "
                        "bound_f32_fma_ms: the f32 work at the f32 FMA rate",
             bound_f32_fma_ms=ssd["float32"]["bound_f32_fma_ms"],
             library_ms=None,
             shape="x (4, 1024, 64, 64), N=128, chunk 128, f32"),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:68",
             entry="ssd_scan_launch",
             launches=served["mamba2-1.3b"]["counts"]["ssd_scan_fma"]
             + served["mamba2-1.3b"]["counts_f32_datum"]["ssd_scan_fma"],
             main_path="the f32 route of ssd_scan outside the tensor-core "
                       "limits: not launched by the bf16 serve or the f32 "
                       "datum prefill; held through the wrapper at chunk "
                       "32 and through launch() at the serving shape "
                       "(timed) in phase 6",
             max_abs_err=ssd["fma"]["max_abs_err"],
             serving_shape_err=ssd["fma"]["serving_shape_err"],
             ms=ssd["fma"]["ms"], plain_ms=ssd["fma"]["plain_ms"],
             bound_ms=ssd["fma"]["bound_ms"],
             bound_by=ssd["fma"]["bound_by"],
             bound_f32_fma_ms=ssd["fma"]["bound_f32_fma_ms"],
             library_ms=None,
             shape="x (4, 1024, 64, 64), N=128, chunk 128, f32"),
    ]
    print(json.dumps({"serve": served}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
