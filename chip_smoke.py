#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

It imports only ``repro_torch`` (never JAX or the ``repro`` package),
builds the port's kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch/``, and runs ten phases, each printing its own
lines:

1. the card (``nvidia-smi`` name and power limit), the kernel build, and
   the latency of one dependent shared-memory load (``smem_probe.cu``),
   the unit of the cell scan's latency bound;
2. the ``tat_lookup`` kernel against its plain version on the card, at
   the Pallas test sweep's shapes and the engine's (R=8, N=16), exact;
3. the cell-scan kernel against the eager ``scan_cell`` (run on the
   host, a pool of processes) on the 7 workloads x NoPB/PB/PB_RF at ``persist_budget=2000``,
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
   card: the JAX sweep (bf16 and f32 on the tensor-core kernels, f32 at
   head dim 256 on the wide one, causal with and without a window, one
   non-causal case each; 2e-5 / 3e-2; each case's route checked by its
   launch counters), the tensor-core kernel's bf16 outputs past 3e-2
   over 8 seeds at smollm-135m's prefill shape (none allowed), and that
   shape in bf16 (the main path) and f32 (the f32 tensor-core route
   beside the FMA kernel, run through ``launch``), timed beside the plain
   version and ``scaled_dot_product_attention``; then f32 at D = 256 in
   gemma2-2b's head layout, q (4, 8, 1024, 256) and k/v (4, 4, 1024,
   256), causal: the wide kernel's outputs past 2e-5 over 8 seeds (none
   allowed) and its launches by entry, and its time in turns with the
   FMA kernel (through ``launch``) beside the plain version, the bound
   and ``scaled_dot_product_attention`` in f32;
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

9. (run after phase 8, before 5) fan-out fabrics through the cell
   scan's FAB instantiation: (a) ``benchmarks/fig_fabric.py``'s grid at
   its published size (8 tenants, one core each, 1500 persist/read pairs
   a core; PB and PB_RF x 1/2/4/8 leaves over 16 leaf PBEs, spine 8 x
   packed/spread x ``bp_high`` None/4, and a replica of each crashed at
   half the op span; 52 cells, ``D = 1``, NL = 8) and (b) the 7
   workloads at ``persist_budget=100_000``, 8 tenants, PB and PB_RF x
   {2 leaves packed, 4 leaves spread with ``bp_high`` 4} (28 cells),
   each through ``simulate_grid`` with its launch counts, exact against
   ``src/repro_torch/testdata/fabric_ref.json`` (all 52 + 28 cells),
   timed with its bounds beside the same traces under the plain 2-hop
   chain (the ``FAB = false`` kernel); (c) the kernel against the eager
   ``scan_cell`` (a pool of host processes) on all 52 cells of (a) at
   fig_fabric's smoke size (150 pairs); (d) the section profile of a
   fabric step (cholesky's 4 cells of (b)); (e) 300 fuzzed fabric crash
   cells on the card against the port's oracle; and, given
   ``--sass-against OLD.cu [OLD_FLASH.cu]``, (f)
   ``repro_torch.kernels.sass_diff`` of every instantiation against
   ``OLD.cu`` (every ``MAC = false`` one must be identical), with the
   registers and stack frame of each, and of every kernel of
   ``flash_attention_tc.cu`` that ``OLD_FLASH.cu`` also has (each must be
   identical).

10. (run after phase 9, before 5) epoch schedules through the cell
    scan's EP instantiation: (a) ``benchmarks/fig_dynamic.py``'s grid at
    its published size (raytrace on 4 cores re-timed by
    ``DiurnalArrivals`` at 0.5, 2 and 8 Mops/s a core,
    ``persist_budget=25_000``; a 2-leaf PB_RF pool under static quotas,
    a quota step and a placement flip at half the op span, each live and
    crashed at 3/4 of it; 18 cells, ``E = 2``, ``D = 1``, NL = 2) through
    ``simulate_grid`` and (b) the 7 workloads at
    ``persist_budget=100_000``, PB and PB_RF at ``n_switches`` 2 under a
    drain-threshold tighten and an SLO target switched on at half the
    workload's PB/2 runtime (28 cells) through ``simulate_cells``, each
    with its launch counts, exact against
    ``src/repro_torch/testdata/dynamic_ref.json`` (all 18 + 28 cells),
    with the persist tails and the crashed cells' per-leaf recovery of
    (a), each timed with its bounds; (c) the kernel against the eager
    ``scan_cell`` (a pool of host processes) on (a)'s 12 cells at
    fig_dynamic's smoke size; (d) (b)'s cells as schedules of two equal
    epochs (``E = 2``) beside the same static configs (``E = 1``): equal
    outputs, the kernel time and ns per step of each, the section profile
    of cholesky's cells in both, and ptxas's registers and stack frames
    of every instantiation; (e) 275 fuzzed crash cells of the epoch
    matrix (``tests/test_crash_differential.py``) on the card against
    the port's oracle; (g) every instantiation of
    ``cell_scan_kernel<SPL, D, FAB, EP, MAC>`` (84: SPL 1, 2, 4 x D = 0
    and D = 1..3 x FAB both ways x EP both ways x MAC both ways)
    launched through ``simulate_grid`` on smoke-size grids that mix cells
    to select it (the deepest row sets D, a multi-leaf fabric FAB, a
    ``Schedule`` EP, the largest hop SPL, ``macro`` MAC; threshold steps
    over chains of 2-4 switches and a scheduled fabric beside them), each
    asserted through the wrapper's launch record and exact against the
    eager ``scan_cell`` with macro-steps on (the MAC ones' counters too),
    with a coverage line.  ``--sass-against OLD.cu`` (9f) diffs every
    instantiation (the ``MAC = false`` ones must be identical).

11. (run after phase 10, before 5) macro-steps through the cell scan's
    MAC instantiation, which ``simulate_grid``, ``simulate_cells`` and
    ``simulate`` run by default (so phases 4 and 8-10 already ran it on
    their grids, and held their outputs to the datums): (a) the paper
    grid and (b) Fig. 1's sweep, fig_fabric, fig_dynamic and phase 3's
    crash cells through the default once more, the launch record showing
    a MAC instantiation and ``last_macro_hit_rate`` /
    ``last_macro_abort_reasons`` equal to
    ``src/repro_torch/testdata/macro_ref.json``'s sums; then each of
    them, and the chained, fabric and scheduled paper grids, through the
    kernel with macro-steps on and off: the same state outputs, every
    cell's slots run as macro-steps and six abort counts equal to
    macro_ref.json's (the JAX reference's, cell by cell), both timed in
    turns (off, on, on, off) with the hit rate and the reasons; (c) the
    MAC kernel against the eager ``scan_cell`` with macro-steps on (a
    pool) on phase 3's budget-2000 grid and crash cells, counters
    included.  Phase 3 itself runs the grid and crash cells with
    macro-steps off, and the section profiles (phases 4, 8d, 9d, 10d)
    run the profile build, SPL 1 and ``MAC = false`` only, against the
    main path's state outputs.

``python3 chip_smoke.py --against OLD.cu [B.cu ...]`` runs only a
comparison of the package's cell scan with each other ``cell_scan.cu``
(an earlier revision's, or a variant of
``repro_torch.kernels.cell_scan_variants``; its headers beside it or the
package's) on the paper grid,
Fig. 1's sweep, the chained paper grid, fig_fabric, the fabric paper
grid, fig_dynamic, the scheduled paper grid and its cells static at D =
1: outputs equal but for the lookup counts, kernel times in the order
other, this, this, other (with macro-steps off, and on too against a
source that has them), both section profiles of cholesky's cells in
each grid that names them (and Fig. 1's PB/4 and PB_RF/4), and
cholesky's depth-1 cells through the D = 0 and the D = 3 instantiation
of each; it prints the card and one JSON line.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 peak (NVIDIA data sheet)
SCHEME_KEYS = ("pb", "pb_rf")
# the cell-scan outputs only its MAC instantiation counts
MACRO_FIELDS = ("macro_ops", "macro_aborts")


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def stop_children() -> None:
    """Leave no process behind.  The first pool of spawned processes
    (:func:`eager_grids`) starts multiprocessing's resource tracker, a
    child that would outlive the script until it reads the end of its
    pipe: close the pipe and wait for it.  Then end, and name on stderr,
    any other child still running."""
    import signal
    from multiprocessing import resource_tracker
    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        if tracker._fd is not None and tracker._pid is not None:
            os.close(tracker._fd)
            tracker._fd = None
            os.waitpid(tracker._pid, 0)
            tracker._pid = None
    me = os.getpid()
    kids = set()
    for task in os.listdir(f"/proc/{me}/task"):
        with open(f"/proc/{me}/task/{task}/children") as f:
            kids.update(int(k) for k in f.read().split())
    for pid in sorted(kids):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            os.kill(pid, signal.SIGTERM)
            os.waitpid(pid, 0)
        except (FileNotFoundError, ProcessLookupError, ChildProcessError):
            continue
        print(f"chip_smoke: ended child {pid}: {cmd[:200]}", file=sys.stderr)


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
               D: int = 0, NL: int = 1, E: int = 1,
               macro: bool = False) -> float:
    """Bytes the cell scan must move: each trace op (op, addr, gap) and
    stream length read once, the config tables read once, every output
    written once (D: the grid's deep-hop rows; NL > 1: the grid's fabric
    leaves, whose table and per-leaf survivors the kernel moves too;
    E > 1: the grid's schedule epochs, whose bounds and rows past epoch
    0 the kernel reads; macro: each op's run length read once and the
    counters written)."""
    from repro_torch.core.engine.state import N_HOP_STATS, N_STATS
    from repro_torch.kernels.cell_scan import (CHAIN_KEYS, DEEP_KEYS,
                                               EPOCH_DEEP_KEYS,
                                               EPOCH_SC_KEYS, FAB_KEYS,
                                               SC_KEYS, TENANT_KEYS)
    inputs = sum(12 * t.total_ops + 4 * t.n_cores for t in traces)
    inputs += 8 * n_cfg * (len(SC_KEYS) + len(TENANT_KEYS) * T
                           + len(CHAIN_KEYS) + len(DEEP_KEYS) * max(D, 1))
    inputs += 4 * n_cfg + 8 * n_cells
    outputs = n_cells * (8 + 8 * T * N_STATS + 8 * (D + 1) * N_HOP_STATS
                         + 4 * A + 8 + 8 + 8 * T + 8 * (D + 1) + 8 + 8)
    if NL > 1:
        inputs += 8 * n_cfg * (len(FAB_KEYS) + NL + T)
        outputs += n_cells * 8 * NL
    if E > 1:
        n_ep = (len(EPOCH_SC_KEYS) + len(TENANT_KEYS) * T
                + len(EPOCH_DEEP_KEYS) * max(D, 1) + T)
        inputs += 8 * n_cfg * (E - 1) * (n_ep + 1)
    if macro:
        inputs += sum(t.total_ops for t in traces)
        outputs += n_cells * 8 * 7
    return float(inputs + outputs)


def phase_cell_scan(torch, smem_ns):
    from repro_torch.core import PCSConfig, Scheme, WORKLOADS, make_trace
    from repro_torch.core.engine.grid import cell_inputs
    from repro_torch.kernels import cell_scan as cs
    names = list(WORKLOADS)
    traces = [make_trace(n, persist_budget=2000) for n in names]
    configs = [PCSConfig(scheme=s) for s in Scheme]
    pairs = [(i, j) for i in range(len(traces)) for j in range(len(configs))]
    # macro-steps off: the slot-at-a-time instantiation and its plain
    # version (phase 11 runs the MAC one on the same grid)
    args, kw = cell_inputs(traces, configs, [p[0] for p in pairs],
                           [p[1] for p in pairs], macro=False, device="cpu")
    plain, plain_s, pool_s = eager_cells(torch, args, kw,
                                         list(range(len(pairs))))
    plain_ms = plain_s * 1e3
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
          f"scan_cell {plain_s:.1f} s of cells ({pool_s:.1f} s wall over a "
          f"pool), longest cell "
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
                             track_addrs=64, macro=False, device="cpu")
    cplain = eager_cells(torch, cargs, ckw, list(range(len(cpairs))))[0]
    cgot = cs.cell_scan(*[a.cuda() for a in cargs], **ckw)
    torch.cuda.synchronize()
    err = max(err, compare_outputs(cplain, cgot, "crash cells"))
    print(f"phase 3 cell_scan crash cells: exact on {len(cpairs)} cells "
          f"(durable_ver, recovery_entries {cplain.n_recov.tolist()}, "
          f"recovery_ns)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, max_abs_err=err,
                max_steps=max_steps, latency_bound_ms=latency_bound,
                grid=(traces, configs, pairs, plain),
                crash=(crash_traces, crash_cfgs, cpairs, cplain))


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
    plain, plain_s, pool_s = eager_cells(torch, args, kw, sel)
    sel_t = torch.tensor(sel, device="cuda")
    err = compare_outputs(plain, cs.CellScanOut(*(x[sel_t] for x in got)),
                          f"paper grid {traces[i].name}")
    print(f"phase 3 cell_scan full size: exact on the {len(sel)} cells of "
          f"{traces[i].name} ({int(plain.steps.max())} steps, eager "
          f"scan_cell {plain_s:.1f} s of cells, {pool_s:.1f} s wall over a "
          f"pool)")
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
    cs.launches_by = {}
    t0 = time.time()
    cells = simulate_grid(traces, configs)          # default device: CUDA
    wall = time.time() - t0
    counts = dict(cell_scan=cs.launches, tat_lookup=tl.launches)
    # the default runs the macro-steps: the MAC instantiation
    mac_launches = sum(v for k, v in cs.launches_by.items() if k[4])
    # The match routine runs inside the cell-scan kernel, which counts
    # its calls on the device; read from the kernel's run on the main
    # path's inputs (phase 3), which the run above repeats exactly.
    args, kw, out, _ = full
    match_calls = int(out.lookups.sum())
    print(f"phase 4 simulate_grid (paper grid, 21 cells) wall {wall:.3f} s; "
          f"launches {json.dumps(counts)}; tat_lookup match-routine calls "
          f"inside cell_scan {match_calls}")
    if counts["cell_scan"] < 1 or match_calls < 1 or mac_launches < 1:
        fail(f"main path did not run through the kernels: {counts}, "
             f"{match_calls} match calls, {cs.launches_by}")

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
                mac_launches=mac_launches,
                main_ms=main_ms, main_bound_ms=bound,
                main_steps=main_steps, wall_s=wall,
                main_latency_bound_ms=latency_bound)


PROF_SECTIONS = ("merge_keys", "merge_argmin", "merge_fetch", "read",
                 "persist_lookup", "occupancy", "victim_select",
                 "drain_policy", "state_writes", "stats", "other_ops",
                 "bookkeeping", "chain_batch", "chain_read", "chain_fifo",
                 "chain_match", "chain_alloc", "chain_writer",
                 "chain_drain_rank", "chain_land", "macro")
OP_NAMES = ("compute", "dram_read", "dram_write", "pm_read", "persist",
            "barrier")


def profile_cells(torch, args, kw, got, sel, labels, libs=None,
                  abi="this", macro=False):
    """The section profile of a step on cells ``sel`` of the kernel's
    inputs ``args``: ``cell_scan.cu`` built with ``-DCELL_SCAN_PROFILE``
    (``_build.VARIANTS``: SPL 1) beside the uninstrumented build, both
    with macro-steps on or off by ``macro``, both exact against ``got``
    (the main path's outputs; the lookup counts too; the macro counters
    too with ``macro``).
    ``libs``: the (uninstrumented, profile) libraries, the package's by
    default (``abi``: their argument list, :func:`launch_abi`).  Returns
    ``{label:
    {ns_per_step, total_ns_per_step, steps, ops}}`` (sections with no
    cycles left out) and both kernel times."""
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
        out = cs._empty_out(len(sel), T, A, kw["n_deep_max"], "cuda",
                            kw["n_leaves_max"])
        _build.check(launch_abi(abi, lib, ins, out, max_pbe=kw["max_pbe"],
                                pm_banks=kw["pm_banks"],
                                n_track=kw["n_track"],
                                n_deep=kw["n_deep_max"],
                                n_leaves=kw["n_leaves_max"], stream=stream,
                                macro=macro),
                     f"{name} launch")
        outs[name] = out
    prof_ms = cuda_ms(lambda: run("profile", prof_lib), 1)
    plain_ms = cuda_ms(lambda: run("uninstrumented", plain_lib), 1)
    want = cs.CellScanOut(*(x[sel_t] for x in got))
    for name, out in outs.items():
        for f in cs.CellScanOut._fields:
            if f in MACRO_FIELDS and not macro:
                continue
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
    return eager_grids(torch, [(args, kw, sel)])[0]


def eager_grids(torch, grids):
    """:func:`eager_cells` of every ``(args, kw, sel)`` of ``grids`` over
    one pool; returns its result for each."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.core.params import MACRO_KMAX
    from repro_torch.kernels import cell_scan as cs
    tasks = []
    for g, (args, kw, sel) in enumerate(grids):
        host = [a.cpu() for a in args]
        for k in sel:
            tr, cf = int(host[4][k]), int(host[5][k])
            # the longest stream and the macro-steps' window past it
            L = max(int(host[3][tr].max()), 1) + MACRO_KMAX
            one = [x[tr:tr + 1, ..., :L] if i < 3 else x[tr:tr + 1]
                   for i, x in enumerate(host[:4])]
            one += [torch.zeros(1, dtype=torch.int32),
                    torch.tensor([cf], dtype=torch.int32)] + host[6:13]
            one.append(host[13][tr:tr + 1, ..., :L])
            tasks.append(((g, k), one, kw))
    t0 = time.time()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(os.cpu_count() or 1, len(tasks)),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        done = {k: (out, sec) for k, out, sec in ex.map(_eager_worker,
                                                        tasks)}
    wall = time.time() - t0
    res = []
    for g, (_, _, sel) in enumerate(grids):
        outs = [done[(g, k)][0] for k in sel]
        res.append((cs.CellScanOut(*(torch.cat([getattr(o, f) for o in outs])
                                     for f in cs.CellScanOut._fields)),
                    sum(done[(g, k)][1] for k in sel), wall))
    return res


def chain_grid_b(traces=None):
    """The 7 workloads at ``persist_budget=100_000`` (``traces``, built if
    not given) x NoPB/PB/PB_RF at n_switches 2, 3 and 4 (default
    PCSConfig): the chained version of phase 4's grid, 63 cells.  Returns
    ``(traces, labels, configs)``."""
    from repro_torch.core import PCSConfig, Scheme, WORKLOADS, make_trace
    traces = traces or [make_trace(n, persist_budget=100_000)
                        for n in WORKLOADS]
    labels, configs = [], []
    for n_sw in CHAIN_DEPTHS:
        for s in Scheme:
            labels.append((s.name, n_sw))
            configs.append(PCSConfig(scheme=s, n_switches=n_sw))
    return traces, labels, configs


def same_as_datum(np, r, d, what):
    """A SimResult equal, field by field, to the one the JAX datum's
    numbers give (runtime, stats — one row, or one per tenant — hop
    rows, recovery per hop and, for a fabric, per leaf)."""
    from repro_torch.core.engine.state import result_from_stats
    hs = np.asarray([[float(x) for x in row] for row in d["hop_stats"]])
    stats = np.asarray(d["stats"], dtype=np.float64)   # repr() strings
    leaves = d.get("leaf_recovery_raw")
    want = result_from_stats(
        float(d["runtime_ns"]), stats,
        crash_at_ns=r.crash_at_ns, recovery_entries=d["recovery_entries"],
        recovery_ns=float(d["recovery_ns"]),
        n_tenants=stats.shape[0] if stats.ndim == 2 else 1,
        n_hops=len(d["hop_recovery"]),
        hop_stats=hs if len(hs) else None,
        hop_recovery=np.asarray(d["hop_recovery"], np.int64),
        n_leaves=len(leaves) if leaves else 1,
        leaf_recovery=np.asarray(leaves, np.int64) if leaves else None)
    for f in ("runtime_ns", "persists", "pm_reads", "read_hits",
              "coalesces", "pm_writes", "stall_ns", "pi_detours",
              "victim_drains", "acked_persists", "durable_persists",
              "recovery_entries", "recovery_ns", "slo_violations",
              "persist_lat_ns", "read_lat_ns", "n_hops", "n_tenants"):
        if getattr(r, f) != getattr(want, f) and not (
                getattr(r, f) != getattr(r, f)
                and getattr(want, f) != getattr(want, f)):    # NaN == NaN
            fail(f"{what}: {f} = {getattr(r, f)!r}, reference "
                 f"{getattr(want, f)!r}")
    for f in ("lat_hist", "hop_stats", "hop_recovery", "tenant_stats",
              "leaf_recovery"):
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


def chain_profile(torch, fig1, grid_b, libs=None, abi="this"):
    """Phase 8d: the section profile of a chained step on Fig. 1's PB/4
    and PB_RF/4 cells and on cholesky's chained cells at n_switches 4,
    exact against the main path's outputs (``fig1``: the sweep's inputs,
    outputs and labels; ``grid_b``: the chained grid's, with its cell
    pairs, workload names and labels)."""
    args, kw, got, labels = fig1
    sel = [labels.index((s, 4, False)) for s in ("PB", "PB_RF")]
    pa = profile_cells(torch, args, kw, got, sel,
                       [f"fig1/{s}/4" for s in ("PB", "PB_RF")], libs, abi)
    print_profile("8d", "Fig. 1's PB/4 and PB_RF/4 cells", pa)
    bargs, bkw, bgot, bpairs, names, blabels = grid_b
    sel = [k for k, (i, j) in enumerate(bpairs)
           if names[i] == "cholesky" and blabels[j][1] == 4]
    pb = profile_cells(torch, bargs, bkw, bgot, sel,
                       [f"cholesky/{blabels[bpairs[k][1]][0]}/4"
                        for k in sel], libs, abi)
    print_profile("8d", "cholesky's 3 cells at n_switches 4", pb)
    return dict(fig1=pa, cholesky_4=pb)


def launch_abi(abi, lib, ins, out, *, max_pbe, pm_banks, n_track, n_deep,
               n_leaves, stream, macro=False) -> int:
    """``cell_scan_launch`` of ``lib`` by the argument list of the source
    it was built from: ``"this"`` the package's
    (:func:`repro_torch.kernels.cell_scan.launch`; ``macro`` runs its
    macro-steps, the run plan packed into the op words), ``"mlen"`` a
    source whose macro-steps read the run plan from an argument of its
    own and the op words as they are, ``"premacro"`` from before the
    macro-steps (no run plan, counters or macro flag), ``"preepoch"``
    from before the epoch
    schedules (nor an epoch table, bounds or count; a schedule-free
    grid), ``"prefabric"`` from before the fabric (nor a fabric table,
    per-leaf survivors or leaf count; a grid without a fabric).  The
    older ones leave the macro counters at 0."""
    import ctypes
    from repro_torch.core.engine.state import LAT_BIN_EDGES
    from repro_torch.kernels import cell_scan as cs
    import torch
    if abi == "this":
        return cs.launch(lib, ins, out, max_pbe=max_pbe, pm_banks=pm_banks,
                         n_track=n_track, n_deep=n_deep, n_leaves=n_leaves,
                         stream=stream, macro=macro)
    if macro and abi != "mlen":
        fail(f"launch_abi: a {abi} source has no macro-steps")
    _, C, L = ins[0].shape
    N, T, A = out.recov_t.shape[0], out.recov_t.shape[1], \
        out.durable_ver.shape[1]
    edges = torch.tensor(LAT_BIN_EDGES, dtype=torch.float64, device="cuda")
    aver = torch.empty((N, A), dtype=torch.int32, device="cuda")
    ptrs = list(ins[:9]) + [edges, out.runtime, out.stats, out.hop_stats,
                            out.durable_ver, out.n_recov, out.recov_ns,
                            out.recov_t, out.steps, out.lookups, aver,
                            ins[9], out.recov_h]
    ints = [N, C, L, max_pbe, pm_banks, A, T, n_track, n_deep]
    if abi in ("preepoch", "premacro", "mlen"):
        ptrs += [ins[10], out.recov_l]
        ints.append(n_leaves)
    if abi in ("premacro", "mlen"):
        ptrs += [ins[11], ins[12]]
        ints.append(ins[11].shape[1])
    if abi == "mlen":
        ptrs += [ins[13], out.macro_ops, out.macro_aborts]
        ints.append(int(macro))
    if not macro:
        out.macro_ops.zero_()
        out.macro_aborts.zero_()
    fn = lib.cell_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] \
        * len(ints) + [ctypes.c_void_p]
    rc = fn(*[x.data_ptr() for x in ptrs], *ints, stream)
    if rc == 0 and n_deep == 0:
        out.recov_h[:, 0].copy_(out.n_recov)
    if rc == 0 and n_leaves <= 1:
        out.recov_l[:, 0].copy_(out.recov_h[:, 0])
    return rc


def build_against(paths):
    """The cell scan of each other ``cell_scan.cu`` of ``paths`` (an
    earlier revision's, a variant), uninstrumented and with its section
    profile, built with the package's flags into
    ``build/repro_torch/against/<k>/`` (split into units when the source
    lists them, ``_build.unit_sources``), every library at once; headers
    beside the source first, then the package's.  Returns a pair of
    libraries for each path."""
    import ctypes
    from pathlib import Path
    from repro_torch.kernels import _build
    jobs = [(_build.BUILD_DIR / "against" / str(k) / f"lib{name}.so",
             Path(path), _build.nvcc_flags(name))
            for k, path in enumerate(paths)
            for name in ("cell_scan", "cell_scan_profile")]
    t0 = time.time()
    _build.build_libs(jobs)
    print(f"against: {', '.join(paths)} built in {time.time() - t0:.1f} s "
          f"(" + ", ".join(f"{len(_build.unit_sources(Path(p))) or 1} units"
                           for p in paths) + " a library, every library at "
          f"once)")
    return [tuple(ctypes.CDLL(str(so)) for so, _, _ in jobs[2 * k:2 * k + 2])
            for k in range(len(paths))]


def against_grids(np):
    """The grids ``--against`` runs, each ``(args, kw, labels, prof)``:
    the kernel's inputs on the card, a label per cell and the cells whose
    section profile it takes (cholesky's; Fig. 1's PB/4 and PB_RF/4)."""
    from repro_torch.core.engine.grid import cell_inputs
    grids = {}

    def add(name, traces, configs, labels, prof=None, pairs=None):
        pairs = pairs or [(i, j) for i in range(len(traces))
                          for j in range(len(configs))]
        args, kw = cell_inputs(traces, configs, [p[0] for p in pairs],
                               [p[1] for p in pairs], device="cuda")
        cells = [labels(i, j) for i, j in pairs]
        grids[name] = (args, kw, cells,
                       [k for k, c in enumerate(cells) if prof and prof(c)])
    traces, configs = paper_grid()
    names = [t.name for t in traces]
    add("paper_grid", traces, configs,
        lambda i, j: f"{names[i]}/{configs[j].scheme.name}")
    tr, labels, cfgs = fig1_grid(np)
    add("fig1", [tr], cfgs, lambda i, j: "fig1/{}/{}{}".format(
        labels[j][0], labels[j][1], "/crash" if labels[j][2] else ""),
        lambda c: c in ("fig1/PB/4", "fig1/PB_RF/4"))
    _, blabels, bconfigs = chain_grid_b(traces)
    add("chained_grid", traces, bconfigs,
        lambda i, j: f"{names[i]}/{blabels[j][0]}/{blabels[j][1]}",
        lambda c: c.startswith("cholesky/") and c.endswith("/4"))
    tr, labels, cfgs = fig_fabric_grid(np, FAB_OPS)
    add("fig_fabric", [tr], cfgs, lambda i, j: labels[j])
    flabels, fconfigs = fabric_grid_b()
    add("fabric_grid", traces, fconfigs,
        lambda i, j: f"{names[i]}/{flabels[j]}",
        lambda c: c.startswith("cholesky/"))
    dtraces, dlabels, dconfigs, _, _ = dynamic_grid(np, DYN_BUDGET, DYN_RATES)
    add("fig_dynamic", dtraces, dconfigs,
        lambda i, j: f"{DYN_RATES[i]:g}/{dlabels[j]}")
    bounds = paper_bounds()
    for name, knobs in (("scheduled_grid", ((0.75, 0.375), (None, 450.0))),
                        ("static_d1", (0.375, 450.0))):
        cfg, lab, pairs = [], [], []
        for i, t in enumerate(traces):
            ls, cs_ = schedule_configs(bounds[t.name], *knobs)
            pairs += [(i, len(cfg) + k) for k in range(len(cs_))]
            cfg += cs_
            lab += ls
        add(name, traces, cfg, lambda i, j, lab=lab: f"{names[i]}/{lab[j]}",
            lambda c: c.startswith("cholesky/"), pairs)
    return grids


def compare_against(torch, np, paths) -> dict:
    """``chip_smoke.py --against OLD.cu [...]``: the package's cell scan
    beside each other source (macro-steps off; on too where the other
    source has them) on the paper grid (D = 0), Fig. 1's sweep,
    the chained paper grid, fig_fabric, the fabric paper grid,
    fig_dynamic, the scheduled paper grid and its cells static at D = 1
    — outputs equal (all but the lookup counts), kernel times in the
    order other, this, this, other — then the section profiles of
    cholesky's cells (and Fig. 1's PB/4, PB_RF/4) in each grid that names
    them, and cholesky's depth-1 cells through the D = 0 and the D = 3
    instantiation, of each source."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import cell_scan as cs
    others = build_against(paths)
    abis = []
    for path in paths:
        with open(path) as f:
            src = f.read()
        abis.append("this" if "OPS_MLEN_SHIFT" in src else
                    "mlen" if "macro_aborts" in src else
                    "premacro" if "ep_table" in src else
                    "preepoch" if "recov_l" in src else "prefabric")
    t0 = time.time()
    this = (_build.library("cell_scan"), _build.library("cell_scan_profile"))
    print(f"against: the package's cell scan built in {time.time() - t0:.1f}"
          f" s")
    stream = torch.cuda.current_stream().cuda_stream
    res, outs_by = {}, {}
    grids = against_grids(np)
    for grid, (a, k, cells, _) in grids.items():
        ins = [x.contiguous() for x in a]
        n = len(cells)
        outs_by[grid] = outs = {}

        def run(which, lib, abi, mac=False):
            out = cs._empty_out(n, k["n_tenants_max"], max(k["n_track"], 1),
                                k["n_deep_max"], "cuda", k["n_leaves_max"])
            rc = launch_abi(abi, lib, ins, out, max_pbe=k["max_pbe"],
                            pm_banks=k["pm_banks"], n_track=k["n_track"],
                            n_deep=k["n_deep_max"],
                            n_leaves=k["n_leaves_max"], stream=stream,
                            macro=mac)
            _build.check(rc, f"{which} launch")
            outs[which] = out
        run("this", this[0], "this")
        torch.cuda.synchronize()
        steps = int(outs["this"].steps.max())
        reps = 3 if steps < 100_000 else 1
        for path, lib, abi in zip(paths, others, abis):
            if abi in ("preepoch", "prefabric") and a[11].shape[1] > 1:
                continue                  # that source has no EP
            # macro-steps off, and on where the other source has them
            for mac in (False, True) if abi in ("this", "mlen") else (False,):
                ms = {"other": [], "this": []}
                for which in ("other", "this", "this", "other"):
                    ms[which].append(cuda_ms(lambda: run(
                        path if which == "other" else "this",
                        (lib if which == "other" else this)[0],
                        abi if which == "other" else "this", mac), reps))
                for f in cs.CellScanOut._fields:
                    if f != "lookups" and not torch_equal(
                            getattr(outs[path], f), getattr(outs["this"], f)):
                        fail(f"{grid}: {path} and the package's cell scan "
                             f"differ on {f} (macro {mac})")
                key = f"{grid} {path}" + (" macro" if mac else "")
                res[key] = dict(
                    ms=ms, steps=steps, cells=n, macro=mac,
                    ns_per_step={w: [t * 1e6 / steps for t in v]
                                 for w, v in ms.items()},
                    lookups={w: int(outs[w].lookups.sum())
                             for w in ("this", path)})
                print(f"against {grid} ({n} cells, D = {k['n_deep_max']}, NL "
                      f"= {k['n_leaves_max']}, E = {a[11].shape[1]}, MAC = "
                      f"{str(mac).lower()}) {path}: outputs equal; kernel ms "
                      f"other {ms['other']}, this {ms['this']} (order other, "
                      f"this, this, other); longest cell {steps} steps; "
                      f"lookups {res[key]['lookups']}")
            run("this", this[0], "this")
    for which, libs, abi in [("this", this, "this")] + list(
            zip(paths, others, abis)):
        if abi not in ("this", "mlen"):
            continue              # its section list is not this one's
        for grid, (a, k, cells, sel) in grids.items():
            if not sel or which not in outs_by[grid]:
                continue
            p = profile_cells(torch, a, k, outs_by[grid][which], sel,
                              [f"{cells[c]} ({grid})" for c in sel], libs,
                              abi)
            print_profile(f"against {which}", f"{grid}'s profiled cells", p)
            res[f"profile {which} {grid}"] = p
        res[f"depth1 {which}"] = depth1_profiles(torch, libs, abi,
                                                 f"against {which}")
    return res


def depth1_profiles(torch, libs=None, abi="this", tag="against") -> dict:
    """cholesky's depth-1 cells (NoPB, PB, PB_RF; Table I) through the
    cell scan's D = 0 instantiation and through its D = 3 one (beside a
    chained cell of a short trace), both profiled and equal: what the
    chain's instantiation costs the hop-1 work (``libs``, ``abi``: as
    for :func:`profile_cells`)."""
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
                          [f"cholesky/{s.name}/1 ({name})" for s in Scheme],
                          libs, abi)
        print_profile(tag, f"cholesky's depth-1 cells ({name})", p)
        res[name] = p
    for f in ("runtime", "stats", "durable_ver", "n_recov", "steps"):
        if not torch_equal(getattr(outs["D0"], f)[:3],
                           getattr(outs["D3"], f)[:3]):
            fail(f"depth-1 cells differ between D = 0 and D = 3 on {f}")
    return res


# ---- phase 9: fan-out fabrics ---------------------------------------------
FAB_TENANTS, FAB_LEAVES = 8, (1, 2, 4, 8)   # benchmarks/fig_fabric.py
FAB_TOTAL_PBE, FAB_SPINE_PBE, FAB_GAP = 16, 8, 500.0
FAB_BP = float(FAB_SPINE_PBE // 2)
FAB_OPS, FAB_SMOKE_OPS = 1500, 150


def fab_topology(n_leaves, mode, bp_high=None):
    """``benchmarks/fig_fabric._fabric``: the 16 leaf PBEs split evenly
    over ``n_leaves``, the 8 tenants placed by ``mode``."""
    from repro_torch.core import FabricTopology, leaf_placement
    per = FAB_TOTAL_PBE // n_leaves
    return FabricTopology(n_leaves, (per,) * n_leaves, FAB_SPINE_PBE,
                          leaf_placement(FAB_TENANTS, n_leaves, mode),
                          bp_high=bp_high)


def fab_label(scheme, n_leaves, mode, bp_high):
    return (f"{scheme}/l{n_leaves}/{mode}/"
            + ("bp" if bp_high is not None else "none"))


def fig_fabric_grid(np, n_ops):
    """``benchmarks/fig_fabric.py``'s grid (``_probe_trace`` and ``plan``):
    8 tenants, one core each, ``n_ops`` persist/PM-read pairs per core
    500 ns apart over disjoint hot sets; PB and PB_RF x 1/2/4/8 leaves x
    packed/spread x bp_high None/4 (1 leaf: packed, None only), and a
    replica of each crashed at half the op span: 52 cells.  Returns
    ``(trace, labels, configs)``; the labels are fabric_ref.json's
    keys."""
    from repro_torch.core import Op, PCSConfig, Scheme, trace_from_arrays
    C, L = FAB_TENANTS, 2 * n_ops
    ops = np.zeros((C, L), np.int32)
    addrs = np.zeros((C, L), np.int32)
    for c in range(C):
        base = c << 16                     # disjoint per-tenant block
        ops[c, 0::2] = int(Op.PERSIST)
        addrs[c, 0::2] = base + np.arange(n_ops) % 64
        ops[c, 1::2] = int(Op.PM_READ)
        addrs[c, 1::2] = base + (1 << 10) + np.arange(n_ops)
    tr = trace_from_arrays("fab_probe", ops, addrs,
                           np.full((C, L), FAB_GAP, np.float32),
                           np.full((C,), L, np.int32))
    labels, configs = [], []
    for key, scheme in (("pb", Scheme.PB), ("pb_rf", Scheme.PB_RF)):
        for nl in FAB_LEAVES:
            for mode in ("packed", "spread"):
                if nl == 1 and mode == "spread":
                    continue
                for bp in ((None, FAB_BP) if nl >= 2 else (None,)):
                    labels.append(fab_label(key, nl, mode, bp))
                    configs.append(PCSConfig(
                        scheme=scheme, n_cores=FAB_TENANTS,
                        n_tenants=FAB_TENANTS,
                        fabric=fab_topology(nl, mode, bp)))
    crash_at = 0.5 * (2 * n_ops) * FAB_GAP
    for lab, cfg in list(zip(labels, configs)):
        labels.append(lab + "/crash")
        configs.append(cfg.with_crash(crash_at))
    return tr, labels, configs


def fabric_grid_b():
    """The fabric paper grid's configs: PB and PB_RF x {2 leaves packed,
    no watermark; 4 leaves spread, bp_high 4} over the same 16 + 8 PBEs,
    8 tenants (one per core).  Returns ``(labels, configs)``."""
    from repro_torch.core import PCSConfig, Scheme
    labels, configs = [], []
    for scheme in (Scheme.PB, Scheme.PB_RF):
        for nl, mode, bp in ((2, "packed", None), (4, "spread", FAB_BP)):
            labels.append(fab_label(scheme.name, nl, mode, bp))
            configs.append(PCSConfig(scheme=scheme, n_cores=FAB_TENANTS,
                                     n_tenants=FAB_TENANTS,
                                     fabric=fab_topology(nl, mode, bp)))
    return labels, configs


def grid_timing(torch, smem_ns, traces, configs, what, phase="9",
                pairs=None):
    """The kernel over every cell of ``traces`` x ``configs`` (the inputs
    simulate_grid stacks; ``pairs``: the (trace, config) cells
    simulate_cells stacks instead), timed; returns its outputs, inputs
    and numbers."""
    from repro_torch.core.engine.grid import cell_inputs
    from repro_torch.kernels import cell_scan as cs
    pairs = pairs or [(i, j) for i in range(len(traces))
                      for j in range(len(configs))]
    args, kw = cell_inputs(traces, configs, [p[0] for p in pairs],
                           [p[1] for p in pairs], device="cuda")
    got = cs.cell_scan(*args, **kw)
    torch.cuda.synchronize()
    reps = 3 if int(got.steps.max()) < 100_000 else 1
    ms = cuda_ms(lambda: cs.cell_scan(*args, **kw), reps)
    steps = int(got.steps.max())
    E = args[11].shape[1]
    bound = cell_bytes(traces, len(pairs), kw["n_tenants_max"],
                       max(kw["n_track"], 1), len(configs), kw["n_deep_max"],
                       kw["n_leaves_max"], E) / HBM_BYTES_PER_S * 1e3
    print(f"phase {phase} cell_scan {what} ({len(pairs)} cells, D = "
          f"{kw['n_deep_max']}, NL = {kw['n_leaves_max']}, E = {E}): kernel "
          f"{ms:.3f} ms, longest cell {steps} steps ({ms * 1e6 / steps:.1f} "
          f"ns/step; latency bound {steps * smem_ns / 1e6:.3f} ms; bytes "
          f"bound {bound:.6f} ms)")
    return dict(args=args, kw=kw, got=got, pairs=pairs), dict(
        ms=ms, steps=steps, ns_per_step=ms * 1e6 / steps, bound_ms=bound,
        latency_bound_ms=steps * smem_ns / 1e6, cells=len(pairs))


FAB_ORACLE = ((None, 1, None, None), ((8,), 1, "packed", None),
              ((4, 4), 2, "packed", None), ((4, 4), 2, "spread", None),
              ((4, 4), 2, "packed", 2.0), ((2, 2, 2, 2), 4, "spread", None))


def phase_fabric(torch, np, smem_ns, paper_traces, sass_against=None):
    """Phase 9: fan-out fabrics through the cell scan's FAB instantiation.
    (a) fig_fabric's grid at its published size and (b) the fabric paper
    grid through ``simulate_grid`` on the card (launch counts zeroed just
    before and read just after), exact against ``fabric_ref.json`` (all
    52 + 28 cells), each timed with its bounds beside the same traces
    under the 2-hop chain with no fabric (the FAB = false kernel); (c)
    the kernel against the eager plain version on all 52 cells of (a)
    at fig_fabric's smoke size; (d) the section profile of a fabric step
    (cholesky's 4 cells of (b)); (e) fuzzed fabric crash cells on the
    card against the port's oracle; (f) with ``sass_against`` (the
    arguments of ``sass_diff.main``: an earlier ``cell_scan.cu``, and
    perhaps an earlier ``flash_attention_tc.cu``), ``sass_diff`` of every
    instantiation against it."""
    from repro_torch.core import PCSConfig, Scheme, simulate_grid
    from repro_torch.kernels import cell_scan as cs
    from repro_torch.kernels import tat_lookup as tl
    with open(os.path.join(ROOT, "src", "repro_torch", "testdata",
                           "fabric_ref.json")) as f:
        ref = json.load(f)
    out = {}

    # (a) fig_fabric at its published size
    tr, labels, configs = fig_fabric_grid(np, FAB_OPS)
    cs.launches = tl.launches = 0
    t0 = time.time()
    cells = simulate_grid([tr], configs)[0]          # default device: CUDA
    wall_a = time.time() - t0
    counts_a = dict(cell_scan=cs.launches, tat_lookup=tl.launches)
    if counts_a["cell_scan"] < 1:
        fail(f"fabric figure did not run through the kernel: {counts_a}")
    for lab, r in zip(labels, cells):
        same_as_datum(np, r, ref["fig"][lab], f"fabric figure {lab}")
        if lab.endswith("/crash"):
            leaf = (None if r.leaf_recovery is None
                    else r.leaf_recovery.tolist())
            print(f"phase 9a fig_fabric {lab}: leaf_recovery {leaf}, "
                  f"hop_recovery {r.hop_recovery.tolist()}")
        else:
            print(f"phase 9a fig_fabric {lab}: persist "
                  f"{r.persist_lat_ns:.1f} ns (p99 "
                  f"{r.persist_lat_pct(0.99):.0f}), runtime "
                  f"{r.runtime_ns:.1f} ns, coalesces {r.coalesces}, "
                  f"pm_writes {r.pm_writes}")
    print(f"phase 9a simulate_grid (fig_fabric, 52 cells) wall "
          f"{wall_a:.3f} s; launches {json.dumps(counts_a)}; exact against "
          f"fabric_ref.json on all 52 cells")
    ins_a, num_a = grid_timing(torch, smem_ns, [tr], configs,
                               "fig_fabric")
    chain_cfgs = [PCSConfig(scheme=c.scheme, n_cores=FAB_TENANTS,
                            n_tenants=FAB_TENANTS, n_switches=2,
                            pbe_per_hop=(FAB_TOTAL_PBE, FAB_SPINE_PBE),
                            crash_at_ns=c.crash_at_ns)
                  for c in configs if c.fabric.n_leaves == 1]
    _, ctl_a = grid_timing(torch, smem_ns, [tr], chain_cfgs,
                           "fig_fabric's trace, 2-hop chain control")
    out["fig"] = dict(num_a, counts=counts_a, wall_s=wall_a,
                      chain_control=ctl_a,
                      persist_ns={lab: r.persist_lat_ns
                                  for lab, r in zip(labels, cells)
                                  if not lab.endswith("/crash")},
                      leaf_recovery={lab: r.leaf_recovery.tolist()
                                     for lab, r in zip(labels, cells)
                                     if r.leaf_recovery is not None
                                     and lab.endswith("/crash")})

    # (b) the fabric paper grid
    blabels, bconfigs = fabric_grid_b()
    names = [t.name for t in paper_traces]
    cs.launches = tl.launches = 0
    t0 = time.time()
    bcells = simulate_grid(paper_traces, bconfigs)
    wall_b = time.time() - t0
    counts_b = dict(cell_scan=cs.launches, tat_lookup=tl.launches)
    if counts_b["cell_scan"] < 1:
        fail(f"fabric paper grid did not run through the kernel: "
             f"{counts_b}")
    for i, n in enumerate(names):
        for j, lab in enumerate(blabels):
            same_as_datum(np, bcells[i][j], ref["grid_b"][n][lab],
                          f"fabric paper grid {n}/{lab}")
    print(f"phase 9b simulate_grid (7 workloads x PB/PB_RF x 2 fabrics, "
          f"budget 100000, 28 cells) wall {wall_b:.3f} s; launches "
          f"{json.dumps(counts_b)}; exact against fabric_ref.json on all "
          f"28 cells")
    for i, n in enumerate(names):
        print(f"phase 9b {n}: " + ", ".join(
            f"{lab} runtime {bcells[i][j].runtime_ns:.0f} ns persist "
            f"{bcells[i][j].persist_lat_ns:.1f} ns"
            for j, lab in enumerate(blabels)))
    ins_b, num_b = grid_timing(torch, smem_ns, paper_traces, bconfigs,
                               "fabric paper grid")
    bchain = [PCSConfig(scheme=s, n_cores=FAB_TENANTS, n_tenants=FAB_TENANTS,
                        n_switches=2,
                        pbe_per_hop=(FAB_TOTAL_PBE, FAB_SPINE_PBE))
              for s in (Scheme.PB, Scheme.PB_RF)]
    _, ctl_b = grid_timing(torch, smem_ns, paper_traces, bchain,
                           "paper traces, 8 tenants, 2-hop chain control")
    out["grid_b"] = dict(num_b, counts=counts_b, wall_s=wall_b,
                         chain_control=ctl_b)

    # (c) the kernel against the eager plain version at the smoke size
    str_, slabels, sconfigs = fig_fabric_grid(np, FAB_SMOKE_OPS)
    ins_c, num_c = grid_timing(torch, smem_ns, [str_], sconfigs,
                               "fig_fabric at its smoke size")
    sel = list(range(len(sconfigs)))
    plain, plain_s, pool_s = eager_cells(torch, ins_c["args"], ins_c["kw"],
                                         sel)
    err = compare_outputs(plain, ins_c["got"], "fig_fabric smoke size")
    scells = simulate_grid([str_], sconfigs)[0]
    for lab, r in zip(slabels, scells):
        same_as_datum(np, r, ref["fig_smoke"][lab], f"fabric smoke {lab}")
    print(f"phase 9c cell_scan on fig_fabric's 52 cells at its smoke size "
          f"({FAB_SMOKE_OPS} pairs a core): exact against the eager "
          f"scan_cell ({plain_s:.1f} s of cells, {pool_s:.1f} s wall over "
          f"a pool) and fabric_ref.json")
    out["smoke"] = dict(num_c, plain_s=plain_s, pool_s=pool_s,
                        max_abs_err=err)

    # (d) the section profile of a fabric step: cholesky's 4 cells of (b)
    i = names.index("cholesky")
    psel = [k for k, (ti, j) in enumerate(ins_b["pairs"]) if ti == i]
    prof = profile_cells(torch, ins_b["args"], ins_b["kw"], ins_b["got"],
                         psel, [f"cholesky/{blabels[ins_b['pairs'][k][1]]}"
                                for k in psel])
    print_profile("9d", "cholesky's 4 fabric cells", prof)
    out["profile"] = prof

    # (e) fuzzed fabric crash cells against the port's oracle
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_crash_driver import assert_cell_matches, oracle_replay
    from repro_torch.core import (FabricTopology, fuzz_crash_ns, fuzz_trace,
                                  leaf_placement, tenant_ids)
    n_cells = 0
    t0 = time.time()
    fabs = [None if lp is None else FabricTopology(
        nl, lp, 4, (0,) * 4 if mode is None
        else leaf_placement(4, nl, mode), bp_high=bp)
        for lp, nl, mode, bp in FAB_ORACLE]
    for seed in range(5):
        ftr, sched = fuzz_trace(seed, n_cores=4, n_slots=50, n_addrs=6,
                                n_tenants=4, p_persist=0.7)
        plan = [(s, k, f) for s in (Scheme.PB, Scheme.PB_RF)
                for k in (0, 11, 23, 36, 50) for f in fabs]
        fcfg = [(PCSConfig(scheme=s, n_pbe=8, n_cores=4, n_tenants=4,
                           n_switches=2, pbe_per_hop=(8, 4)) if f is None
                 else PCSConfig(scheme=s, n_cores=4, n_tenants=4, fabric=f)
                 ).with_crash(fuzz_crash_ns(k)) for s, k, f in plan]
        fres = simulate_grid([ftr], fcfg, max_pbe=8, track_addrs=6)[0]
        ct = tenant_ids(ftr.lengths, 4)
        for (s, k, f), r in zip(plan, fres):
            kw = (dict(n_switches=2, pbe_per_hop=(8, 4)) if f is None
                  else dict(fabric=f))
            try:
                assert_cell_matches(r, oracle_replay(
                    sched, k, s, 8, core_tenant=ct, n_tenants=4, **kw), 6,
                    label=(seed, s.name, k, None if f is None
                           else (f.n_leaves, f.placement, f.bp_high)))
            except AssertionError as e:
                fail(f"fabric oracle differential: {e}")
            n_cells += 1
    print(f"phase 9e {n_cells} fuzzed fabric crash cells (PB/PB_RF x the "
          f"2-hop chain, 1-leaf, 2-leaf packed/spread/watermarked and "
          f"4-leaf topologies x 5 crash points x 5 seeds) on the card agree "
          f"with the port's oracle (durable versions, counts, per-tenant, "
          f"per-hop and per-leaf survivors) in {time.time() - t0:.1f} s")
    out["oracle_cells"] = n_cells
    out["max_abs_err"] = err

    # (f) every instantiation against an earlier source (the MAC = false
    # ones must be identical), and the attention kernels against an
    # earlier flash_attention_tc.cu where one is given (every kernel both
    # have must be identical)
    if sass_against:
        from repro_torch.kernels import sass_diff
        if sass_diff.main(*sass_against) != 0:
            fail(f"SASS differs from {sass_against}")
        out["sass_identical"] = True
    return out


# ---- phase 10: epoch schedules --------------------------------------------
DYN_TENANTS = 4                        # benchmarks/fig_dynamic.py
DYN_LEAF_PBE, DYN_SPINE_PBE = (4, 4), 4
DYN_RATES, DYN_SMOKE_RATES = (0.5, 2.0, 8.0), (0.5, 8.0)
DYN_BUDGET, DYN_SMOKE_BUDGET = 25_000, 150       # _shared.BUDGET // 4
DYN_SCHEDULES = ("tighten", "slo_on")            # the scheduled paper grid


def dynamic_configs(bound_ns, crash_ns):
    """``benchmarks/fig_dynamic._configs``: a 2-leaf PB_RF pool (leaves of
    4 PBEs, spine 4, 4 tenants packed), strategies static (quotas
    2,2,2,2), quota_sched (2,2,2,2 then 4,2,1,1 from ``bound_ns``) and
    migrate (the placement flipped to the other leaf at ``bound_ns``),
    each live and crashed at ``crash_ns``.  Returns ``(labels,
    configs)``; the labels are dynamic_ref.json's keys."""
    from repro_torch.core import (AllocPolicy, FabricTopology, PBPolicy,
                                  PCSConfig, Schedule, Scheme,
                                  leaf_placement)
    place0 = leaf_placement(DYN_TENANTS, 2, "packed")
    place1 = tuple(1 - p for p in place0)
    quota0, quota1 = (2, 2, 2, 2), (4, 2, 1, 1)
    fab_static = FabricTopology(2, DYN_LEAF_PBE, DYN_SPINE_PBE, place0)
    fab_migrate = FabricTopology(2, DYN_LEAF_PBE, DYN_SPINE_PBE,
                                 Schedule((bound_ns,), (place0, place1)))
    strategies = (
        ("static", PBPolicy(alloc=AllocPolicy(tenant_quota=quota0)),
         fab_static),
        ("quota_sched", PBPolicy(alloc=AllocPolicy(
            tenant_quota=Schedule((bound_ns,), (quota0, quota1)))),
         fab_static),
        ("migrate", PBPolicy(alloc=AllocPolicy(tenant_quota=quota0)),
         fab_migrate))
    labels, configs = [], []
    for key, pol, fab in strategies:
        for crashed in (False, True):
            labels.append(key + ("/crash" if crashed else ""))
            cfg = PCSConfig(scheme=Scheme.PB_RF, n_cores=DYN_TENANTS,
                            n_tenants=DYN_TENANTS, policy=pol, fabric=fab)
            configs.append(cfg.with_crash(crash_ns) if crashed else cfg)
    return labels, configs


def dynamic_grid(np, budget, rates):
    """``benchmarks/fig_dynamic.run``'s grid: raytrace on 4 cores re-timed
    under ``DiurnalArrivals(r)`` for each rate, at ``persist_budget``
    ``budget``, x :func:`dynamic_configs` with the boundary at half and
    the crash at 3/4 of the longest trace's op span.  The span is summed
    exactly (``math.fsum``), where the figure sums in float32, whose last
    bit follows the numpy version's summation order.  Returns
    ``(traces, labels, configs, bound_ns, crash_ns)``."""
    import math
    from repro_torch.core import DiurnalArrivals, make_offered_load_trace
    traces = [make_offered_load_trace("raytrace", DiurnalArrivals(r),
                                      n_cores=DYN_TENANTS,
                                      persist_budget=budget)
              for r in rates]
    span = max(math.fsum(map(float, row)) for tr in traces
               for row in tr.gaps)
    labels, configs = dynamic_configs(0.5 * span, 0.75 * span)
    return traces, labels, configs, 0.5 * span, 0.75 * span


def schedule_configs(bound_ns, tighten=(0.75, 0.375), target=(None, 450.0)):
    """The scheduled paper grid's configs at ``n_switches=2``: PB and
    PB_RF x tighten (the drain threshold ``tighten`` from ``bound_ns``,
    preset 0.25) and slo_on (the latency target ``target``, that of
    ``benchmarks/fig_slo.py`` from ``bound_ns``).  A single value in
    place of a pair gives the static config.  Returns ``(labels,
    configs)``."""
    from repro_torch.core import (DrainPolicy, PBPolicy, PCSConfig,
                                  Schedule, Scheme)

    def knob(v):
        return v if not isinstance(v, tuple) else Schedule((bound_ns,), v)
    drains = (("tighten", DrainPolicy(threshold=knob(tighten),
                                      preset=0.25)),
              ("slo_on", DrainPolicy(latency_target_ns=knob(target))))
    labels, configs = [], []
    for s in (Scheme.PB, Scheme.PB_RF):
        for key, drain in drains:
            labels.append(f"{s.name}/{key}")
            configs.append(PCSConfig(scheme=s, n_switches=2,
                                     policy=PBPolicy(drain=drain)))
    return labels, configs


def ptxas_usage(name, args):
    """ptxas's registers and stack frame of each kernel of library
    ``name`` whose mangled template arguments start with ``args``, from
    its build log (``-Xptxas -v``): ``{template arguments: (registers,
    stack bytes)}``."""
    from repro_torch.kernels import _build
    out, fn = {}, None
    with open(_build._lib_path(name).with_suffix(".log")) as f:
        for line in f:
            m = re.search(r"function '\S*cell_scan_kernel(I\w+?EE)", line)
            if m:
                fn = m.group(1) if m.group(1).startswith(args) else None
                continue
            m = re.search(r"(\d+) bytes stack frame", line)
            if fn and m:
                out[fn] = [None, int(m.group(1))]
            m = re.search(r"Used (\d+) registers", line)
            if fn and m and fn in out:
                out[fn][0] = int(m.group(1))
    return out


def paper_bounds():
    """Each workload's schedule boundary: half its PB/2 runtime in
    chain_ref.json's chained paper grid."""
    with open(os.path.join(ROOT, "src", "repro_torch", "testdata",
                           "chain_ref.json")) as f:
        grid_b = json.load(f)["grid_b"]
    return {n: 0.5 * float(v["PB/2"]["runtime_ns"]) for n, v in
            grid_b.items()}


EPOCH_CRASH_SLOTS = (0, 11, 23, 36, 50)


def epoch_matrix(m=None):
    """``tests/test_crash_differential.py``'s epoch matrix: per crash
    slot, NoPB/PB/PB_RF x {quota step, threshold tighten, static} on 8
    PBEs and PB/PB_RF under a placement flip, 4 tenants, the boundary
    half a slot after slot 25.  ``m``: the package whose configs to build
    (``repro_torch.core``; the tests pass the reference's too).  Returns
    ``(plan, configs, policies, fabric)``; a plan entry is ``(scheme,
    crash slot, variant)``."""
    if m is None:
        import repro_torch.core as m
    bound = m.fuzz_crash_ns(25)
    Sch = m.Schedule
    pols = dict(
        quota=m.PBPolicy(alloc=m.AllocPolicy(tenant_quota=Sch(
            (bound,), ((2, 2, 2, 2), (5, 1, 1, 1))))),
        threshold=m.PBPolicy(drain=m.DrainPolicy(
            threshold=Sch((bound,), (0.75, 0.375)), preset=0.25)),
        static=None)
    place0 = m.leaf_placement(4, 2, "packed")
    fab = m.FabricTopology(2, (4, 4), 4, Sch(
        (bound,), (place0, tuple(1 - p for p in place0))))
    plan = []
    for k in EPOCH_CRASH_SLOTS:
        plan += [(s, k, v) for s in m.Scheme for v in pols]
        plan += [(s, k, "placement") for s in (m.Scheme.PB, m.Scheme.PB_RF)]
    cfgs = [(m.PCSConfig(scheme=s, n_cores=4, n_tenants=4, fabric=fab)
             if v == "placement" else
             m.PCSConfig(scheme=s, n_pbe=8, n_cores=4, n_tenants=4,
                         policy=pols[v])).with_crash(m.fuzz_crash_ns(k))
            for s, k, v in plan]
    return plan, cfgs, pols, fab


def phase_epochs(torch, np, smem_ns, paper_traces):
    """Phase 10: epoch schedules through the cell scan's EP instantiation.
    (a) fig_dynamic's grid at its published size and (b) the scheduled
    paper grid through ``simulate_grid`` / ``simulate_cells`` on the card
    (launch counts zeroed just before and read just after), exact
    against ``dynamic_ref.json`` (all 18 + 28 cells), each timed with its
    bounds; (c) the kernel against the eager plain version on
    fig_dynamic's 12 cells at its smoke size; (d) the epoch machinery's
    cost: (b)'s cells with two equal epochs (E = 2) beside the same
    static configs (E = 1), equal outputs, each timed and profiled; (e)
    the epoch matrix's fuzzed crash cells on the card against the port's
    oracle."""
    from repro_torch.core import simulate_cells, simulate_grid
    from repro_torch.core.engine.grid import cell_inputs
    from repro_torch.kernels import cell_scan as cs
    from repro_torch.kernels import tat_lookup as tl
    with open(os.path.join(ROOT, "src", "repro_torch", "testdata",
                           "dynamic_ref.json")) as f:
        ref = json.load(f)
    out = {}

    # (a) fig_dynamic at its published size
    traces, labels, configs, bound, crash = dynamic_grid(np, DYN_BUDGET,
                                                         DYN_RATES)
    if (bound, crash) != (float(ref["fig"]["bound_ns"]),
                          float(ref["fig"]["crash_ns"])):
        fail(f"fig_dynamic's boundary {bound} / crash {crash} differ from "
             f"dynamic_ref.json's")
    cs.launches = tl.launches = 0
    t0 = time.time()
    cells = simulate_grid(traces, configs)           # default device: CUDA
    wall_a = time.time() - t0
    counts_a = dict(cell_scan=cs.launches, tat_lookup=tl.launches)
    if counts_a["cell_scan"] < 1:
        fail(f"fig_dynamic did not run through the kernel: {counts_a}")
    tails, leaves = {}, {}
    for i, r in enumerate(DYN_RATES):
        for lab, res in zip(labels, cells[i]):
            same_as_datum(np, res, ref["fig"]["cells"][f"{r:g}"][lab],
                          f"fig_dynamic {r:g}/{lab}")
            key = f"{lab}_{r:g}"
            if lab.endswith("/crash"):
                leaves[key] = res.leaf_recovery.tolist()
                print(f"phase 10a fig_dynamic {r:g} Mops/s {lab}: "
                      f"leaf_recovery {leaves[key]}")
            else:
                tails[key] = [res.persist_lat_p50, res.persist_lat_p95,
                              res.persist_lat_p99]
                print(f"phase 10a fig_dynamic {r:g} Mops/s {lab}: persist "
                      f"P50/P95/P99 {tails[key][0]:.1f} / {tails[key][1]:.1f}"
                      f" / {tails[key][2]:.1f} ns, runtime "
                      f"{res.runtime_ns:.1f} ns")
    print(f"phase 10a simulate_grid (fig_dynamic, {len(traces)} rates x "
          f"{len(configs)} configs, boundary {bound:.1f} ns, crash "
          f"{crash:.1f} ns) wall {wall_a:.3f} s; launches "
          f"{json.dumps(counts_a)}; exact against dynamic_ref.json on all "
          f"{len(traces) * len(configs)} cells")
    _, num_a = grid_timing(torch, smem_ns, traces, configs, "fig_dynamic",
                           "10")
    out["fig"] = dict(num_a, counts=counts_a, wall_s=wall_a,
                      persist_p50_p95_p99=tails, leaf_recovery=leaves)

    # (b) the scheduled paper grid: 4 cells a workload, its own boundary
    names = [t.name for t in paper_traces]
    bounds = paper_bounds()
    btr, bcfg, blab = [], [], []
    for t in paper_traces:
        if bounds[t.name] != float(ref["grid_b"][t.name]["bound_ns"]):
            fail(f"{t.name}'s boundary differs from dynamic_ref.json's")
        lab, cfgs = schedule_configs(bounds[t.name])
        btr += [t] * len(cfgs)
        bcfg += cfgs
        blab += [(t.name, x) for x in lab]
    cs.launches = tl.launches = 0
    t0 = time.time()
    bcells = simulate_cells(btr, bcfg)
    wall_b = time.time() - t0
    counts_b = dict(cell_scan=cs.launches, tat_lookup=tl.launches)
    if counts_b["cell_scan"] < 1:
        fail(f"scheduled paper grid did not run through the kernel: "
             f"{counts_b}")
    for (n, lab), r in zip(blab, bcells):
        same_as_datum(np, r, ref["grid_b"][n]["cells"][lab],
                      f"scheduled paper grid {n}/{lab}")
    print(f"phase 10b simulate_cells (7 workloads x PB/PB_RF x tighten/"
          f"slo_on, n_switches 2, budget 100000, {len(bcells)} cells) wall "
          f"{wall_b:.3f} s; launches {json.dumps(counts_b)}; exact against "
          f"dynamic_ref.json on all {len(bcells)} cells")
    for n in names:
        print(f"phase 10b {n}: " + ", ".join(
            f"{lab} runtime {r.runtime_ns:.0f} ns persist "
            f"{r.persist_lat_ns:.1f} ns slo_violations {r.slo_violations}"
            for (m, lab), r in zip(blab, bcells) if m == n))
    bpairs = [(names.index(n), k) for k, (n, _) in enumerate(blab)]
    ins_b, num_b = grid_timing(torch, smem_ns, paper_traces, bcfg,
                               "scheduled paper grid", "10", bpairs)
    out["grid_b"] = dict(num_b, counts=counts_b, wall_s=wall_b)

    # (c) the kernel against the eager plain version at the smoke size
    straces, slabels, sconfigs, _, _ = dynamic_grid(np, DYN_SMOKE_BUDGET,
                                                    DYN_SMOKE_RATES)
    ins_c, num_c = grid_timing(torch, smem_ns, straces, sconfigs,
                               "fig_dynamic at its smoke size", "10")
    sel = list(range(len(ins_c["pairs"])))
    plain, plain_s, pool_s = eager_cells(torch, ins_c["args"], ins_c["kw"],
                                         sel)
    err = compare_outputs(plain, ins_c["got"], "fig_dynamic smoke size")
    scells = simulate_grid(straces, sconfigs)
    for i, r in enumerate(DYN_SMOKE_RATES):
        for lab, res in zip(slabels, scells[i]):
            same_as_datum(np, res, ref["fig_smoke"]["cells"][f"{r:g}"][lab],
                          f"fig_dynamic smoke {r:g}/{lab}")
    print(f"phase 10c cell_scan on fig_dynamic's {len(sel)} cells at its "
          f"smoke size (persist_budget {DYN_SMOKE_BUDGET}): exact against "
          f"the eager scan_cell ({plain_s:.1f} s of cells, {pool_s:.1f} s "
          f"wall over a pool) and dynamic_ref.json")
    out["smoke"] = dict(num_c, plain_s=plain_s, pool_s=pool_s,
                        max_abs_err=err)

    # (d) the epoch machinery's cost: two equal epochs against none, the
    # section profile of cholesky's cells in both spellings, and ptxas's
    # registers and stack frames of the instantiations they ran
    cost = {}
    cfgs = {}
    for n in names:
        b = bounds[n]
        cfgs.setdefault("scheduled", []).extend(
            schedule_configs(b, (0.375, 0.375), (450.0, 450.0))[1])
        cfgs.setdefault("static", []).extend(
            schedule_configs(b, 0.375, 450.0)[1])
    runs = {}
    for name, cf in cfgs.items():
        args, kw = cell_inputs(paper_traces, cf, [p[0] for p in bpairs],
                               [p[1] for p in bpairs], device="cuda")
        if args[11].shape[1] != (2 if name == "scheduled" else 1):
            fail(f"the {name} spelling lowered {args[11].shape[1]} epochs")
        runs[name] = got = cs.cell_scan(*args, **kw)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: cs.cell_scan(*args, **kw), 1)
        steps = int(got.steps.max())
        sel = [k for k, p in enumerate(bpairs) if names[p[0]] == "cholesky"]
        prof = profile_cells(torch, args, kw, got, sel,
                             [f"cholesky/{blab[k][1]} ({name})"
                              for k in sel])
        print_profile("10d", f"cholesky's 4 cells ({name})", prof)
        cost[name] = dict(ms=ms, steps=steps, ns_per_step=ms * 1e6 / steps,
                          cholesky_ns_per_step={
                              c: v["ns_per_step"]
                              for c, v in prof["cells"].items()})
    for f in cs.CellScanOut._fields:
        if not torch_equal(getattr(runs["scheduled"], f).cpu(),
                           getattr(runs["static"], f).cpu()):
            fail(f"equal epochs and the static config differ on {f}")
    print(f"phase 10d epoch machinery on the scheduled paper grid's "
          f"{len(bpairs)} cells (threshold 0.375 and target 450 ns, as two "
          f"equal epochs at E = 2 and as static configs at E = 1): outputs "
          f"equal; kernel {cost['scheduled']['ms']:.3f} ms "
          f"({cost['scheduled']['ns_per_step']:.1f} ns/step) against "
          f"{cost['static']['ms']:.3f} ms "
          f"({cost['static']['ns_per_step']:.1f} ns/step), longest cell "
          f"{cost['static']['steps']} steps")
    cost["ptxas"] = ptxas_usage("cell_scan", "ILi")
    print(f"phase 10d ptxas (registers, stack frame bytes) of every "
          f"cell_scan_kernel instantiation: {json.dumps(cost['ptxas'])}")
    out["cost"] = cost

    # (e) the epoch matrix's fuzzed crash cells against the port's oracle
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_crash_driver import assert_cell_matches, oracle_replay
    from repro_torch.core import fuzz_trace, tenant_ids
    n_cells = 0
    t0 = time.time()
    plan, mcfg, pols, fab = epoch_matrix()
    for seed in range(5):
        ftr, sched = fuzz_trace(seed, n_cores=4, n_slots=50, n_addrs=6,
                                n_tenants=4, p_persist=0.7)
        fres = simulate_grid([ftr], mcfg, max_pbe=8, track_addrs=6)[0]
        ct = tenant_ids(ftr.lengths, 4)
        for (s, k, v), r in zip(plan, fres):
            try:
                assert_cell_matches(r, oracle_replay(
                    sched, k, s, 8, core_tenant=ct, n_tenants=4,
                    policy=None if v == "placement" else pols[v],
                    fabric=fab if v == "placement" else None), 6,
                    label=(seed, s.name, k, v))
            except AssertionError as e:
                fail(f"epoch oracle differential: {e}")
            n_cells += 1
    print(f"phase 10e {n_cells} fuzzed epoch crash cells (NoPB/PB/PB_RF x "
          f"quota step, threshold tighten, static; PB/PB_RF x placement "
          f"flip; x 5 crash points x 5 seeds) on the card agree with the "
          f"port's oracle (durable versions, counts, per-tenant and "
          f"per-leaf survivors) in {time.time() - t0:.1f} s")
    out["oracle_cells"] = n_cells
    out["max_abs_err"] = err
    return out


# ---- phase 10g: every instantiation of the cell scan -----------------------
COVER_PBE = {1: 16, 2: 40, 4: 100}     # the largest hop's PBEs selects SPL
COVER_BOUND = 1e4                      # the schedules' boundary, ns
COVER_BUDGET = 150


def coverage_configs(target):
    """Phase 10g's configs for ``target = (SPL, D, FAB, EP[, MAC])``: PB_RF
    (drain threshold 0.8 and 0.5, preset 0.25) and PB over a chain of D +
    1 switches whose largest hop holds ``COVER_PBE[SPL]`` PBEs (hop 1 at
    D = 0, else deep row 0 beside a 16-PBE hop 1 and 8-PBE deeper rows),
    PB_RF over the default chains of 2 .. D switches, a NoPB cell and,
    for FAB, a 2-leaf fabric of 8 tenants (PB and PB_RF).  With EP the
    thresholds step at ``COVER_BOUND`` both ways (0.8 -> 0.5 and 0.5 ->
    0.8: ``tests/test_torch_epochs.py``'s threshold steps over chains) and
    the fabric's placement flips there."""
    from repro_torch.core import (DrainPolicy, FabricTopology, PBPolicy,
                                  PCSConfig, Schedule, Scheme,
                                  leaf_placement)
    spl, d, fab, ep = target[:4]
    big = COVER_PBE[spl]

    def pol(v):
        return PBPolicy(drain=DrainPolicy(
            threshold=Schedule((COVER_BOUND,), v) if ep else v[0],
            preset=0.25))
    hops = (big,) if d == 0 else (16, big) + (8,) * (d - 1)
    configs = [PCSConfig(scheme=s, n_switches=d + 1, n_pbe=hops[0],
                         pbe_per_hop=hops if d else None, policy=p)
               for s, p in ((Scheme.PB_RF, pol((0.8, 0.5))),
                            (Scheme.PB_RF, pol((0.5, 0.8))),
                            (Scheme.PB, None))]
    configs += [PCSConfig(scheme=Scheme.PB_RF, n_switches=n,
                          policy=pol((0.8, 0.5))) for n in range(2, d + 1)]
    configs.append(PCSConfig(scheme=Scheme.NOPB))
    if fab:
        place0 = leaf_placement(8, 2, "packed")
        place = (Schedule((COVER_BOUND,), (place0, tuple(1 - p for p in
                                                         place0)))
                 if ep else place0)
        configs += [PCSConfig(scheme=s, n_cores=8, n_tenants=8,
                              fabric=FabricTopology(2, (8, 8), 8, place))
                    for s in (Scheme.PB, Scheme.PB_RF)]
    return configs


def phase_coverage(torch):
    """Phase 10g: every instantiation of ``cell_scan_kernel<SPL, D, FAB,
    EP, MAC>`` (``cell_scan.INSTANTIATIONS``) launched once through
    ``simulate_grid`` on smoke-size traces (radiosity and raytrace at
    ``persist_budget`` COVER_BUDGET) x :func:`coverage_configs`, with
    macro-steps on and off, the instantiation read from the wrapper's
    launch record, and every output exact against the eager ``scan_cell``
    with macro-steps on (one pool for every grid): the ``MAC`` kernel's
    counters included, the other's state outputs, which macro-steps leave
    as they are, beside counters of 0."""
    from repro_torch.core import make_trace, simulate_grid
    from repro_torch.core.engine.grid import cell_inputs
    from repro_torch.kernels import cell_scan as cs
    traces = [make_trace(n, persist_budget=COVER_BUDGET)
              for n in ("radiosity", "raytrace")]
    t0 = time.time()
    grids, ran, gots = [], {}, []
    targets = sorted({t[:4] for t in cs.INSTANTIATIONS})
    for target in targets:
        configs = coverage_configs(target)
        pairs = [(i, j) for i in range(len(traces))
                 for j in range(len(configs))]
        for mac in (False, True):
            cs.launches_by = {}
            simulate_grid(traces, configs, macro=mac)   # default: CUDA
            ran[target + (mac,)] = dict(cs.launches_by)
            if ran[target + (mac,)] != {target + (mac,): 1}:
                fail(f"phase 10g: the grid for {target + (mac,)} launched "
                     f"{ran[target + (mac,)]}")
            args, kw = cell_inputs(traces, configs, [p[0] for p in pairs],
                                   [p[1] for p in pairs], macro=mac,
                                   device="cuda")
            gots.append(cs.cell_scan(*args, **kw))
        grids.append((args, kw, list(range(len(pairs)))))
    torch.cuda.synchronize()
    plains = eager_grids(torch, grids)
    n_cells = 0
    for k, (target, (plain, _, _)) in enumerate(zip(targets, plains)):
        off, on = gots[2 * k], gots[2 * k + 1]
        compare_outputs(plain, on, f"phase 10g {target + (True,)}")
        zero = plain._replace(macro_ops=torch.zeros_like(plain.macro_ops),
                              macro_aborts=torch.zeros_like(
                                  plain.macro_aborts))
        compare_outputs(zero, off, f"phase 10g {target + (False,)}")
        n_cells += 2 * int(on.steps.shape[0])
    done = sorted(set().union(*ran.values()))
    print(f"phase 10g instantiations launched: "
          + ", ".join("<" + ", ".join(str(x).lower() for x in t) + ">"
                      for t in done))
    print(f"phase 10g coverage: {len(done)} of {len(cs.INSTANTIATIONS)} "
          f"cell_scan_kernel instantiations launched, each exact against "
          f"the eager scan_cell ({n_cells} cells; the macro counters of "
          f"the {len(targets)} MAC ones too; {plains[0][2]:.1f} s wall over "
          f"a pool; {time.time() - t0:.1f} s in all)")
    if len(done) != len(cs.INSTANTIATIONS):
        fail(f"phase 10g: {len(done)} of {len(cs.INSTANTIATIONS)} "
             f"instantiations ran")
    return dict(launched=len(done), of=len(cs.INSTANTIATIONS), cells=n_cells)


# ---- phase 11: macro-steps -------------------------------------------------
def macro_datum():
    """``testdata/macro_ref.json``'s grids: the JAX reference's macro
    counters, cell by cell."""
    with open(os.path.join(ROOT, "src", "repro_torch", "testdata",
                           "macro_ref.json")) as f:
        return json.load(f)["grids"]


def macro_turns(torch, smem_ns, what, traces, configs, pairs=None,
                want=None):
    """The kernel over the cells of ``traces`` x ``configs`` (``pairs``:
    the (trace, config) cells simulate_cells stacks instead) with
    macro-steps on and off: the same state outputs, counters of 0 off,
    each cell's counters on equal to ``want[k]`` (a macro_ref.json cell,
    in cell order) where given; both timed in turns (off, on, on, off).
    Returns the numbers and the MAC run's outputs and inputs."""
    from repro_torch.core.engine.grid import cell_inputs
    from repro_torch.core.engine.macro import MACRO_ABORT_REASONS
    from repro_torch.kernels import cell_scan as cs
    pairs = pairs or [(i, j) for i in range(len(traces))
                      for j in range(len(configs))]
    args, kw = cell_inputs(traces, configs, [p[0] for p in pairs],
                           [p[1] for p in pairs], device="cuda")
    kws = {"on": kw, "off": dict(kw, macro=False)}
    on = cs.cell_scan(*args, **kws["on"])
    off = cs.cell_scan(*args, **kws["off"])
    torch.cuda.synchronize()
    for f in cs.CellScanOut._fields:
        if f not in MACRO_FIELDS and not torch_equal(getattr(on, f).cpu(),
                                                     getattr(off, f).cpu()):
            fail(f"phase 11 {what}: macro-steps on and off differ on {f}")
    if int(off.macro_ops.abs().sum()) or int(off.macro_aborts.abs().sum()):
        fail(f"phase 11 {what}: counters with macro-steps off")
    ops, aborts = on.macro_ops.tolist(), on.macro_aborts.tolist()
    slots = [traces[i].total_ops for i, _ in pairs]
    if want is not None:
        for k, d in enumerate(want):
            if (ops[k], aborts[k], slots[k]) != (
                    d["macro_ops"], d["abort_reasons"], d["total_ops"]):
                fail(f"phase 11 {what}: cell {k} counted {ops[k]} "
                     f"{aborts[k]} of {slots[k]} slots, macro_ref.json "
                     f"{d['macro_ops']} {d['abort_reasons']} of "
                     f"{d['total_ops']}")
    steps = int(on.steps.max())
    reps = 3 if steps < 100_000 else 1
    ms = {"off": [], "on": []}
    for which in ("off", "on", "on", "off"):
        ms[which].append(cuda_ms(lambda: cs.cell_scan(*args, **kws[which]),
                                 reps))
    mean = {w: sum(v) / len(v) for w, v in ms.items()}
    reasons = dict(zip(MACRO_ABORT_REASONS,
                       [int(x) for x in on.macro_aborts.sum(0).tolist()]))
    hit = sum(ops) / sum(slots)
    print(f"phase 11 {what} ({len(pairs)} cells, D = {kw['n_deep_max']}, "
          f"NL = {kw['n_leaves_max']}, E = {args[11].shape[1]}): MAC = true "
          f"{ms['on']} ms, MAC = false {ms['off']} ms (order false, true, "
          f"true, false); {mean['on'] * 1e6 / steps:.1f} vs "
          f"{mean['off'] * 1e6 / steps:.1f} ns per trace slot of the "
          f"longest cell ({steps} slots); hit rate {hit:.6f} "
          f"({sum(ops)} of {sum(slots)} slots); aborts {json.dumps(reasons)}"
          + ("; counters exact against macro_ref.json on every cell"
             if want is not None else ""))
    return dict(ms=ms, ms_on=mean["on"], ms_off=mean["off"], steps=steps,
                ns_per_slot_on=mean["on"] * 1e6 / steps,
                ns_per_slot_off=mean["off"] * 1e6 / steps,
                latency_bound_ms=steps * smem_ns / 1e6, hit_rate=hit,
                macro_ops=sum(ops), slots=sum(slots), aborts=reasons,
                cells=len(pairs), exact_cells=len(want or ())), \
        (args, kw, on)


def telemetry_check(what, want):
    """The latest simulate_* call's ``last_macro_hit_rate`` and
    ``last_macro_abort_reasons`` equal to the sums of ``want`` (the
    datum's cells of that call)."""
    from repro_torch.core import (last_macro_abort_reasons,
                                  last_macro_hit_rate)
    ops = sum(d["macro_ops"] for d in want)
    slots = sum(d["total_ops"] for d in want)
    reasons = [sum(d["abort_reasons"][r] for d in want) for r in range(6)]
    got = last_macro_abort_reasons()
    if last_macro_hit_rate() != ops / slots or list(got.values()) != reasons:
        fail(f"phase 11 {what}: telemetry {last_macro_hit_rate()} "
             f"{got}, macro_ref.json {ops / slots} {reasons}")


def phase_macro(torch, np, smem_ns, paper_traces, paper_configs, scan):
    """Phase 11: macro-steps through the cell scan's MAC instantiation.
    (a) the paper grid and (b) Fig. 1's sweep, fig_fabric, fig_dynamic
    (each at its published size) and the budget-2000 crash cells through
    ``simulate_grid``'s default (launch counts zeroed just before and
    read just after; the telemetry equal to ``testdata/macro_ref.json``'s
    sums), then through the kernel with macro-steps on and off: the same
    state outputs, every cell's counters exact against macro_ref.json,
    both timed in turns; the chained, fabric and scheduled paper grids
    the same; (c) the MAC kernel against the eager ``scan_cell`` with
    macro-steps on (a pool of host processes) on phase 3's budget-2000
    grid and crash cells; (d) the section profile of cholesky's paper
    cells with macro-steps on and off."""
    from repro_torch.core import simulate_cells, simulate_grid
    from repro_torch.core.engine.grid import cell_inputs
    from repro_torch.kernels import cell_scan as cs
    from repro_torch.kernels import tat_lookup as tl
    datum = macro_datum()
    names = [t.name for t in paper_traces]
    out = {}

    def through_default(what, run, want):
        cs.launches = tl.launches = 0
        cs.launches_by = {}
        t0 = time.time()
        run()
        wall = time.time() - t0
        macs = {k: v for k, v in cs.launches_by.items() if k[4]}
        if cs.launches < 1 or not macs:
            fail(f"phase 11 {what} did not run through the MAC kernel: "
                 f"{cs.launches_by}")
        telemetry_check(what, want)
        return dict(wall_s=wall, counts=dict(cell_scan=cs.launches,
                                             tat_lookup=tl.launches),
                    instantiations={",".join(map(str, k)): v
                                    for k, v in macs.items()})

    # (a) the paper grid
    want = [datum["paper"][n][c.scheme.name] for n in names
            for c in paper_configs]
    d = through_default("paper grid", lambda: simulate_grid(
        paper_traces, paper_configs), want)
    num, paper_run = macro_turns(torch, smem_ns, "paper grid", paper_traces,
                                 paper_configs, want=want)
    out["paper_grid"] = dict(num, **d)

    # (b) Fig. 1, fig_fabric, fig_dynamic, the crash cells
    tr, labels, configs = fig1_grid(np)
    want = [datum["fig1"]["{}/{}{}".format(s, n, "/crash" if c else "")]
            for s, n, c in labels]
    d = through_default("Fig. 1 sweep", lambda: simulate_grid([tr], configs),
                        want)
    num, fig1_run = macro_turns(torch, smem_ns, "Fig. 1 sweep", [tr],
                                configs, want=want)
    fig1_labels = ["{}/{}{}".format(s, n, "/crash" if c else "")
                   for s, n, c in labels]
    out["fig1"] = dict(num, **d)
    tr, labels, configs = fig_fabric_grid(np, FAB_OPS)
    want = [datum["fig_fabric"][lab] for lab in labels]
    d = through_default("fig_fabric", lambda: simulate_grid([tr], configs),
                        want)
    num, _ = macro_turns(torch, smem_ns, "fig_fabric", [tr], configs,
                         want=want)
    out["fig_fabric"] = dict(num, **d)
    dtraces, dlabels, dconfigs, bound, _ = dynamic_grid(np, DYN_BUDGET,
                                                        DYN_RATES)
    if bound != float(datum["fig_dynamic"]["bound_ns"]):
        fail("fig_dynamic's boundary differs from macro_ref.json's")
    want = [datum["fig_dynamic"]["cells"][f"{r:g}"][lab] for r in DYN_RATES
            for lab in dlabels]
    d = through_default("fig_dynamic", lambda: simulate_grid(dtraces,
                                                             dconfigs), want)
    num, _ = macro_turns(torch, smem_ns, "fig_dynamic", dtraces, dconfigs,
                         want=want)
    out["fig_dynamic"] = dict(num, **d)
    ctraces, ccfgs, cpairs, cplain = scan["crash"]
    want = [datum["crash2000"][ctraces[i].name][ccfgs[j].scheme.name][
        f"{f:g}"] for (i, j), f in zip(cpairs, [0.25, 0.5, 0.75] * 4)]
    d = through_default("crash cells", lambda: simulate_cells(
        [ctraces[i] for i, _ in cpairs], ccfgs, track_addrs=64), want)
    num, _ = macro_turns(torch, smem_ns, "crash cells", ctraces, ccfgs,
                         cpairs, want=want)
    out["crash_cells"] = dict(num, **d)

    # the chained, fabric and scheduled paper grids
    _, blabels, bconfigs = chain_grid_b(paper_traces)
    want = [datum["chain"][n][f"{s}/{k}"] for n in names
            for s, k in blabels] if "chain" in datum else None
    num, _ = macro_turns(torch, smem_ns, "chained paper grid", paper_traces,
                         bconfigs, want=want)
    out["chained_grid"] = num
    flabels, fconfigs = fabric_grid_b()
    want = [datum["fabric_b"][n][lab] for n in names for lab in flabels] \
        if "fabric_b" in datum else None
    num, _ = macro_turns(torch, smem_ns, "fabric paper grid", paper_traces,
                         fconfigs, want=want)
    out["fabric_grid"] = num
    bounds = paper_bounds()
    scfg, spairs, want = [], [], []
    for i, n in enumerate(names):
        lab, cfgs = schedule_configs(bounds[n])
        spairs += [(i, len(scfg) + k) for k in range(len(cfgs))]
        scfg += cfgs
        want += [datum["sched_b"][n][x] for x in lab] \
            if "sched_b" in datum else []
    num, _ = macro_turns(torch, smem_ns, "scheduled paper grid",
                         paper_traces, scfg, spairs, want=want or None)
    out["scheduled_grid"] = num

    # (d) the section profile of cholesky's paper cells, MAC on and off
    args, kw, got = paper_run
    sel = [k for k in range(got.steps.shape[0])
           if names[k // len(paper_configs)] == "cholesky"]
    prof = {}
    for mac in (True, False):
        labels = [paper_configs[k % len(paper_configs)].scheme.name
                  for k in sel]
        p = profile_cells(torch, args, dict(kw, macro=mac), got, sel,
                          [f"cholesky/{lab} (MAC {str(mac).lower()})"
                           for lab in labels], macro=mac)
        print_profile("11d", f"cholesky's 3 paper cells, MAC = "
                      f"{str(mac).lower()}", p)
        prof[mac] = {c: v["ns_per_step"] for c, v in p["cells"].items()}
    out["cholesky_sections"] = prof
    # and Fig. 1's 21 cells (one core: every live head replays or is
    # settled by its config's deep gate)
    args, kw, got = fig1_run
    sel = list(range(got.steps.shape[0]))
    prof = {}
    for mac in (True, False):
        p = profile_cells(torch, args, dict(kw, macro=mac), got, sel,
                          [f"fig1/{lab} (MAC {str(mac).lower()})"
                           for lab in fig1_labels], macro=mac)
        print_profile("11d", f"Fig. 1's 21 cells, MAC = "
                      f"{str(mac).lower()}", p)
        prof[mac] = {c: v["total_ns_per_step"] for c, v in p["cells"].items()}
    out["fig1_ns_per_step"] = prof

    # (c) the MAC kernel against its eager twin (macro-steps on) on phase
    # 3's grid and crash cells
    gtraces, gconfigs, gpairs, _ = scan["grid"]
    grids = []
    for trs, cfgs, prs, track in ((gtraces, gconfigs, gpairs, 0),
                                  (ctraces, ccfgs, cpairs, 64)):
        args, kw = cell_inputs(trs, cfgs, [p[0] for p in prs],
                               [p[1] for p in prs], track_addrs=track,
                               device="cpu")
        grids.append((args, kw, list(range(len(prs)))))
    (gplain, gplain_s, pool_s), (cplain_m, _, _) = eager_grids(torch, grids)
    gargs = [a.cuda() for a in grids[0][0]]
    ggot = cs.cell_scan(*gargs, **grids[0][1])
    cgot = cs.cell_scan(*[a.cuda() for a in grids[1][0]], **grids[1][1])
    torch.cuda.synchronize()
    err = max(compare_outputs(gplain, ggot, "phase 11 budget-2000 grid"),
              compare_outputs(cplain_m, cgot, "phase 11 crash cells"))
    for f in cs.CellScanOut._fields:
        if f not in MACRO_FIELDS + ("lookups",) and not torch_equal(
                getattr(cplain, f), getattr(cplain_m, f)):
            fail(f"phase 11 crash cells: the eager scan_cell with "
                 f"macro-steps on and off differ on {f}")
    ms = cuda_ms(lambda: cs.cell_scan(*gargs, **grids[0][1]), 3)
    steps = int(gplain.steps.max())
    bound = cell_bytes(gtraces, len(gpairs), 1, 1, len(gconfigs),
                       macro=True) / HBM_BYTES_PER_S * 1e3
    print(f"phase 11 cell_scan MAC = true on the budget-2000 grid "
          f"({len(gpairs)} cells) and the {len(cpairs)} crash cells: exact "
          f"against the eager scan_cell with macro-steps on, counters "
          f"included ({gplain_s:.1f} s of the grid's cells, {pool_s:.1f} s "
          f"wall over a pool); kernel {ms:.3f} ms, longest cell {steps} "
          f"slots; hit rate "
          f"{int(gplain.macro_ops.sum()) / sum(t.total_ops for t in gtraces) / len(gconfigs):.6f}")
    out["plain"] = dict(ms=ms, plain_ms=gplain_s * 1e3, bound_ms=bound,
                        max_abs_err=err, steps=steps,
                        latency_bound_ms=steps * smem_ns / 1e6,
                        macro_ops=int(gplain.macro_ops.sum()),
                        aborts=[int(x) for x in
                                gplain.macro_aborts.sum(0).tolist()])
    return out


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
          f"(tensor-core kernels, f32 at D = 256 on the wide one; "
          f"{n_served['tc']} launches, {n_served['fma']} on the FMA "
          f"kernel)")
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
    # the FMA kernel's row: at D = 256, the shape of the route it served
    # until the wide tensor-core kernel took it; the serving shape's
    # numbers beside
    w = out["f32_256"] = flash_f32_wide(torch, np, qkv)
    out["fma"] = dict(ms=w["fma_ms"], plain_ms=w["plain_ms"],
                      library_ms=w["library_ms"], max_abs_err=w["fma_err"],
                      bound_ms=w["bound_ms"], bound_by=w["bound_by"],
                      bound_f32_fma_ms=w["bound_f32_fma_ms"],
                      serving_shape=out["fma"])
    return out


def flash_f32_wide(torch, np, qkv):
    """f32 at D = 256, gemma2-2b's head layout (8 query heads on 4 KV
    heads, head dim 256; 4 x 1024 tokens, causal): its route (the wide
    tensor-core kernel, its launch counted) against the plain version,
    its outputs past 2e-5 over 8 seeds (none allowed), and timed in turns
    with the FMA kernel (through ``launch``; held too) beside the plain
    version and ``scaled_dot_product_attention`` in f32."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    b, h, hkv, s, d = 4, 8, 4, 1024, 256
    limit = TOL["float32"][0]
    entry = fa.TC_F32_256[1]
    if fa.route(torch.float32, d) != fa.TC_F32_256:
        fail(f"f32 at D = {d} routes to {fa.route(torch.float32, d)}")
    over, errs = [], []
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        q, k, v = (torch.tensor(rng.standard_normal((b, s, n, d)),
                                dtype=torch.float32, device="cuda")
                   .transpose(1, 2) for n in (h, hkv, hkv))
        n0, tc0 = fa.launches_by.get(entry, 0), fa.launches_tc
        got = fa.flash_attention(q, k, v, causal=True)
        want = flash_attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        if (fa.launches_by.get(entry, 0) - n0, fa.launches_tc - tc0) != \
                (1, 1):
            fail(f"flash_attention f32 D = {d} did not launch {entry}")
        if not bool(torch.isfinite(got).all()):
            fail("flash_attention f32 D = 256: non-finite output")
        diff = (got - want).abs()
        over.append(int((diff > limit).sum()))
        errs.append(float(diff.max()))
    if any(over):
        fail(f"flash_attention f32 D = {d}: outputs past {limit} per seed "
             f"{over} (max abs error {errs})")
    q, k, v = qkv(b, h, hkv, s, d, torch.float32)
    want = flash_attention_ref(q, k, v, causal=True)
    lib_fma = _build.library(fa.FMA_F32[0])
    o_fma = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def run_fma():
        _build.check(fa.launch(lib_fma, q, k, v, o_fma, causal=True,
                               window=None, stream=stream,
                               entry=fa.FMA_F32[1]), "FMA launch")
    got = fa.flash_attention(q, k, v, causal=True)
    run_fma()
    torch.cuda.synchronize()
    e = max_err(got, want, "flash_attention f32 D = 256", limit)
    e_fma = max_err(o_fma, want, "FMA kernel f32 D = 256", limit)
    ms = {"tc": [], "fma": []}
    for which in ("tc", "fma", "fma", "tc"):
        ms[which].append(cuda_ms(
            (lambda: fa.flash_attention(q, k, v, causal=True))
            if which == "tc" else run_fma, 20))
    plain = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True), 5)
    kr, vr = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
    lib_out = F.scaled_dot_product_attention(q, kr, vr, is_causal=True)
    torch.cuda.synchronize()
    lib_err = float((lib_out - want).abs().max())
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, kr, vr, is_causal=True), 20)
    pairs = s * (s + 1) // 2
    flops = 4.0 * b * h * pairs * d
    nbytes = 4 * (2.0 * b * h * s * d + 2.0 * b * hkv * s * d)
    bound_ms, bound_by = bound(6 * flops, nbytes)
    fma_bound = bound(flops, nbytes, F32_FLOPS_PER_S)[0]
    rec = dict(ms=sum(ms["tc"]) / 2, fma_ms=sum(ms["fma"]) / 2,
               ms_turns=ms, plain_ms=plain, library_ms=lib,
               library_err=lib_err, max_abs_err=max(e, max(errs)),
               fma_err=e_fma, over_counts=over, seed_errs=errs,
               bound_ms=bound_ms, bound_by=bound_by,
               bound_f32_fma_ms=fma_bound,
               shape="q (4, 8, 1024, 256), k/v (4, 4, 1024, 256), f32, "
                     "causal")
    print(f"phase 5 flash_attention_tc ({entry}) (4, 8, 1024, 256) f32 "
          f"causal, 4 KV heads: max abs error {e:.3g}, outputs past {limit} "
          f"over 8 seeds {over} (max {max(errs):.3g}); kernel "
          f"{ms['tc']} ms, FMA kernel (flash_attention.cu, through launch) "
          f"{ms['fma']} ms (order tc, fma, fma, tc; its error {e_fma:.3g}), "
          f"plain {plain:.4f} ms, scaled_dot_product_attention f32 "
          f"{lib:.4f} ms (its error {lib_err:.3g}); bound {bound_ms:.5f} ms "
          f"({bound_by}: {flops / 1e9:.2f} GFLOP x 6 split products, "
          f"{nbytes / 1e6:.1f} MB), at the f32 FMA rate {fma_bound:.5f} ms; "
          f"{rec['ms'] / bound_ms:.2f}x the bound, "
          f"{rec['ms'] / lib:.2f}x SDPA, {rec['ms'] / rec['fma_ms']:.2f}x "
          f"the FMA kernel")
    return rec


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
        fa.launches_by = {}
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
        by_entry32 = dict(fa.launches_by)
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
        fa.launches_by = {}
        ss.launches_tc = ss.launches_fma = 0
        tl.launches = cs.launches = 0
        res = serve(model, prompt, 64)
        counts = dict(flash_attention_tc=fa.launches_tc,
                      flash_attention_fma=fa.launches_fma,
                      ssd_scan_tc=ss.launches_tc,
                      ssd_scan_fma=ss.launches_fma, tat_lookup=tl.launches,
                      cell_scan=cs.launches)
        by_entry = dict(fa.launches_by)
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
                         counts_by_entry=by_entry,
                         counts_f32_datum_by_entry=by_entry32,
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
    if len(sys.argv) >= 3 and sys.argv[1] == "--against":
        _build.build_all(("cell_scan", "cell_scan_profile"))
        print(json.dumps({"against": compare_against(torch, np,
                                                     sys.argv[2:])}))
        return 0
    sass_against = None
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--sass-against":
        # OLD cell_scan.cu [OLD flash_attention_tc.cu]
        sass_against = (sys.argv[2], False, (sys.argv[3:] or [None])[0])
    elif len(sys.argv) != 1:
        fail(f"unknown arguments {sys.argv[1:]}")
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
    fab = phase_fabric(torch, np, smem_ns, traces, sass_against)
    epochs = phase_epochs(torch, np, smem_ns, traces)
    epochs["coverage"] = phase_coverage(torch)
    macro = phase_macro(torch, np, smem_ns, traces, configs, scan)
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
             plain_ms=scan["plain_ms"],
             plain_note="the eager scan_cell's seconds summed over the 21 "
                        "cells (run on the host, a pool of processes)",
             bound_ms=scan["bound_ms"],
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
        dict(name="cell_scan_fabric", route="cuda",
             source="src/repro_torch/kernels/csrc/cell_scan.cu",
             replaces="src/repro/core/engine/step.py:102",
             entry="cell_scan_launch with n_leaves > 1 (the FAB "
                   "instantiation: engine/fabric.py's leaf windows, "
                   "per-leaf PBC clocks, spine backpressure, per-leaf "
                   "recovery)",
             launches=fab["fig"]["counts"]["cell_scan"],
             main_path="phase 9a: simulate_grid over fig_fabric's grid at "
                       "its published size (52 cells, D = 1, NL = 8); "
                       "phase 9b launched it once more over the fabric "
                       "paper grid",
             launches_fabric_grid=fab["grid_b"]["counts"]["cell_scan"],
             max_abs_err=fab["max_abs_err"], ms=fab["fig"]["ms"],
             plain_ms=fab["smoke"]["plain_s"] * 1e3,
             plain_note="the eager scan_cell's seconds summed over "
                        "fig_fabric's 52 cells at its smoke size (150 "
                        "pairs a core; run on the host, a pool of "
                        "processes); the kernel on the same cells: "
                        "smoke_ms",
             smoke_ms=fab["smoke"]["ms"],
             bound_ms=fab["fig"]["bound_ms"], bound_by="bytes",
             library_ms=None,
             shape="fig_fabric: 8 tenants x 1500 persist/read pairs, "
                   "PB/PB_RF x 1/2/4/8 leaves x packed/spread x bp_high "
                   "None/4, and crashed",
             fig_steps=fab["fig"]["steps"],
             fig_ns_per_step=fab["fig"]["ns_per_step"],
             fig_latency_bound_ms=fab["fig"]["latency_bound_ms"],
             fig_chain_control=fab["fig"]["chain_control"],
             fig_wall_s=fab["fig"]["wall_s"],
             fig_persist_ns=fab["fig"]["persist_ns"],
             fig_leaf_recovery=fab["fig"]["leaf_recovery"],
             fabric_grid_ms=fab["grid_b"]["ms"],
             fabric_grid_steps=fab["grid_b"]["steps"],
             fabric_grid_ns_per_step=fab["grid_b"]["ns_per_step"],
             fabric_grid_bound_ms=fab["grid_b"]["bound_ms"],
             fabric_grid_latency_bound_ms=fab["grid_b"]["latency_bound_ms"],
             fabric_grid_chain_control=fab["grid_b"]["chain_control"],
             fabric_grid_wall_s=fab["grid_b"]["wall_s"],
             fabric_section_ns_per_step={
                 c: v["ns_per_step"]
                 for c, v in fab["profile"]["cells"].items()},
             oracle_cells=fab["oracle_cells"],
             sass_identical=fab.get("sass_identical")),
        dict(name="cell_scan_epochs", route="cuda",
             source="src/repro_torch/kernels/csrc/cell_scan.cu",
             replaces="src/repro/core/engine/step.py:102",
             entry="cell_scan_launch with n_epochs > 1 (the EP "
                   "instantiation: step.py:72 resolve_epoch_sc's per-op "
                   "epoch rows)",
             launches=epochs["fig"]["counts"]["cell_scan"],
             main_path="phase 10a: simulate_grid over fig_dynamic's grid "
                       "at its published size (18 cells, E = 2, D = 1, "
                       "NL = 2); phase 10b launched it once more over the "
                       "scheduled paper grid",
             launches_scheduled_grid=epochs["grid_b"]["counts"]["cell_scan"],
             max_abs_err=epochs["max_abs_err"], ms=epochs["fig"]["ms"],
             ns_per_step=epochs["fig"]["ns_per_step"],
             plain_ms=epochs["smoke"]["plain_s"] * 1e3,
             plain_note="the eager scan_cell's seconds summed over "
                        "fig_dynamic's 12 cells at its smoke size "
                        "(persist_budget 150; run on the host, a pool of "
                        "processes); the kernel on the same cells: "
                        "smoke_ms",
             smoke_ms=epochs["smoke"]["ms"],
             bound_ms=epochs["fig"]["bound_ms"], bound_by="bytes",
             library_ms=None,
             shape="fig_dynamic: raytrace on 4 cores, DiurnalArrivals at "
                   "0.5/2/8 Mops/s, persist_budget 25000; static, "
                   "quota_sched, migrate, live and crashed",
             fig_steps=epochs["fig"]["steps"],
             fig_latency_bound_ms=epochs["fig"]["latency_bound_ms"],
             fig_wall_s=epochs["fig"]["wall_s"],
             fig_persist_p50_p95_p99=epochs["fig"]["persist_p50_p95_p99"],
             fig_leaf_recovery=epochs["fig"]["leaf_recovery"],
             scheduled_grid_ms=epochs["grid_b"]["ms"],
             scheduled_grid_steps=epochs["grid_b"]["steps"],
             scheduled_grid_ns_per_step=epochs["grid_b"]["ns_per_step"],
             scheduled_grid_bound_ms=epochs["grid_b"]["bound_ms"],
             scheduled_grid_latency_bound_ms=epochs["grid_b"][
                 "latency_bound_ms"],
             scheduled_grid_wall_s=epochs["grid_b"]["wall_s"],
             equal_epochs_vs_static=epochs["cost"],
             instantiation_coverage=epochs["coverage"],
             oracle_cells=epochs["oracle_cells"]),
        dict(name="cell_scan_macro", route="cuda",
             source="src/repro_torch/kernels/csrc/cell_scan.cu",
             replaces="src/repro/core/engine/macro.py:68",
             entry="cell_scan_launch with macro = 1 (the MAC "
                   "instantiation: engine/macro.py's dead-run collapse "
                   "and each live head's commit or abort, counted)",
             launches=main_path["mac_launches"],
             main_path="phase 4: simulate_grid over the paper grid (its "
                       "default, macro=True); phase 11 launched it again "
                       "over every grid, each beside MAC = false in turns",
             max_abs_err=macro["plain"]["max_abs_err"],
             ms=macro["plain"]["ms"], plain_ms=macro["plain"]["plain_ms"],
             plain_note="the eager scan_cell with macro-steps on, seconds "
                        "summed over the 21 cells (run on the host, a "
                        "pool of processes)",
             bound_ms=macro["plain"]["bound_ms"], bound_by="bytes",
             library_ms=None,
             shape="7 workloads x 3 schemes at persist_budget=2000",
             latency_bound_ms=macro["plain"]["latency_bound_ms"],
             main_path_ms=macro["paper_grid"]["ms_on"],
             main_path_ms_mac_false=macro["paper_grid"]["ms_off"],
             main_path_hit_rate=macro["paper_grid"]["hit_rate"],
             main_path_aborts=macro["paper_grid"]["aborts"],
             grids={k: {f: v[f] for f in ("ms_on", "ms_off",
                                          "ns_per_slot_on",
                                          "ns_per_slot_off", "steps",
                                          "hit_rate", "macro_ops", "slots",
                                          "aborts", "cells", "exact_cells",
                                          "latency_bound_ms")}
                    for k, v in macro.items()
                    if k not in ("plain", "cholesky_sections",
                                 "fig1_ns_per_step")},
             cholesky_section_ns_per_step=macro["cholesky_sections"]),
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
        dict(name="flash_attention_tc_f32_256", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
             replaces="src/repro/kernels/flash_attention.py:68",
             entry="flash_attention_tc_f32_256_launch",
             launches=served["smollm-135m"]["counts_by_entry"].get(
                 "flash_attention_tc_f32_256_launch", 0)
             + served["smollm-135m"]["counts_f32_datum_by_entry"].get(
                 "flash_attention_tc_f32_256_launch", 0),
             main_path="the f32 route of flash_attention at D = 256: not "
                       "launched by the bf16 serve or the f32 datum "
                       "prefill (D = 64); held over 8 seeds and timed at "
                       "gemma2-2b's head layout in phase 5, in turns with "
                       "the FMA kernel",
             max_abs_err=flash["f32_256"]["max_abs_err"],
             over_counts=flash["f32_256"]["over_counts"],
             ms=flash["f32_256"]["ms"],
             fma_kernel_ms=flash["f32_256"]["fma_ms"],
             plain_ms=flash["f32_256"]["plain_ms"],
             bound_ms=flash["f32_256"]["bound_ms"],
             bound_by=flash["f32_256"]["bound_by"],
             bound_note="six bf16 products a product at the bf16 "
                        "tensor-core peak; bound_f32_fma_ms: the f32 work "
                        "at the f32 FMA rate",
             bound_f32_fma_ms=flash["f32_256"]["bound_f32_fma_ms"],
             library_ms=flash["f32_256"]["library_ms"],
             library="scaled_dot_product_attention in f32 (K/V repeated "
                     "per query head)",
             shape=flash["f32_256"]["shape"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:68",
             entry="flash_attention_launch",
             launches=served["smollm-135m"]["counts"]["flash_attention_fma"]
             + served["smollm-135m"]["counts_f32_datum"][
                 "flash_attention_fma"],
             main_path="on no route of flash_attention (f32 at D = 256 "
                       "went to the wide tensor-core kernel); held and "
                       "timed through launch() at D = 256 in turns with "
                       "that kernel, and at the serving shape, in phase 5",
             max_abs_err=flash["fma"]["max_abs_err"],
             ms=flash["fma"]["ms"], plain_ms=flash["fma"]["plain_ms"],
             bound_ms=flash["fma"]["bound_ms"],
             bound_by=flash["fma"]["bound_by"],
             bound_f32_fma_ms=flash["fma"]["bound_f32_fma_ms"],
             library_ms=flash["fma"]["library_ms"],
             library="scaled_dot_product_attention in f32 (K/V repeated "
                     "per query head)",
             serving_shape=flash["fma"]["serving_shape"],
             shape=flash["f32_256"]["shape"]),
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
    try:
        rc = main()
    finally:
        stop_children()
    sys.exit(rc)
