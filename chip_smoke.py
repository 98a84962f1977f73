#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py

It imports only ``repro_torch`` (never JAX or the ``repro`` package),
builds the port's kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch/``, and runs sixteen phases, each printing its own
lines (and, before the kernels' line, each phase's wall seconds):

1. the card (``nvidia-smi`` name and power limit), the kernel build, and
   the latency of one dependent shared-memory load (``smem_probe.cu``),
   the unit of the cell scan's latency bound;
2. the ``tat_lookup`` kernel against its plain version on the card, at
   the Pallas test sweep's shapes and the engine's (R=8, N=16), exact;
3. the cell-scan kernel against the eager ``scan_cell`` (run on the
   host, a pool of processes) on the 7 workloads x NoPB/PB/PB_RF at ``persist_budget=2000``,
   on PB/PB_RF crash cells with ``track_addrs=64``, and on the shortest
   workload's PB_RF cell of the full-size paper grid (the main path's
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
   card: the JAX sweep's shapes (bf16 on the warp-specialised kernel
   from head dim 64 and on the tensor-core kernel at 32, f32 on the
   tensor-core kernels, at head dim 256 on the wide one, causal with and
   without a window, one non-causal case each; 2e-5 / 3e-2; each case's
   route checked by its launch counters), the bf16 route's outputs past
   3e-2 over 8 seeds at smollm-135m's prefill shape and at gemma3-12b's
   global one (none allowed), ptxas's registers and spills of the
   warp-specialised kernel (no spill allowed), and smollm's shape in
   bf16 (the main path, in turns with the present tensor-core kernel run
   through ``launch``) and f32 (the f32 tensor-core route beside the FMA
   kernel, run through ``launch``), timed beside the plain version and
   ``scaled_dot_product_attention``; then f32 at D = 256 in
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
   the eager ``scan_cell`` ((a)'s 6 cells at depths 0 and 4, lu_cont's
   PB_RF cell at ``n_switches`` 4 of (b); a pool of host processes), with
   each Fig. 1 row's persist latency over
   depth-0 NoPB and its per-hop recovery; then (d) the section profile
   of a chained step (Fig. 1's PB/4 and PB_RF/4 cells, cholesky's cells
   at ``n_switches`` 4), exact against (a) and (b); then (c) 225 fuzzed
   crash cells at depths 1-3 on the card against the port's untimed
   oracle (``tests/_torch_crash_driver.py``).

Then one JSON line with the serving numbers, one with the attention
family's (phase 13), one with the MoE family's (phase 14), one with the
training numbers (phase 12), one with the launch layer's (phase 15), one
with the static analysis's (phase 16), one with every kernel's numbers,
and as the last line
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
   ``scan_cell`` (a pool of host processes) on the 20 cells of (a) with
   1 or 8 leaves at fig_fabric's smoke size (150 pairs), and against
   fabric_ref.json on all 52; (d) the section profile of a
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
    pool) on phase 3's budget-2000 grid's PB_RF cells and crash cells,
    counters included.  Phase 3 itself runs the grid and crash cells with
    macro-steps off, and the section profiles (phases 4, 8d, 9d, 10d)
    run the profile build, SPL 1 and ``MAC = false`` only, against the
    main path's state outputs.

12. (run after phase 7) the training path, smollm-135m at full width
    and depth through ``launch.steps.make_train_step`` and
    ``launch.train``: (a) the f32 copy with ``numpy_params(cfg, 0)``,
    ``SyntheticLMDataset(seed=0)`` batches of 2 x 128 tokens and
    ``AdamWConfig(lr=1e-3, total_steps=20)``, each of 3 steps' loss, grad
    norm and lr against ``src/repro_torch/testdata/train_ref.json`` (the
    JAX reference's, made on the CPU); (b) the published bf16 config at
    the train CLI's defaults (8 x 128 tokens, AdamW) in each of NoPB, PB
    and PB_RF: 6 steps with a checkpoint every 3 through
    ``launch.train.train`` into a fresh ``DurableStore`` in a temporary
    directory (1 ms a write) behind a buffer that holds one checkpoint, a
    restore right after the last persist (under PB_RF the buffer must
    serve some of it), then ``crash()``, ``recover()`` and a restore
    through a new manager, each into a model built with other weights and
    equal to the live state bit for bit at version 6; persist and
    restore seconds, the restores' buffer and store counts, checkpoint
    bytes and peak memory per scheme; then the step's time (CUDA events,
    warmed up) and tokens/s.  Every kernel's launch count over the phase
    must be 0: the training path reaches no hand-written kernel, as the
    reference's reaches no Pallas one; (c) training through SSD layers
    (``models.ssm.ssd_chunked``), mamba2-1.3b at full width: the f32 copy
    at 2 of its 48 layers, ``train_ref_ssd.json``'s batches and
    optimizer, each of 3 steps' loss, grad norm and lr against
    ``src/repro_torch/testdata/train_ref_ssd.json``; then the published
    bf16 config at full width and depth (weights drawn on the card) at
    the train CLI's defaults, its step time (CUDA events over 3 steps
    after 2), tokens/s and peak memory; again no kernel launch in the
    phase; (d) bf16 training through MoE layers (``moe._BmmF32``'s
    gradient): the port's bf16 loss and gradients of one ``moe_ffn``
    against ``src/repro_torch/testdata/moe_grad_bf16_ref.json`` (the JAX
    reference's ``jax.grad``, made on the CPU) within 2^-6 of each leaf's
    norm and in its dtypes, then mixtral-8x7b at full width, 2 of its 32
    layers, weights drawn on the card, 2 bf16 steps at the train CLI's 8
    x 128 tokens with f32 moments: each step's time, tokens/s, peak
    memory, a finite loss and no kernel launch.  ``python3 chip_smoke.py
    --train-only`` runs phase 12 alone (no kernel build).

13. (run after phase 7) the attention family: sliding windows and their
    ring caches, logit softcaps, qk-norm, the prefix-LM and the
    encoder-decoder.  (a) gemma2-2b (2 layers, 1 x 4160 prompt, window
    4096), gemma3-12b (6 layers, 2 x 1100, window 1024), paligemma-3b (2
    layers, 2 x 256 after 256 prefix embeddings) and
    seamless-m4t-large-v2 (whole, 2 x 256 and 64 frames, decode given the
    encoder output) at full width in f32 with ``numpy_params(cfg, 0)``
    (drawn on a background thread during phases 8-11) against
    ``src/repro_torch/testdata/serve_ref_families.json`` (the JAX
    reference's logits and greedy tokens; every prompt is longer than its
    window), with each prefill's launches by C entry exact: gemma3-12b 6
    on the wide f32 kernel, seamless 24 on the f32 tensor-core kernel,
    gemma2-2b and paligemma-3b none (softcap, prefix: the plain softmax);
    (b) each of the five new configs served in bf16 at full width with
    weights drawn on the card (``models.convert.device_fill``):
    gemma3-12b whole at 4 x 2048 + 64 greedy steps (48 launches, 40 of
    them windowed), gemma2-2b, paligemma-3b (after its 256 prefix
    embeddings) and seamless (256 frames; 24 launches) whole and
    deepseek-67b at 16 of its 95 layers (16 launches) at 4 x 1024 + 64,
    each with its prefill ms, decode tokens/s and peak memory, for each
    that launches the kernel every kernel call of its prefill against the
    plain version on the same inputs (within 2^-6 of ||plain||) and the
    prefill logits against the same model with the plain version swapped
    in (within a tenth of what zeroing the kernel moves them, both as
    ||diff|| / ||plain||), and gemma3-12b's device time by
    kernel (``torch.profiler``); (c) the kernel at each new shape of
    these paths against the plain version, timed beside
    ``scaled_dot_product_attention`` (GQA, a boolean mask where there is a
    window) with a bound that counts the pairs the mask keeps; in bf16 the
    route's warp-specialised kernel in turns with the present
    tensor-core kernel (through ``launch``, held to the same limit).
    ``python3 chip_smoke.py --serve-only`` runs phases 5-7, 13 and 14
    alone and builds only their kernels.

14. (run after phase 13) the MoE family: top-2 expert FFNs, at serving
    (``drop=False``) over each expert's routed rows alone.  (a) mixtral-8x7b (1 layer, 1 x 4160 prompt, window
    4096) and phi3.5-moe-42b (1 layer, 2 x 256) at full width in f32 with
    ``numpy_params(cfg, 0)`` (drawn on phase 13's background thread)
    against ``src/repro_torch/testdata/serve_ref_moe.json`` within 1e-5 of
    each step's largest |logit|, greedy tokens equal, each prefill 1
    launch of the f32 D <= 128 kernel; (b) the three MoE ids served in
    bf16 at full width with device-filled weights, cut in depth to fit
    one card: mixtral-8x7b 16 of 32 layers at 2 x 4160 + 64 greedy steps
    (16 windowed ``flash_attention_ws`` launches), phi3.5-moe-42b 16 of
    32 at 4 x 1024 + 64 (16), jamba-1.5-large-398b's first 5 layers
    (ssm, ssm+MoE, ssm, ssm+MoE, attn) at 2 x 1024 + 64 (1 and 4
    ``ssd_scan_tc``), each with prefill ms, decode tokens/s and peak
    memory, every kernel call of its prefill against the plain version
    on the same inputs and its prefill logits against the same model
    with each plain version swapped in (as in 13b), the rows each MoE
    layer's expert products saw (exactly ``3 * n * k``: gate, up and
    down over the routed rows), and mixtral's prefill device time by
    kernel and by the op that launched it, the expert products a group
    of their own; (c) the kernels at each new shape against their
    plain versions, the attention timed beside
    ``scaled_dot_product_attention`` (in bf16 in turns with the present
    tensor-core kernel, as in 13c), each with its bound.

15. (run after phase 12) the launch layer: (a) ``python -m
    repro_torch.launch.dryrun --arch all --shape all --mesh both`` in a
    subprocess that sees no CUDA device (its fake process group of 256
    or 512 ranks stays out of this process): exit 0 and ``dry-run: 70
    ok, 10 skipped, 0 FAILED``, each ok row's parameter and optimizer
    bytes per device equal to the specs' arithmetic, its seconds against
    the 120 s aim and the five largest per-device residents; (b)
    ``make_host_mesh()``, a 1 x 1 CUDA mesh on NCCL (world size 1), on
    which ``shard_tree`` places smollm-135m's full-width parameters and
    AdamW state whole, its group destroyed on exit; then smollm-135m
    with phase 7b's weights and batch served through
    ``make_prefill_step`` / ``make_decode_step`` (4 x 1024 + 64 greedy
    steps): 30 tensor-core ``flash_attention`` launches at prefill,
    every step's logits bit for bit those of ``prefill`` /
    ``decode_step`` called directly, the tokens those phase 7b's
    ``serve`` returned.

16. (last) the static invariant analysis: (a) ``python -m
    repro_torch.analysis --fail-on-findings --json FILE``'s ``main`` in
    this process, on the host (the mirror, twin, retrace and dtypes
    passes over the port's sources, the kernel's operand tables and the
    plain ``scan_cell``; any finding fails the run), then (b) the
    analysis's exemplar cell (a 2-leaf fabric, 2 tenants, a 2-epoch
    schedule, macro-steps; ``analysis/_engine.py``) through the
    cell-scan kernel on the card under every scheme, every output but
    the lookup counts exactly the plain version's; its wall is printed
    beside its aim of 30 s.

``python3 chip_smoke.py --serve-against OTHER [ARCH ...]`` runs only
phase 14b's MoE serves (all three ids unless named) with this
checkout's ``repro_torch`` and with the checkout OTHER's (e.g. the
parent unpacked with ``git archive`` under ``build/``), in turns other,
this, this, other, other, this, each turn a process of its own: per
serve prefill ms, decode tokens/s and peak GiB (three serves a turn),
the prefill's device time by kind, the expert rows per MoE layer, and
a profiled decode (host ms a step in all and in the MoE layers, device
ms and kernel launches a step, the ops with the most host and device
time); then each tree's quartiles, and the card and one JSON line.

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

import contextlib
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


# the kernels of the serving path (phases 5-7 and 13)
MODEL_SOURCES = ("flash_attention", "flash_attention_tc",
                 "flash_attention_ws", "ssd_scan", "ssd_scan_tc")
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


def phase_cell_scan(torch, smem_ns, ftraces, fconfigs):
    """Phase 3: the kernel against the eager ``scan_cell`` on the
    budget-2000 grid, on its crash cells and on the shortest full-size
    workload's PB_RF cell (:func:`full_size`), the eager cells of all
    three over one pool.  Returns the grid's record and the full-size
    grid's ``(args, kw, got, err)``."""
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
    dargs = [a.cuda() for a in args]
    got = cs.cell_scan(*dargs, **kw)
    torch.cuda.synchronize()

    # crash cells: PB / PB_RF on two workloads, three power-loss points
    # each (fractions of the workload's no-crash PB runtime, the kernel's:
    # held exactly against the eager version's below)
    crash_traces, crash_cfgs, cpairs = [], [], []
    for w in ("radiosity", "lu_cont"):
        i = names.index(w)
        t_pb = float(got.runtime[i * len(configs) + int(Scheme.PB)])
        crash_traces.append(traces[i])
        for s in (Scheme.PB, Scheme.PB_RF):
            for f in (0.25, 0.5, 0.75):
                cpairs.append((len(crash_traces) - 1, len(crash_cfgs)))
                crash_cfgs.append(PCSConfig(scheme=s).with_crash(f * t_pb))
    cargs, ckw = cell_inputs(crash_traces, crash_cfgs,
                             [p[0] for p in cpairs], [p[1] for p in cpairs],
                             track_addrs=64, macro=False, device="cpu")
    cgot = cs.cell_scan(*[a.cuda() for a in cargs], **ckw)
    torch.cuda.synchronize()
    fargs, fkw, fgot, fsel = full_size(torch, ftraces, fconfigs)

    (plain, plain_s, pool_s), (cplain, _, _), (fplain, fplain_s, _) = \
        eager_grids(torch, [(args, kw, list(range(len(pairs)))),
                            (cargs, ckw, list(range(len(cpairs)))),
                            (fargs, fkw, fsel)])
    plain_ms = plain_s * 1e3
    err = compare_outputs(plain, got, "budget-2000 grid")
    ms = cuda_ms(lambda: cs.cell_scan(*dargs, **kw), 3)
    max_steps = int(plain.steps.max())
    bound = cell_bytes(traces, len(pairs), 1, 1, len(configs)) \
        / HBM_BYTES_PER_S * 1e3
    latency_bound = max_steps * smem_ns / 1e6
    print(f"phase 3 cell_scan grid (7 workloads x 3 schemes, budget 2000): "
          f"exact on {len(pairs)} cells, kernel {ms:.3f} ms, eager "
          f"scan_cell {plain_s:.1f} s of cells ({pool_s:.1f} s wall over a "
          f"pool with the crash and full-size cells), longest cell "
          f"{max_steps} steps ({ms * 1e6 / max_steps:.1f} ns/step; latency "
          f"bound {latency_bound:.3f} ms at one {smem_ns:.2f} ns "
          f"shared-memory round trip per step)")
    err = max(err, compare_outputs(cplain, cgot, "crash cells"))
    print(f"phase 3 cell_scan crash cells: exact on {len(cpairs)} cells "
          f"(durable_ver, recovery_entries {cplain.n_recov.tolist()}, "
          f"recovery_ns)")
    sel_t = torch.tensor(fsel, device="cuda")
    name = ftraces[fsel[0] // len(fconfigs)].name
    ferr = compare_outputs(fplain,
                           cs.CellScanOut(*(x[sel_t] for x in fgot)),
                           f"paper grid {name}")
    print(f"phase 3 cell_scan full size: exact on the PB_RF cell of "
          f"{name} ({int(fplain.steps.max())} steps, eager scan_cell "
          f"{fplain_s:.1f} s of cells)")
    return (dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, max_abs_err=err,
                 max_steps=max_steps, latency_bound_ms=latency_bound,
                 grid=(traces, configs, pairs, plain),
                 crash=(crash_traces, crash_cfgs, cpairs, cplain)),
            (fargs, fkw, fgot, ferr))


def paper_grid():
    """The main path's traces and configs: the 7 workloads at
    ``persist_budget=100_000`` x the three schemes (Table I config)."""
    from repro_torch.core import PCSConfig, Scheme, WORKLOADS, make_trace
    t0 = time.time()
    traces = [make_trace(n, persist_budget=100_000) for n in WORKLOADS]
    print(f"phase 3 paper-grid traces built in {time.time() - t0:.1f} s "
          f"({sum(t.total_ops for t in traces)} ops)")
    return traces, [PCSConfig(scheme=s) for s in Scheme]


def full_size(torch, traces, configs):
    """The kernel on all 21 full-size cells, with the main path's own
    stacked inputs: ``(args, kw, got, sel)``, ``sel`` the shortest
    workload's PB_RF cell, which phase 3 also runs through the eager
    ``scan_cell`` on a host copy of those inputs."""
    from repro_torch.core import Scheme
    from repro_torch.core.engine.grid import cell_inputs
    from repro_torch.kernels import cell_scan as cs
    pairs = [(i, j) for i in range(len(traces)) for j in range(len(configs))]
    args, kw = cell_inputs(traces, configs, [p[0] for p in pairs],
                           [p[1] for p in pairs], device="cuda")
    got = cs.cell_scan(*args, **kw)
    torch.cuda.synchronize()
    i = min(range(len(traces)), key=lambda k: traces[k].total_ops)
    sel = [k for k, p in enumerate(pairs)
           if p[0] == i and configs[p[1]].scheme == Scheme.PB_RF]
    return args, kw, got, sel


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
    eager plain version (all of (a); lu_cont's PB_RF cell at n_switches
    4 of (b)); (d) the
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
    # the eager twin on the depth-0 and depth-4 cells (6 of 21; the kernel
    # on those alone is timed beside it); chain_ref.json holds all 21.  It
    # runs over one pool with (b)'s cells, below.
    sel = [k for k, lab in enumerate(labels) if lab[1] in (0, 4)]

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
    bsel = [k for k, p in enumerate(bpairs)
            if names[p[0]] == "lu_cont" and blabels[p[1]] == ("PB_RF", 4)]
    # (a)'s and (b)'s eager cells over one pool: (a)'s short cells run
    # beside (b)'s long ones
    (plain, plain_s, pool_s), (bplain, bplain_s, bpool_s) = eager_grids(
        torch, [(args, kw, sel), (bargs, bkw, bsel)])
    sel_t = torch.tensor(sel, device="cuda")
    err = compare_outputs(plain, cs.CellScanOut(*(x[sel_t] for x in got)),
                          "Fig. 1 sweep")
    sargs, skw = cell_inputs([tr], configs, [0] * len(sel), sel,
                             device="cuda")
    ms_sel = cuda_ms(lambda: cs.cell_scan(*sargs, **skw), 3)
    steps_a = int(got.steps.max())
    bound_a = cell_bytes([tr], len(pairs), 1, 1, len(configs),
                         kw["n_deep_max"]) / HBM_BYTES_PER_S * 1e3
    print(f"phase 8a simulate_grid (Fig. 1 sweep, 21 cells, D = "
          f"{kw['n_deep_max']}) wall {wall_a:.3f} s; launches "
          f"{json.dumps(counts_a)}; exact against chain_ref.json on all 21 "
          f"cells and the eager scan_cell on the {len(sel)} at depths 0 and "
          f"4 (eager {plain_s:.1f} s of cells, {pool_s:.1f} s wall over a "
          f"pool shared with 8b's; the kernel on those {ms_sel:.3f} ms); "
          f"kernel {ms_a:.3f} "
          f"ms, longest "
          f"cell {steps_a} steps ({ms_a * 1e6 / steps_a:.1f} ns/step; "
          f"latency bound {steps_a * smem_ns / 1e6:.3f} ms)")
    out["fig1"] = dict(counts=counts_a, wall_s=wall_a, ms=ms_a,
                       plain_s=plain_s, pool_s=pool_s, plain_cells=len(sel),
                       ms_plain_cells=ms_sel, bound_ms=bound_a,
                       steps=steps_a, max_abs_err=err,
                       persist_norm={f"{n}/{d}": r.persist_lat_ns / base
                                     for (n, d, c), r in zip(labels, cells)
                                     if not c},
                       hop_recovery={f"{n}/{d}": r.hop_recovery.tolist()
                                     for (n, d, c), r in zip(labels, cells)
                                     if c})

    sel_t = torch.tensor(bsel, device="cuda")
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
          f"scan_cell on lu_cont's PB_RF cell at n_switches 4 "
          f"({bplain_s:.1f} s of "
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
    # (the eager twin on the 1- and 8-leaf cells, 20 of 52, live and
    # crashed; fabric_ref.json holds all 52)
    str_, slabels, sconfigs = fig_fabric_grid(np, FAB_SMOKE_OPS)
    sel = [j for j, c in enumerate(sconfigs) if c.fabric.n_leaves in (1, 8)]
    ins_c, num_c = grid_timing(torch, smem_ns, [str_], sconfigs,
                               "fig_fabric at its smoke size, 1 and 8 "
                               "leaves", pairs=[(0, j) for j in sel])
    plain, plain_s, pool_s = eager_cells(torch, ins_c["args"], ins_c["kw"],
                                         list(range(len(sel))))
    err = compare_outputs(plain, ins_c["got"], "fig_fabric smoke size")
    scells = simulate_grid([str_], sconfigs)[0]
    for lab, r in zip(slabels, scells):
        same_as_datum(np, r, ref["fig_smoke"][lab], f"fabric smoke {lab}")
    print(f"phase 9c cell_scan on fig_fabric's 52 cells at its smoke size "
          f"({FAB_SMOKE_OPS} pairs a core): exact against fabric_ref.json, "
          f"and on the {len(sel)} with 1 or 8 leaves against the eager "
          f"scan_cell ({plain_s:.1f} s of cells, {pool_s:.1f} s wall over "
          f"a pool)")
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
# one trace: the configs select the instantiations, and a second trace
# only doubled the eager twin's load
COVER_TRACES = ("radiosity",)


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
    ``simulate_grid`` on smoke-size traces (``COVER_TRACES`` at
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
              for n in COVER_TRACES]
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
    # 3's grid, its PB_RF column (7 of 21 cells), and its crash cells
    from repro_torch.core import Scheme
    gtraces, gconfigs, gpairs, _ = scan["grid"]
    gpairs = [p for p in gpairs if gconfigs[p[1]].scheme == Scheme.PB_RF]
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
FLASH_SWEEP = ((2, 2, 256, 64), (1, 4, 128, 128), (1, 1, 512, 256),
               (1, 2, 256, 32))
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


def flash_over_counts(torch, np, shape=(4, 9, 3, 1024, 64),
                      seeds=range(8), limit=3e-2):
    """The bf16 route's outputs past ``limit`` at a causal prefill shape
    ``(b, h, hkv, s, d)`` (smollm-135m's unless given), per seed, against
    the plain version and against the f64 evaluation rounded to bf16
    (``phase_flash`` fails on any)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    b, h, hkv, s, d = shape
    entry = fa.route(torch.bfloat16, d)[1]
    out = dict(limit=limit, seeds=list(seeds), over_plain=[],
               over_exact=[], plain_over_exact=[], max_abs_err=[],
               entry=entry, shape=list(shape))
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
        del got, plain, exact
    print(f"phase 5 flash_attention ({entry}) outputs past {limit} at "
          f"({b}, {h}, {s}, {d}), {hkv} KV heads, bf16 causal over seeds "
          f"{out['seeds']}: vs the plain version "
          f"{out['over_plain']}, vs the f64 evaluation rounded to bf16 "
          f"{out['over_exact']} (the plain version vs it "
          f"{out['plain_over_exact']}); max abs error vs the plain version "
          f"per seed {out['max_abs_err']}")
    return out


# gemma3-12b's global layers: the widest bf16 shape of the paths
FLASH_OVER_WIDE = (4, 16, 8, 2048, 256)


def ptxas_ws():
    """ptxas's registers, stack frame and spills of each
    ``flash_ws_kernel`` instantiation, from its build log (``-Xptxas
    -v``): ``{mangled name: {registers, stack, spill_stores,
    spill_loads}}``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    out, fn = {}, None
    with open(_build._lib_path(fa.WS_BF16[0]).with_suffix(".log")) as f:
        for line in f:
            m = re.search(r"[Ff]unction properties for (\S+)", line) or \
                re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1) if "flash_ws_kernel" in m.group(1) else None
                if fn:
                    out.setdefault(fn, {})
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if fn and m:
                out[fn].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if fn and m:
                out[fn]["registers"] = int(m.group(1))
    return out


def flash_turns(torch, q, k, v, kw, reps=20):
    """The bf16 route's kernel (through the wrapper) and the present
    kernel it took over from (``TC_BF16``, through ``launch``) on the
    same inputs, timed in turns (route, present, present, route):
    ``(the present kernel's output, {"route": [ms, ms], "present": [ms,
    ms]})``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    lib = _build.library(fa.TC_BF16[0])
    old = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def present():
        _build.check(fa.launch(lib, q, k, v, old, stream=stream,
                               entry=fa.TC_BF16[1], **kw), fa.TC_BF16[1])
    present()
    torch.cuda.synchronize()
    ms = {"route": [], "present": []}
    for which in ("route", "present", "present", "route"):
        ms[which].append(cuda_ms(
            present if which == "present"
            else (lambda: fa.flash_attention(q, k, v, **kw)), reps))
    return old, ms


def phase_flash(torch, np):
    """Every route of ``flash_attention`` against the plain version: the
    JAX sweep's shapes (bf16 on the warp-specialised kernel from D = 64
    and on the present tensor-core kernel at D = 32, f32 on the
    tensor-core kernels; each case's route checked by the per-route
    launch counters); the bf16 outputs past 3e-2 over 8 seeds at
    smollm-135m's prefill shape and at gemma3-12b's global one; ptxas's
    registers and spills of the warp-specialised kernel (none allowed);
    then smollm-135m's prefill shape: each dtype's route timed beside the
    plain version and ``scaled_dot_product_attention``, bf16 in turns
    with the present kernel and f32 with the FMA kernel (both held too,
    through ``launch``)."""
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
        tc = fa.route(dtype, d)[0] in fa.TC_LIBS
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
    f8_wide = flash_over_counts(torch, np, FLASH_OVER_WIDE)
    for f in (f8, f8_wide):
        if any(f["over_plain"]) or any(f["over_exact"]):
            fail(f"flash_attention bf16 outputs past 3e-2: {f}")
    usage = ptxas_ws()
    spills = {k: v for k, v in usage.items()
              if v.get("spill_stores") or v.get("spill_loads") or
              v.get("stack")}
    print(f"phase 5 ptxas of flash_attention_ws.cu's kernels (registers "
          f"at launch, before the consumers' setmaxnreg): "
          f"{json.dumps(usage)}")
    if spills or len(usage) != 3:
        fail(f"flash_attention_ws.cu: ptxas reports spills or a missing "
             f"instantiation: {usage}")

    # the serving shape: smollm-135m prefill, 4 x 1024 tokens, 9 query
    # heads on 3 KV heads, head dim 64, causal; bf16 is the main path,
    # f32 the datum's (phase 7a)
    b, h, hkv, s, d = 4, 9, 3, 1024, 64
    pairs = s * (s + 1) // 2                        # causal (q, k) pairs
    flops = 4.0 * b * h * pairs * d                 # q·k and p·v
    out = {"f8_counts": f8, "f8_counts_wide": f8_wide, "ptxas_ws": usage}
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
        if dtype == torch.bfloat16:
            # the present kernel on the same inputs, in turns with the route
            old, turns = flash_turns(torch, q, k, v,
                                     dict(causal=True, window=None), 50)
            e_old = max_err(old, want, "flash_attention present bf16 kernel"
                            ", serving shape", TOL[name][0])
            ms = sum(turns["route"]) / 2
        else:
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                         50)
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
            rec.update(ms_turns=turns["route"], present_ms=turns["present"],
                       present_err=e_old)
            extra = (f"; the present kernel ({fa.TC_BF16[1]}, through "
                     f"launch) {turns['present']} ms beside the route's "
                     f"{turns['route']} (order route, present, present, "
                     f"route), max abs error {e_old:.3g}")
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


def device_ms_by_kernel(torch, fn, top=6):
    """Device time of the kernels ``fn()`` launches (``torch.profiler``,
    CUDA activity): (total ms, the ``top`` largest as (name, ms, calls))."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:top]


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


def breakdown(torch, model, batch, steps: int):
    """Device ms of one prefill of ``batch`` (its tokens and stub inputs)
    and of ``steps`` greedy decode steps."""
    from repro_torch.launch.serve import prefix_len
    from repro_torch.models import transformer as T
    s = batch["tokens"].shape[1] + prefix_len(model.cfg)
    with torch.inference_mode():
        pre = device_ms_by_kernel(torch, lambda: T.prefill(
            model, batch, s + steps))
        logits, caches = T.prefill(model, batch, s + steps)

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


def ssd_plain_check(torch, model, batch):
    """mamba2's bf16 prefill logits on the tensor-core route against the
    same model with ``ssd_scan_ref`` swapped into ``models.ssm`` (here
    only, never on the main path), and the same with the plain version at
    chunk 64 against chunk 128 (the bf16 model's own order floor)."""
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    s = batch["tokens"].shape[1]

    def logits():
        with torch.inference_mode():
            return T.prefill(model, batch, s + 1)[0].float()

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
    from repro_torch.launch.serve import random_batch, serve
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
        batch = random_batch(cfg, 4, 1024, 0, "cuda")
        # warm-up at the served shape: builds, and the caching allocator's
        # blocks, so the timed run's prefill wall holds no first-call
        # cudaMalloc
        serve(model, batch, 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches_tc = fa.launches_fma = 0
        fa.launches_by = {}
        ss.launches_tc = ss.launches_fma = 0
        tl.launches = cs.launches = 0
        res = serve(model, batch, 64)
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
        want_by = ({} if cfg.attn_free else
                   {fa.route(torch.bfloat16, cfg.hd)[1]: cfg.n_layers})
        if counts != want or by_entry != want_by:
            fail(f"{arch} serve launched {counts}, by entry {by_entry}, "
                 f"expected {want}, {want_by} (one prefill launch per "
                 f"layer)")
        tok_s = 4 * 64 / res.decode_s
        print(f"phase 7b {arch} bf16 served 4 x 1024 prompt + 64 greedy "
              f"steps: prefill {res.prefill_s * 1e3:.1f} ms, decode "
              f"{res.decode_s * 1e3:.1f} ms ({tok_s:.1f} tokens/s); "
              f"launches {json.dumps(counts)}; peak memory {peak:.2f} GiB; "
              f"first tokens {res.tokens[0, :8].tolist()}")
        (pre_ms, pre_top), (dec_ms, dec_top) = breakdown(torch, model,
                                                         batch, 8)
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
        plain_check = (ssd_plain_check(torch, model, batch)
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
                         decode_step_device_ms=dec_ms / 8,
                         tokens=res.tokens.tolist())
        del model
        torch.cuda.empty_cache()
    return out


# ---- phase 13: the attention family ---------------------------------------
# The f32 datum's launches of flash_attention by C entry (a prefill; the
# encoder-decoder's encoder and decoder self-attention, never its
# cross-attention; softcapped and prefix-LM layers never).
FAMILY_DATUM_LAUNCHES = {
    "gemma2-2b": {}, "paligemma-3b": {},
    "gemma3-12b": {"flash_attention_tc_f32_256_launch": 6},
    "seamless-m4t-large-v2": {"flash_attention_tc_f32_launch": 24}}
# The bf16 serves at full width with device-filled weights: arch ->
# (layers served, None for all; prompt tokens; launches of the bf16
# route's entry at the config's head dim a prefill makes).
FAMILY_SERVE = {"gemma3-12b": (None, 2048, 48), "gemma2-2b": (None, 1024, 0),
                "paligemma-3b": (None, 1024, 0),
                "seamless-m4t-large-v2": (None, 1024, 24),
                "deepseek-67b": (16, 1024, 16)}
# The kernel at each new shape of these paths: (row, dtype name, b, h, hkv,
# s, d, causal, window).
FAMILY_SHAPES = (
    ("gemma3-12b", "bfloat16", 4, 16, 8, 2048, 256, True, 1024),
    ("gemma3-12b global", "bfloat16", 4, 16, 8, 2048, 256, True, None),
    ("gemma3-12b f32 datum", "float32", 2, 16, 8, 1100, 256, True, 1024),
    ("gemma3-12b f32 datum global", "float32", 2, 16, 8, 1100, 256, True,
     None),
    ("deepseek-67b", "bfloat16", 4, 64, 8, 1024, 128, True, None),
    ("seamless-m4t-large-v2", "bfloat16", 4, 16, 16, 1024, 64, True, None),
    ("seamless-m4t-large-v2 encoder", "bfloat16", 4, 16, 16, 256, 64, False,
     None))


def family_ref(name="serve_ref_families.json"):
    with open(os.path.join(ROOT, "src", "repro_torch", "testdata",
                           name)) as f:
        return json.load(f)


def moe_ref():
    return family_ref("serve_ref_moe.json")


def datum_config(torch, arch, d):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=d["layers"],
                               dtype=torch.float32)


class DatumTrees:
    """``numpy_params`` of each config of serve_ref_families.json, then of
    serve_ref_moe.json, drawn on a background thread (numpy's generator
    releases the GIL) while phases 8-11 run; :meth:`get` waits for one and
    hands it over with its fill seconds."""

    def __init__(self, torch):
        import threading
        self.ref, self.moe_ref = family_ref(), moe_ref()
        self.configs = {**self.ref["configs"], **self.moe_ref["configs"]}
        self._out, self._err = {}, None
        self._ready = {a: threading.Event() for a in self.configs}
        self._thread = threading.Thread(target=self._fill, args=(torch,),
                                        daemon=True)
        self._thread.start()

    def _fill(self, torch):
        from repro_torch.models.convert import numpy_params
        try:
            for arch, d in self.configs.items():
                t0 = time.time()
                tree = numpy_params(datum_config(torch, arch, d), d["seed"])
                self._out[arch] = (tree, time.time() - t0)
                self._ready[arch].set()
        except BaseException as e:      # handed to get(), which raises
            self._err = e
            for ev in self._ready.values():
                ev.set()

    def get(self, arch):
        self._ready[arch].wait()
        if self._err is not None:
            fail(f"phase 13a/14a: the numpy weight fill failed: "
                 f"{self._err!r}")
        return self._out.pop(arch)


# Phase 13a's limit on the card: each step's f32 logits within this share
# of its largest stored |logit| (the datum's own rtol, 1e-3, bounds the
# port on the CPU in the tests).  Sound runs read 1.87e-7 to 8.72e-7 on
# the card; the planted faults below read above it (PERF.md).
FAMILY_DATUM_RTOL = 1e-5


def datum_run(torch, model, batch, d, s, enc):
    """Prefill, then the datum's decode steps, each fed the reference's
    greedy token: per step (logits, the stored ids, their stored logits),
    and the prefill's launches by C entry."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    zero_kernel_counts()
    logits, caches = T.prefill(model, batch, s + d["decode_steps"])
    torch.cuda.synchronize()
    launched = (dict(fa.launches_by), fa.launches_fma)
    steps = []
    for i, st in enumerate(d["steps"]):
        ids = torch.tensor(st["ids"], device="cuda")
        steps.append((logits, ids, torch.tensor(st["logits"],
                                                device="cuda")))
        if i == d["decode_steps"]:
            break
        logits, caches = T.decode_step(model, ids[:, :1], caches,
                                       pos0=s + i, **enc)
    torch.cuda.synchronize()
    return steps, launched


def step_rel(torch, logits, ids, want):
    """The largest |logit - stored| over the stored ids, as a share of
    the row's largest stored |logit|; the worst row."""
    got = torch.gather(logits, 1, ids)
    return float(((got - want).abs().max(dim=1).values
                  / want.abs().max(dim=1).values).max())


def datum_plants(cfg):
    """The faults planted in a datum model to show what the limit sees:
    the sliding window one key short (its prefill mask and its decode
    ring), and the sliding layers' RoPE base set to the global layers'."""
    if not cfg.window or not any(sp.kind == "swa"
                                 for sp in cfg.block_pattern):
        return ()
    return (("window - 1",) + (("swa RoPE base = global",)
                               if cfg.rope_theta != 10_000.0 else ()))


def planted(model, what):
    """Plant ``what`` (one of :func:`datum_plants`) in ``model``; returns
    the function that takes it out."""
    import dataclasses
    cfg = model.cfg
    blocks = [blk for blk in model.layers if blk.window]
    saved = [(blk.window, blk.attn.rope_theta) for blk in blocks]
    if what == "window - 1":
        model.cfg = dataclasses.replace(cfg, window=cfg.window - 1)
        for blk in blocks:
            blk.window -= 1
    else:
        for blk in blocks:
            blk.attn.rope_theta = cfg.rope_theta

    def undo():
        model.cfg = cfg
        for blk, (w, theta) in zip(blocks, saved):
            blk.window, blk.attn.rope_theta = w, theta
    return undo


def family_datum(torch, arch, d, trees, phase="13a",
                 launches=FAMILY_DATUM_LAUNCHES, plant=True,
                 datum="serve_ref_families.json"):
    """One config of ``datum`` in f32 on the card, fed the reference's
    greedy tokens: the worst relative logit error, greedy tokens checked,
    the prefill's launches by C entry (``launches[arch]``), and with
    ``plant`` the worst error of each planted fault (which must exceed
    the limit)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prefix_len, random_batch
    from repro_torch.models.convert import params_from_reference
    rtol = FAMILY_DATUM_RTOL
    cfg = datum_config(torch, arch, d)
    tree, fill_s = trees.get(arch)
    model = params_from_reference(cfg, tree, "cuda")
    del tree
    batch = random_batch(cfg, d["batch"], d["prompt_len"], d["seed"], "cuda")
    if batch["tokens"].tolist() != d["prompt"]:
        fail(f"phase {phase} {arch}: the prompt drawn from the seed is not "
             f"the datum's")
    s = prefix_len(cfg) + d["prompt_len"]
    worst, checked, agree = 0.0, 0, 0
    with torch.inference_mode():
        enc = {}
        if cfg.is_enc_dec:
            enc = dict(zip(("enc_out", "enc_pos"),
                           model.encode(batch["enc_embeds"])))
        steps, (by_entry, fma) = datum_run(torch, model, batch, d, s, enc)
        for i, (logits, ids, want) in enumerate(steps):
            rel = step_rel(torch, logits, ids, want)
            worst = max(worst, rel)
            if rel > rtol or not bool(torch.isfinite(logits).all()):
                fail(f"phase {phase} {arch} f32 step {i}: logits off the "
                     f"reference by {rel:.3g} relative (limit {rtol})")
            scale = want.abs().max(dim=1).values
            margin = (want[:, 0] - want[:, 1]) / scale
            top1 = logits.argmax(dim=1)
            for j in range(ids.shape[0]):
                if float(margin[j]) > rtol:
                    checked += 1
                    if int(top1[j]) != int(ids[j, 0]):
                        fail(f"phase {phase} {arch} f32 step {i} seq {j}: "
                             f"greedy "
                             f"{int(top1[j])}, reference {int(ids[j, 0])}")
                agree += int(top1[j]) == int(ids[j, 0])
        del steps
        plants = {}
        for what in (datum_plants(cfg) if plant else ()):
            undo = planted(model, what)
            try:
                steps, _ = datum_run(torch, model, batch, d, s, enc)
            finally:
                undo()
            plants[what] = max(step_rel(torch, *st) for st in steps)
            del steps
    if by_entry != launches[arch] or fma:
        fail(f"phase {phase} {arch} f32 prefill launched {by_entry} (FMA "
             f"{fma}), expected {launches[arch]}")
    print(f"phase {phase} {arch} f32 ({d['layers']} of "
          f"{get_config(arch).n_layers}"
          f" layers, {d['batch']} x {d['prompt_len']} prompt"
          + (f" after {prefix_len(cfg)} prefix embeddings"
             if prefix_len(cfg) else "")
          + (f", {d['enc_frames']} frames, decode given the encoder output"
             if cfg.is_enc_dec else "")
          + f", window {cfg.window}, {d['decode_steps']} decode steps): "
          f"logits within {worst:.3g} relative of {datum} "
          f"(limit {rtol}); greedy tokens equal on {checked} checked (margin "
          f"> limit), {agree}/{len(d['steps']) * d['batch']} in all; prefill "
          f"launches {json.dumps(by_entry)}; numpy weight fill {fill_s:.1f} s "
          f"(on a background thread)"
          + "".join(f"; planted {w}: {r:.3g}" for w, r in plants.items()))
    for what, r in plants.items():
        if not r > rtol:
            fail(f"phase {phase} {arch}: the planted fault '{what}' reads "
                 f"{r:.3g}, within the limit {rtol}: the check cannot see it")
    return dict(rel=worst, checked=checked, agree=agree, launches=by_entry,
                fill_s=fill_s, planted=plants)


def swapped_logits(torch, model, batch, max_len, swaps):
    """The prefill's last-position logits (f32) with ``swaps`` (module,
    attribute, function) set for the call only."""
    from repro_torch.models import transformer as T
    saved = [(m, a, getattr(m, a)) for m, a, _ in swaps]
    try:
        for m, a, fn in swaps:
            setattr(m, a, fn)
        with torch.inference_mode():
            return T.prefill(model, batch, max_len)[0].float()
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)


# Each kernel call of a full-width bf16 prefill (phases 13b and 14b) may
# differ from its plain version on the same inputs by at most this share of
# ||plain||, over the call's whole output (y for the SSD): the per-row limit
# of phase 13c, which the norm over a call reads below.
SITE_BF16_RTOL = 2.0 ** -6


def logits_vs_plain(torch, model, batch, max_len, kernels):
    """The bf16 prefill on the kernels, every kernel call held at its site
    against its plain version on the same inputs (``site``: the largest
    ||kernel - plain|| / ||plain|| over the kernel's calls); and the
    prefill's logits against the same model with one plain version swapped
    in at a time (``flash_attention_ref`` into ``models.attention``,
    ``ssd_scan_ref`` into ``models.ssm``; here only) and, for each, against
    that plain model with the kernel's place returning zeros (how much of
    it the logits see), as ||a - b|| / ||b|| over all the logits; where
    there are two kernels, also against every plain version at once;
    greedy agreement with the all-plain model."""
    from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_ref
    from repro_torch.models import attention as A
    from repro_torch.models import ssm

    def zero_ssd(x, dt, A_, B, C, chunk, init_state=None):
        b, _, h, p = x.shape
        return (torch.zeros_like(x), torch.zeros(
            (b, h, p, B.shape[-1]), dtype=torch.float32, device=x.device))
    plain = {"flash_attention": (A, "flash_attention", flash_attention_ref),
             "ssd_scan": (ssm, "ssd_scan", ssd_scan_ref)}
    zero = {"flash_attention": lambda q, k, v, **kw: torch.zeros_like(q),
            "ssd_scan": zero_ssd}

    def rel(a, b):
        a, b = a.float(), b.float()
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    site = {k: [] for k in kernels}

    def held(k):
        m, a, ref_fn = plain[k]
        kern = getattr(m, a)

        def call(*args, **kw):
            got, want = kern(*args, **kw), ref_fn(*args, **kw)
            first = (lambda t: t[0] if isinstance(t, tuple) else t)
            site[k].append(rel(first(got), first(want)))
            return got
        return m, a, call

    def logits(swaps):
        return swapped_logits(torch, model, batch, max_len, swaps)
    kernel = logits([held(k) for k in kernels])
    out = {"site": {k: max(v) for k, v in site.items()},
           "site_calls": {k: len(v) for k, v in site.items()},
           "rel": {}, "zeroed_rel": {}}
    for k in kernels:
        m, a, _ = plain[k]
        ref = logits([plain[k]])
        out["rel"][k] = rel(kernel, ref)
        out["zeroed_rel"][k] = rel(logits([(m, a, zero[k])]), ref)
    every = logits([plain[k] for k in kernels]) if len(kernels) > 1 else ref
    out.update(rel_all_plain=rel(kernel, every),
               greedy_agree=int((kernel.argmax(1) == every.argmax(1)).sum()),
               rows=kernel.shape[0])
    return out


def plain_check_failure(check):
    """What of ``logits_vs_plain``'s check failed, or None: a kernel call
    off its plain version by more than ``SITE_BF16_RTOL``, or logits off
    the plain version swapped in by more than a tenth of what zeroing the
    kernel moves them."""
    site = {k: r for k, r in check["site"].items()
            if not r <= SITE_BF16_RTOL}
    logits = {k: r for k, r in check["rel"].items()
              if not r <= check["zeroed_rel"][k] / 10}
    if site:
        return (f"a kernel call off its plain version on the same inputs by "
                f"{site} relative (limit {SITE_BF16_RTOL})")
    if logits:
        return (f"prefill logits off the plain version by {logits} "
                f"relative, over a tenth of what zeroing the kernel moves "
                f"them ({check['zeroed_rel']})")
    return None


def plain_check_text(check):
    """``logits_vs_plain``'s readings, for a phase's line."""
    return (f"each kernel call vs its plain version on the same inputs, "
            f"largest ||diff|| / ||plain||: {json.dumps(check['site'])} over "
            f"{json.dumps(check['site_calls'])} calls (limit "
            f"{SITE_BF16_RTOL}); prefill logits vs each plain version "
            f"swapped in: {json.dumps(check['rel'])} (limit a tenth of what "
            f"zeroing that kernel moves them: "
            f"{json.dumps(check['zeroed_rel'])}); vs every plain version "
            f"{check['rel_all_plain']:.3g}, greedy agree "
            f"{check['greedy_agree']}/{check['rows']}")


def family_serve(torch, arch, layers, prompt_len, want):
    """The published bf16 config (``layers`` of it, or all) served at full
    width with device-filled weights: 4 requests of ``prompt_len`` tokens
    (after the vision prefix; 1/4 as many frames for the encoder), 64
    greedy steps; launches asserted, the prefill's logits held against
    the plain version swapped in."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import prefix_len, random_batch, serve
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import device_fill
    cfg = get_config(arch)
    full = cfg.n_layers
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.empty_cache()
    t0 = time.time()
    model = device_fill(T.Transformer(cfg, "cuda"), 0)
    torch.cuda.synchronize()
    fill_s = time.time() - t0
    batch = random_batch(cfg, 4, prompt_len, 0, "cuda")
    serve(model, batch, 2)          # warm-up at the served shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    res = serve(model, batch, 64)
    counts = kernel_counts()
    by_entry = dict(fa.launches_by)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if res.tokens.shape != (4, 64) or res.tokens.min() < 0 \
            or res.tokens.max() >= cfg.vocab:
        fail(f"phase 13b {arch} served tokens of shape {res.tokens.shape}")
    want_by = {fa.route(torch.bfloat16, cfg.hd)[1]: want} if want else {}
    if by_entry != want_by or counts != dict(
            tat_lookup=0, cell_scan=0, flash_attention=want, ssd_scan=0):
        fail(f"phase 13b {arch} serve launched {counts}, by entry "
             f"{by_entry}; expected {want_by}")
    tok_s = 4 * 64 / res.decode_s
    max_len = prompt_len + prefix_len(cfg) + 64
    check = (logits_vs_plain(torch, model, batch, max_len,
                             ["flash_attention"]) if want else None)
    failed = plain_check_failure(check) if check else None
    shape = (f"4 x {prompt_len} prompt"
             + (f" after {prefix_len(cfg)} prefix embeddings"
                if prefix_len(cfg) else "")
             + (f", {prompt_len // 4} frames" if cfg.is_enc_dec else ""))
    print(f"phase 13b {arch} bf16 ({cfg.n_layers} of {full} layers"
          + (", cut to fit one card" if layers else "") + f") served {shape}"
          f" + 64 greedy steps: prefill {res.prefill_s * 1e3:.1f} ms, decode "
          f"{res.decode_s * 1e3:.1f} ms ({tok_s:.1f} tokens/s); launches "
          f"{json.dumps(by_entry)}; peak memory {peak:.2f} GiB; device fill "
          f"{fill_s:.1f} s; first tokens {res.tokens[0, :8].tolist()}"
          + (f"; {plain_check_text(check)}" if check else ""))
    if failed:
        fail(f"phase 13b {arch} bf16: {failed}")
    out = dict(layers=cfg.n_layers, of_layers=full, shape=shape,
               launches=by_entry, prefill_ms=res.prefill_s * 1e3,
               decode_ms=res.decode_s * 1e3, decode_tok_s=tok_s,
               peak_gib=peak, fill_s=fill_s, vs_plain=check)
    if arch == "gemma3-12b":
        (pre_ms, pre_top), (dec_ms, dec_top) = breakdown(torch, model, batch,
                                                         8)
        step_wall = res.decode_s * 1e3 / 64
        print(f"phase 13b {arch} device time (torch.profiler): prefill "
              f"{pre_ms:.2f} ms, {100 * pre_ms / (res.prefill_s * 1e3):.1f}"
              f" % of its wall; decode {dec_ms / 8:.3f} ms per step, "
              f"{100 * dec_ms / 8 / step_wall:.1f} % of its "
              f"{step_wall:.2f} ms wall")
        for what, top in (("prefill", pre_top), ("decode x8", dec_top)):
            for name, ms, calls in top:
                print(f"  {what}: {ms:9.3f} ms {calls:6d} calls  "
                      f"{name[:90]}")
        out.update(prefill_device_ms=pre_ms, decode_step_device_ms=dec_ms / 8,
                   prefill_top=pre_top, decode_top=dec_top)
    del model
    torch.cuda.empty_cache()
    return out


# Phase 13c's bf16 limit: the largest |kernel - plain| over each output row
# (b, h, query) as a share of that row's largest |plain|, two bf16 ulps of
# the row's largest value.  TOL's absolute 3e-2 is ~0.6 of a typical output
# at S = 2048 with a window of 1024 and sees no one-key fault.
FAMILY_BF16_ROW_RTOL = 2.0 ** -6


def row_rel(torch, got, want):
    """The worst row's largest |got - want| over its largest |want|."""
    g, w = got.float(), want.float()
    return float(((g - w).abs().amax(-1) / w.abs().amax(-1)).max())


def abs_err(torch, got, want):
    return float((got.float() - want.float()).abs().max())


def family_kernel(torch, np, row, dtype_name, b, h, hkv, s, d, causal,
                  window, phase="13c"):
    """The kernel at one shape of these paths against the plain version,
    timed with CUDA events beside ``scaled_dot_product_attention`` (GQA,
    a boolean mask where there is a window); its route checked by the
    per-entry counter; the bound counts only the pairs the mask keeps.
    Where the route is the warp-specialised bf16 kernel, the present
    kernel (``TC_BF16``) is held to the same limit and timed in turns
    with it."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    dtype = getattr(torch, dtype_name)
    rng = np.random.default_rng(s + d + h)
    q, k, v = (torch.tensor(rng.standard_normal((b, s, n, d)),
                            dtype=torch.float32, device="cuda")
               .to(dtype).transpose(1, 2) for n in (h, hkv, hkv))
    kw = dict(causal=causal, window=window)
    entry = fa.route(dtype, d)[1]
    ws = entry == fa.WS_BF16[1]
    n0 = fa.launches_by.get(entry, 0)
    got = fa.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    if fa.launches_by.get(entry, 0) - n0 != 1:
        fail(f"phase {phase} {row}: {entry} not launched")
    err = max_err(got, want, f"phase {phase} {row}", TOL[dtype_name][0])
    # bf16 is held per output row (an absolute limit at these shapes sits
    # near a typical output value); f32 by its absolute limit.  Where there
    # is a window, the plain version one key short stands for a planted
    # window-edge fault, which must read above the limit.
    if dtype == torch.bfloat16:
        limit, how = FAMILY_BF16_ROW_RTOL, "of each row's largest |plain|"
        measure = row_rel
    else:
        limit, how, measure = TOL[dtype_name][0], "absolute", abs_err
    worst = measure(torch, got, want)
    if not worst <= limit:
        fail(f"phase {phase} {row}: kernel off the plain version by "
             f"{worst:.3g}"
             f" {how} (limit {limit})")
    plant = None
    if window:
        plant = measure(torch, got, flash_attention_ref(
            q, k, v, causal=causal, window=window - 1))
        if not plant > limit:
            fail(f"phase {phase} {row}: the plain version at window "
                 f"{window - 1}"
                 f" reads {plant:.3g} {how}, within the limit {limit}: the "
                 f"check cannot see a one-key window-edge fault")
    present = None
    if ws:
        # the kernel the route took over from, held to the same limit and
        # timed in turns with it
        old, turns = flash_turns(torch, q, k, v, kw)
        present = dict(ms=turns["present"], route_ms=turns["route"],
                       max_abs_err=max_err(old, want, f"phase {phase} {row} "
                                           f"present kernel",
                                           TOL[dtype_name][0]),
                       checked=measure(torch, old, want))
        if not present["checked"] <= limit:
            fail(f"phase {phase} {row}: the present kernel off the plain "
                 f"version by {present['checked']:.3g} {how}")
        ms = sum(turns["route"]) / 2
        del old
    else:
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), 20)
    plain = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw), 3)
    i = torch.arange(s, device="cuda")
    mask = torch.ones((s, s), dtype=torch.bool, device="cuda")
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window:
        mask &= i[None, :] > i[:, None] - window
    pairs = int(mask.sum())
    sdpa_kw = (dict(attn_mask=mask) if window
               else dict(is_causal=causal))
    lib_out = F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                             **sdpa_kw)
    torch.cuda.synchronize()
    lib_err = float((lib_out.float() - want.float()).abs().max())
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **sdpa_kw), 20)
    size = q.element_size()
    flops = 4.0 * b * h * pairs * d
    nbytes = size * (2.0 * b * h * s * d + 2.0 * b * hkv * s * d)
    split = 6 if dtype == torch.float32 else 1
    bound_ms, bound_by = bound(split * flops, nbytes)
    print(f"phase {phase} flash_attention ({entry}) {row}: q ({b}, {h}, {s}, "
          f"{d})"
          f", k/v {hkv} heads, {dtype_name}, causal={causal}, window={window}"
          f": max abs error {err:.3g}, {worst:.3g} {how} (limit {limit}"
          + (f"; window {window - 1} planted: {plant:.3g}" if window else "")
          + f"); kernel {ms:.4f} ms, plain {plain:.4f} "
          f"ms, scaled_dot_product_attention {lib:.4f} ms (its error "
          f"{lib_err:.3g}); bound {bound_ms:.5f} ms ({bound_by}: "
          f"{flops / 1e9:.2f} GFLOP over {pairs} kept pairs"
          + (" x 6 split products" if split > 1 else "")
          + f", {nbytes / 1e6:.1f} MB); {ms / bound_ms:.2f}x the bound, "
          f"{ms / lib:.2f}x SDPA"
          + (f"; the present kernel ({fa.TC_BF16[1]}, through launch) "
             f"{present['ms']} ms beside {present['route_ms']} (order "
             f"route, present, present, route), max abs error "
             f"{present['max_abs_err']:.3g}, {present['checked']:.3g} "
             f"{how}" if present else ""))
    return dict(entry=entry, max_abs_err=err, checked=worst, present=present,
                checked_how=how, limit=limit, planted_window_fault=plant,
                ms=ms, plain_ms=plain,
                library_ms=lib, library_err=lib_err, bound_ms=bound_ms,
                bound_by=bound_by, pairs=pairs,
                shape=f"q ({b}, {h}, {s}, {d}), k/v ({b}, {hkv}, {s}, {d}),"
                      f" {dtype_name}, causal={causal}, window={window}")


def phase_family(torch, np, trees):
    """Phase 13: the attention family (sliding windows, softcaps, qk-norm,
    the prefix-LM, the encoder-decoder): (a) four configs in f32 against
    serve_ref_families.json (their weights from ``trees``, a
    :class:`DatumTrees`), (b) five served in bf16 at full width, (c) the
    kernel at each new shape."""
    ref = trees.ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    out = {"datum": {}, "serve": {}, "kernel": {}}
    for arch, d in ref["configs"].items():
        out["datum"][arch] = family_datum(torch, arch, d, trees)
        torch.cuda.empty_cache()
    for arch, (layers, s, want) in FAMILY_SERVE.items():
        out["serve"][arch] = family_serve(torch, arch, layers, s, want)
    for row, *shape in FAMILY_SHAPES:
        out["kernel"][row] = family_kernel(torch, np, row, *shape)
    out["phase_s"] = time.time() - t0
    print(f"phase 13 done in {out['phase_s']:.1f} s")
    return out


# ---- phase 14: the MoE family ---------------------------------------------
# The f32 datum's prefill launches of flash_attention by C entry: the one
# layer's self-attention on the f32 D <= 128 kernel.
MOE_DATUM_LAUNCHES = {"mixtral-8x7b": {"flash_attention_tc_f32_launch": 1},
                      "phi3.5-moe-42b": {"flash_attention_tc_f32_launch": 1}}
# The bf16 serves at full width with device-filled weights, cut in depth to
# fit one card: arch -> (layers served, requests, prompt tokens, launches
# of the bf16 attention route's entry and of ssd_scan_tc_launch a prefill
# makes).
# jamba's cut keeps the first 5 layers of its 8-layer block (ssm, ssm+MoE,
# ssm, ssm+MoE, attn), so its block pattern is cut with it.
MOE_SERVE = {"mixtral-8x7b": (16, 2, 4160, 16, 0),
             "phi3.5-moe-42b": (16, 4, 1024, 16, 0),
             "jamba-1.5-large-398b": (5, 2, 1024, 1, 4)}
# The kernels at each new shape of these paths: flash_attention as in
# FAMILY_SHAPES, and jamba's SSD (b, s, h, p, n, chunk) in bf16.
MOE_FLASH_SHAPES = (
    ("mixtral-8x7b", "bfloat16", 2, 32, 8, 4160, 128, True, 4096),
    ("mixtral-8x7b f32 datum", "float32", 1, 32, 8, 4160, 128, True, 4096),
    ("phi3.5-moe-42b", "bfloat16", 4, 32, 8, 1024, 128, True, None),
    ("phi3.5-moe-42b f32 datum", "float32", 2, 32, 8, 256, 128, True, None),
    ("jamba-1.5-large-398b", "bfloat16", 2, 64, 8, 1024, 128, True, None))
MOE_SSD_SHAPE = (2, 1024, 256, 64, 128, 128)


def moe_config(arch, layers):
    """The published config of ``arch`` cut to its first ``layers``
    layers (and, where the block is longer, its block pattern with it)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    pattern = cfg.block_pattern
    if layers % len(pattern):
        pattern = pattern[:layers]
    return dataclasses.replace(cfg, n_layers=layers, block_pattern=pattern)


@contextlib.contextmanager
def moe_spied(rows=None, ranges=False):
    """While open, wraps ``models.moe._moe_group`` (each routing group:
    one a MoE layer at serving) and ``models.moe._bmm_f32`` (every expert
    product): with ``ranges``, each in a ``record_function`` range
    (``moe_layer``, ``moe_expert_product``); with a list ``rows``, each
    group appends [its routed rows ``n * k``, the rows its expert
    products saw]."""
    from torch.profiler import record_function
    from repro_torch.models import moe
    real_group, real_product = moe._moe_group, moe._bmm_f32

    def group(p, xt, **kw):
        if rows is not None:
            rows.append([xt.shape[0] * kw["top_k"], 0])
        if not ranges:
            return real_group(p, xt, **kw)
        with record_function("moe_layer"):
            return real_group(p, xt, **kw)

    def product(a, b, *out):
        if rows is not None:
            rows[-1][1] += a.shape[:-1].numel()
        if not ranges:
            return real_product(a, b, *out)
        with record_function("moe_expert_product"):
            return real_product(a, b, *out)
    moe._moe_group, moe._bmm_f32 = group, product
    try:
        yield
    finally:
        moe._moe_group, moe._bmm_f32 = real_group, real_product


def range_ms(prof, name):
    """(host ms, device ms) of a ``record_function`` range: its host
    event's CPU time and the device time of the kernels it launched (the
    range also shows on the device as an annotation, which is no
    kernel)."""
    from torch.autograd import DeviceType
    host = dev = 0.0
    for e in prof.key_averages():
        if e.key == name and e.device_type == DeviceType.CPU:
            host += e.cpu_time_total / 1e3
            dev += e.device_time_total / 1e3
    return host, dev


def moe_device_breakdown(torch, model, batch, max_len):
    """Device time of one bf16 prefill (``torch.profiler``): in all, by
    kernel, and by the op that launched it: the expert products (every
    call of ``models.moe._bmm_f32``, in a range of ``moe_spied``: at
    serving they are ``aten::mm``s over each expert's routed rows), the
    other GEMMs (``aten::mm``, ``aten::addmm``), attention (the flash
    kernel), dispatch and combine (indexing, scatter, gather, the sort and
    the counts, argmax, concatenation) and the rest (elementwise, casts,
    reductions)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    torch.cuda.synchronize()
    with moe_spied(ranges=True), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            T.prefill(model, batch, max_len)
        torch.cuda.synchronize()
    experts = range_ms(prof, "moe_expert_product")[1]
    kernels, ops = [], {}
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if e.key in ("moe_layer", "moe_expert_product"):
            continue
        if e.device_type == DeviceType.CPU:
            ops[e.key] = ops.get(e.key, 0.0) + ms
        elif ms > 0:
            kernels.append((e.key, ms, e.count))
    kernels.sort(key=lambda r: -r[1])
    total, top = sum(r[1] for r in kernels), kernels[:12]
    dispatch = ("aten::index_put_", "aten::index", "aten::index_add",
                "aten::index_add_", "aten::cumsum", "aten::gather",
                "aten::argmax", "aten::one_hot", "aten::cat",
                "aten::scatter", "aten::scatter_", "aten::repeat",
                "aten::where", "aten::eq", "aten::lt", "aten::sort",
                "aten::arange", "aten::ones_like", "aten::stack",
                "aten::remainder", "aten::_local_scalar_dense")
    gemm = sum(ops.get(k, 0.0) for k in ("aten::mm", "aten::addmm",
                                         "aten::bmm"))
    groups = {"expert products (moe._bmm_f32)": experts,
              "other GEMM (aten::mm)": gemm - experts,
              "attention (flash kernel)": sum(
                  r[1] for r in kernels
                  if "flash_tc_kernel" in r[0] or "flash_ws_kernel" in r[0]),
              "dispatch and combine": sum(ops.get(k, 0.0)
                                          for k in dispatch)}
    groups["rest"] = total - sum(groups.values())
    return total, groups, top


def moe_expert_rows(torch, model, batch, max_len):
    """One bf16 prefill under ``moe_spied``: for each routing group (one a
    MoE layer at serving), [its routed rows ``n * k``, the rows its
    expert products saw].  Gate, up and down each over the routed rows
    alone make the second ``3 * n * k``."""
    from repro_torch.models import transformer as T
    seen = []
    with moe_spied(rows=seen), torch.inference_mode():
        T.prefill(model, batch, max_len)
    return seen


def moe_decode_profile(torch, model, batch, max_len, steps=8):
    """``steps`` greedy decode steps after a prefill and two warm steps,
    under ``torch.profiler`` with the MoE layers in ``moe_spied`` ranges:
    per step, the host ms in all (the profiled loop's wall) and in the
    MoE layers (their ranges' CPU time, each wait for the counts
    included), the device ms (kernels) and the kernels launched; and
    the six ops with the most host self time and the six kernels with
    the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    s = batch["tokens"].shape[1]
    prefill, decode = make_prefill_step(model, max_len), make_decode_step(
        model)
    with torch.inference_mode():
        logits, caches = prefill(batch)
        for i in range(2):
            logits, caches = decode(logits.argmax(dim=-1)[:, None], caches,
                                    s + i)
        torch.cuda.synchronize()
        with moe_spied(ranges=True), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(2, 2 + steps):
                logits, caches = decode(logits.argmax(dim=-1)[:, None],
                                        caches, s + i)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
    ev = prof.key_averages()
    ranges = ("moe_layer", "moe_expert_product")
    # the ranges show on the device as annotations as long as their
    # walls, which are no kernels
    dev = sum(e.self_device_time_total for e in ev
              if e.device_type != DeviceType.CPU
              and e.key not in ranges) / 1e3
    launches = sum(e.count for e in ev if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
        "cuLaunchKernelEx"))
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / steps,
                    e.count // steps) for e in ev
                   if e.device_type == DeviceType.CPU
                   and e.key not in ranges), key=lambda r: -r[1])
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / steps,
                       e.count // steps) for e in ev
                      if e.device_type != DeviceType.CPU
                      and e.self_device_time_total > 0
                      and e.key not in ranges), key=lambda r: -r[1])
    return dict(host_ms_per_step=wall * 1e3 / steps,
                moe_host_ms_per_step=range_ms(prof, "moe_layer")[0] / steps,
                device_ms_per_step=dev / steps,
                launches_per_step=launches / steps, top_host=host[:6],
                top_device=kernels[:6])


def moe_serve(torch, arch, layers, n_req, prompt_len, want_fa, want_ssd):
    """The published bf16 config cut to ``layers`` served at full width
    with device-filled weights: ``n_req`` requests of ``prompt_len``
    tokens, 64 greedy steps; launches asserted, the prefill's logits held
    against the plain versions swapped in."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch.serve import random_batch, serve
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import device_fill
    from repro_torch.configs import get_config
    full = get_config(arch).n_layers
    cfg = moe_config(arch, layers)
    torch.cuda.empty_cache()
    t0 = time.time()
    model = device_fill(T.Transformer(cfg, "cuda"), 0)
    torch.cuda.synchronize()
    fill_s = time.time() - t0
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    batch = random_batch(cfg, n_req, prompt_len, 0, "cuda")
    serve(model, batch, 2)          # warm-up at the served shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    res = serve(model, batch, 64)
    counts = kernel_counts()
    by_entry = dict(fa.launches_by)
    ssd_tc = ss.launches_tc
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if res.tokens.shape != (n_req, 64) or res.tokens.min() < 0 \
            or res.tokens.max() >= cfg.vocab:
        fail(f"phase 14b {arch} served tokens of shape {res.tokens.shape}")
    want_by = ({fa.route(torch.bfloat16, cfg.hd)[1]: want_fa} if want_fa
               else {})
    if by_entry != want_by or ssd_tc != want_ssd or counts != dict(
            tat_lookup=0, cell_scan=0, flash_attention=want_fa,
            ssd_scan=want_ssd):
        fail(f"phase 14b {arch} serve launched {counts}, flash by entry "
             f"{by_entry}, ssd_scan_tc {ssd_tc}; expected {want_by}, "
             f"{want_ssd}")
    tok_s = n_req * 64 / res.decode_s
    max_len = prompt_len + 64
    rows = moe_expert_rows(torch, model, batch, max_len)
    n_moe = sum(s.moe for s in cfg.block_pattern) * (
        cfg.n_layers // len(cfg.block_pattern))
    nk = n_req * prompt_len * cfg.top_k
    if rows != [[nk, 3 * nk]] * n_moe:
        fail(f"phase 14b {arch}: the expert products' rows per MoE layer "
             f"[routed n*k, seen by gate + up + down] were {rows}; "
             f"expected [{nk}, {3 * nk}] in each of {n_moe} layers")
    kernels = [k for k, n in (("flash_attention", want_fa),
                              ("ssd_scan", want_ssd)) if n]
    check = logits_vs_plain(torch, model, batch, max_len, kernels)
    failed = plain_check_failure(check)
    print(f"phase 14b {arch} bf16 ({cfg.n_layers} of {full} layers, cut to "
          f"fit one card; {weights / 2 ** 30:.2f} GiB of weights) served "
          f"{n_req} x {prompt_len} prompt + 64 greedy steps; expert "
          f"products over the n*k = {nk} routed rows in each of {n_moe} MoE "
          f"layers; prefill "
          f"{res.prefill_s * 1e3:.1f} ms, decode {res.decode_s * 1e3:.1f} ms "
          f"({tok_s:.1f} tokens/s); launches flash {json.dumps(by_entry)}, "
          f"ssd_scan_tc {ssd_tc}; peak memory {peak:.2f} GiB; device fill "
          f"{fill_s:.1f} s; first tokens {res.tokens[0, :8].tolist()}; "
          f"{plain_check_text(check)}")
    if failed:
        fail(f"phase 14b {arch} bf16: {failed}")
    out = dict(layers=cfg.n_layers, of_layers=full, requests=n_req,
               prompt_len=prompt_len, weights_gib=weights / 2 ** 30,
               launches=by_entry, ssd_scan_tc_launches=ssd_tc,
               expert_rows_per_moe_layer=nk, moe_layers=n_moe,
               counts=counts, prefill_ms=res.prefill_s * 1e3,
               decode_ms=res.decode_s * 1e3, decode_tok_s=tok_s,
               peak_gib=peak, fill_s=fill_s, vs_plain=check)
    if arch == "mixtral-8x7b":
        dev_ms, groups, top = moe_device_breakdown(torch, model, batch,
                                                   max_len)
        print(f"phase 14b {arch} prefill device time (torch.profiler): "
              f"{dev_ms:.2f} ms, {100 * dev_ms / (res.prefill_s * 1e3):.1f} %"
              f" of its wall; by kind: "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items()))
        for name, ms, calls in top:
            print(f"  prefill: {ms:9.3f} ms {calls:6d} calls  {name[:90]}")
        out.update(prefill_device_ms=dev_ms, prefill_by_kind=groups,
                   prefill_top=top)
    del model
    torch.cuda.empty_cache()
    return out


# --serve-against: the trees' order in turns (0 this checkout, 1 the
# other) and the serves a turn
SERVE_TURNS = (1, 0, 0, 1, 1, 0)
SERVE_REPS = 5


def serve_turn(torch, archs) -> dict:
    """One turn of ``--serve-against``, in a process of its own whose
    ``repro_torch`` is one tree's: each MoE id of ``archs`` at phase 14b's
    shape (``MOE_SERVE``, ``moe_config``, ``device_fill`` weights from
    seed 0), a warm-up, then ``SERVE_REPS`` serves of the prompt and 64
    greedy steps (prefill ms, decode tokens/s, peak GiB, the first
    tokens), the prefill's device time by kind
    (``moe_device_breakdown``), the expert rows per MoE layer
    (``moe_expert_rows``) and ``moe_decode_profile``."""
    from repro_torch.launch.serve import random_batch, serve
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import device_fill
    out = {}
    for arch in archs:
        layers, n_req, prompt_len = MOE_SERVE[arch][:3]
        cfg = moe_config(arch, layers)
        torch.cuda.empty_cache()
        model = device_fill(T.Transformer(cfg, "cuda"), 0)
        batch = random_batch(cfg, n_req, prompt_len, 0, "cuda")
        serve(model, batch, 2)
        runs = []
        for _ in range(SERVE_REPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = serve(model, batch, 64)
            runs.append(dict(
                prefill_ms=res.prefill_s * 1e3,
                decode_tok_s=n_req * 64 / res.decode_s,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                first_tokens=res.tokens[0, :8].tolist()))
        max_len = prompt_len + 64
        dev_ms, groups, _ = moe_device_breakdown(torch, model, batch,
                                                 max_len)
        rows = moe_expert_rows(torch, model, batch, max_len)
        out[arch] = dict(runs=runs, prefill_device_ms=dev_ms,
                         prefill_by_kind=groups,
                         expert_rows_per_moe_layer=rows[0][1] / 3,
                         routed_rows=rows[0][0],
                         decode=moe_decode_profile(torch, model, batch,
                                                   max_len))
        del model
    return out


def serve_against(other, archs) -> dict:
    """``chip_smoke.py --serve-against OTHER [ARCH ...]``: phase 14b's MoE
    serves (all three ids unless named) with this checkout's
    ``repro_torch`` and with the checkout OTHER's, in turns (other,
    this, this, other, other, this), each turn a ``serve_turn`` in a
    process of its own; both trees' model kernels are built first, at
    once.  Prints each metric turn by turn and each tree's quartiles
    (its median alone where it has fewer than 4 values)."""
    trees = (ROOT, os.path.abspath(other))
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1])"
         "; from repro_torch.kernels import _build; "
         "_build.build_all(sys.argv[2:])", os.path.join(t, "src"),
         *MODEL_SOURCES]) for t in trees]
    if any(b.wait() for b in builds):
        fail("serve-against: a tree's kernels did not build")
    import statistics
    import tempfile
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, t in enumerate(SERVE_TURNS):
            path = os.path.join(tmp, f"turn{i}.json")
            t0 = time.time()
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--serve-turn", os.path.join(trees[t], "src"),
                            path, *archs], check=True, cwd=trees[t])
            with open(path) as f:
                turns.append(dict(tree=("this", "other")[t],
                                  seconds=time.time() - t0,
                                  serves=json.load(f)))
            print(f"serve-against turn {i} ({turns[-1]['tree']}) in "
                  f"{turns[-1]['seconds']:.1f} s", flush=True)
    medians = {}
    for arch in archs:
        metrics = {
            "prefill_ms": lambda v: [r["prefill_ms"] for r in v["runs"]],
            "decode_tok_s": lambda v: [r["decode_tok_s"] for r in v["runs"]],
            "peak_gib": lambda v: [r["peak_gib"] for r in v["runs"]],
            "expert_device_ms": lambda v: [v["prefill_by_kind"][
                "expert products (moe._bmm_f32)"]],
            "prefill_device_ms": lambda v: [v["prefill_device_ms"]],
            "expert_rows_per_moe_layer": lambda v: [
                v["expert_rows_per_moe_layer"]],
            "decode_host_ms_per_step": lambda v: [
                v["decode"]["host_ms_per_step"]],
            "decode_moe_host_ms_per_step": lambda v: [
                v["decode"]["moe_host_ms_per_step"]],
            "decode_device_ms_per_step": lambda v: [
                v["decode"]["device_ms_per_step"]],
            "decode_launches_per_step": lambda v: [
                v["decode"]["launches_per_step"]]}
        medians[arch] = {}
        for key, get in metrics.items():
            cells = [(turn["tree"], get(turn["serves"][arch]))
                     for turn in turns]
            print(f"{arch} {key}: " + "; ".join(
                f"{tree} " + " / ".join(f"{v:.2f}" for v in vals)
                for tree, vals in cells))
            by_tree = {tree: [v for t, vals in cells if t == tree
                              for v in vals] for tree in ("other", "this")}
            # quartiles (statistics.quantiles) where a tree has 4 or more
            # values, else the median alone
            medians[arch][key] = {
                tree: statistics.quantiles(v, n=4) if len(v) > 3
                else statistics.median(v) for tree, v in by_tree.items()}
        for turn in turns[1:3]:
            dec = turn["serves"][arch]["decode"]
            print(f"{arch} decode step ({turn['tree']}), the most host "
                  f"self time: " + "; ".join(
                      f"{k[:40]} {ms:.3f} ms x{n}"
                      for k, ms, n in dec["top_host"]))
            print(f"{arch} decode step ({turn['tree']}), the most device "
                  f"time: " + "; ".join(
                      f"{k[:60]} {ms:.3f} ms x{n}"
                      for k, ms, n in dec["top_device"]))
        tokens = {turn["tree"]: turn["serves"][arch]["runs"][0][
            "first_tokens"] for turn in turns}
        medians[arch]["first_tokens_equal"] = tokens["this"] == tokens[
            "other"]
        print(f"{arch} quartiles, or medians under 4 values (other -> "
              f"this): " + json.dumps(medians[arch]))
    return dict(other=trees[1], turns=turns, medians=medians)


def past_abs_or_ulp(torch, got, want, lim) -> int:
    """Elements of ``got`` off ``want`` by more than ``lim`` or one bf16 ulp
    of max(|got|, |want|), whichever is larger."""
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -120)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return int(((g - w).abs() > torch.clamp(ulp, min=lim)).sum())


def moe_ssd_kernel(torch, np, b, s, h, p, n, q):
    """``ssd_scan_tc`` in bf16 at jamba's shape against the plain version
    and the f64 evaluation rounded to bf16 (``ssd_tc_probe.exact_y``),
    timed beside the plain version, with its bound.  y is held to phase
    6's absolute 1e-1, or one bf16 ulp of the output where that is larger
    (|y| >= 16, which this shape's 256 heads reach: there two roundings
    of one f32 value to bf16 differ by 0.125); the f32 final state to
    1e-1."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ssd_tc_probe as probe
    from repro_torch.kernels.ref import ssd_scan_ref
    rng = np.random.default_rng(s + h)
    args = ssd_inputs(torch, rng, b, s, h, p, n, torch.bfloat16)
    n0 = ss.launches_tc
    y, fin = ss.ssd_scan(*args, chunk=q)
    wy, wfin = ssd_scan_ref(*args, chunk=q)
    exact = probe.exact_y(torch, *args, q).bfloat16()
    torch.cuda.synchronize()
    if ss.launches_tc - n0 != 1:
        fail("phase 14c ssd_scan_tc not launched at jamba's shape")
    if not bool(torch.isfinite(y.float()).all()):
        fail("phase 14c ssd_scan_tc y, jamba: non-finite output")
    lim = TOL["bfloat16"][1]
    d = (y.float() - wy.float()).abs()
    err = float(d.max())
    past = d > lim
    state_err = max_err(fin, wfin, "phase 14c ssd_scan_tc state, jamba", lim)
    over = dict(plain=past_abs_or_ulp(torch, y, wy, lim),
                exact=past_abs_or_ulp(torch, y, exact, lim),
                plain_vs_exact=past_abs_or_ulp(torch, wy, exact, lim))
    least_y = (float(torch.maximum(y.float().abs(), wy.float().abs())[past]
                     .min()) if bool(past.any()) else None)
    if over["plain"] or over["exact"]:
        fail(f"phase 14c ssd_scan_tc y, jamba: outputs past {lim} and one "
             f"bf16 ulp, of the plain version / the f64 value: {over}")
    ms = cuda_ms(lambda: ss.ssd_scan(*args, chunk=q), 20)
    plain = cuda_ms(lambda: ssd_scan_ref(*args, chunk=q), 3)
    nc, tri = s // q, q * (q + 1) / 2
    flops = 2.0 * (b * nc * tri * n + b * h * nc * (tri * p + 2 * q * n * p))
    nbytes = (2 * 2.0 * b * s * h * p + 4.0 * b * s * h + 4.0 * h
              + 2 * 2.0 * b * s * n + 4.0 * b * h * p * n)
    bound_ms, bound_by = bound(flops, nbytes)
    shape = f"x ({b}, {s}, {h}, {p}), N={n}, chunk {q}, bf16"
    print(f"phase 14c ssd_scan_tc (ssd_scan_tc_launch) jamba-1.5-large-398b: "
          f"{shape}: max abs error {err:.3g}; {int(past.sum())} outputs past "
          f"{lim}, the least of them at |y| {least_y}; past {lim} and one "
          f"bf16 ulp: {json.dumps(over)}; |y| up to "
          f"{float(wy.float().abs().max()):.1f}; state {state_err:.3g} "
          f"(limit {lim}); kernel {ms:.4f} ms, plain {plain:.4f} ms; bound "
          f"{bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB); {ms / bound_ms:.2f}x the bound")
    return dict(entry="ssd_scan_tc_launch", max_abs_err=err,
                past_abs_limit=int(past.sum()), least_y_past=least_y,
                abs_limit=lim, over_abs_and_ulp=over, state_err=state_err,
                ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, shape=shape)


def phase_moe(torch, np, trees):
    """Phase 14: the MoE family: (a) mixtral-8x7b and phi3.5-moe-42b in f32
    against serve_ref_moe.json (their weights from ``trees``, a
    :class:`DatumTrees`), (b) the three MoE ids served in bf16 at full
    width, cut in depth, (c) the kernels at each new shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    out = {"datum": {}, "serve": {}, "kernel": {}}
    for arch, d in trees.moe_ref["configs"].items():
        out["datum"][arch] = family_datum(
            torch, arch, d, trees, phase="14a", launches=MOE_DATUM_LAUNCHES,
            plant=False, datum="serve_ref_moe.json")
        torch.cuda.empty_cache()
    for arch, shape in MOE_SERVE.items():
        out["serve"][arch] = moe_serve(torch, arch, *shape)
    for row, *shape in MOE_FLASH_SHAPES:
        out["kernel"][row] = family_kernel(torch, np, row, *shape,
                                           phase="14c")
    out["kernel"]["jamba-1.5-large-398b ssd"] = moe_ssd_kernel(
        torch, np, *MOE_SSD_SHAPE)
    out["phase_s"] = time.time() - t0
    print(f"phase 14 done in {out['phase_s']:.1f} s")
    return out


def kernel_counts():
    """Every kernel wrapper's launch count."""
    from repro_torch.kernels import cell_scan as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import tat_lookup as tl
    return dict(tat_lookup=tl.launches, cell_scan=cs.launches,
                flash_attention=fa.launches, ssd_scan=ss.launches)


def zero_kernel_counts() -> None:
    from repro_torch.kernels import cell_scan as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import tat_lookup as tl
    tl.launches = cs.launches = 0
    cs.launches_by = {}
    fa.launches = fa.launches_tc = fa.launches_fma = 0
    fa.launches_by = {}
    ss.launches = ss.launches_tc = ss.launches_fma = 0


def state_equal(torch, model_a, opt_a, model_b, opt_b) -> int:
    """Fail unless two train states are equal bit for bit; returns the
    number of tensors compared."""
    n = 0
    for (name, a), (name_b, b) in zip(model_a.named_parameters(),
                                      model_b.named_parameters()):
        if name != name_b or a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"restored parameter {name} differs from the live one")
        n += 1
    if set(opt_a) != set(opt_b) or not torch.equal(opt_a["step"],
                                                   opt_b["step"]):
        fail(f"restored optimizer step {opt_b.get('step')} differs")
    for k in ("m", "v"):
        for name, a in opt_a[k].items():
            if not torch.equal(a, opt_b[k][name]):
                fail(f"restored optimizer {k} of {name} differs")
            n += 1
    return n + 1


def step_profile(torch, fn):
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA
    activity): (device ms in all, host ms in all, the six ops with the
    most device time and the six with the most host self time, each as
    (name, ms, calls))."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in ev if e.self_device_time_total > 0),
                 key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in ev), key=lambda r: -r[1])
    return (sum(r[1] for r in dev), sum(r[1] for r in host), dev[:6],
            host[:6])


def train_datum_steps(np, ref, step, opt, vocab, what):
    """Feed a training datum's batches (its ``tokens``; labels the ids
    shifted left, the last -1) through ``step`` from ``opt``: the worst
    relative error of loss, grad norm and lr against its ``metrics``
    (failing past its ``rtol``), and whether ``SyntheticLMDataset``
    reproduces its batches here (numpy does not promise one
    ``Generator.zipf`` stream across its versions)."""
    from repro_torch.data import SyntheticLMDataset
    data = SyntheticLMDataset(vocab, ref["seq"], ref["batch"],
                              seed=ref["seed"])
    same_batches = True
    worst = {k: 0.0 for k in ("loss", "grad_norm", "lr")}
    for i, want in enumerate(ref["metrics"]):
        tokens = np.asarray(ref["tokens"][i], np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1
        same_batches &= bool(np.array_equal(data.next_batch()["tokens"],
                                            tokens))
        opt, m = step(opt, {"tokens": tokens, "labels": labels})
        for k, w in want.items():
            got = float(m[k])
            rel = abs(got - w) / abs(w)
            worst[k] = max(worst[k], rel)
            if not np.isfinite(got) or rel > ref["rtol"]:
                fail(f"{what} f32 step {i}: {k} {got!r}, datum {w!r} "
                     f"({rel:.3g} relative, limit {ref['rtol']})")
    return worst, same_batches


def phase_train(torch, np, smi):
    """Phase 12: the training path through the PCS checkpoint tier, for
    smollm-135m at full width and depth: (a) the f32 copy's losses, grad
    norms and learning rates against train_ref.json; (b) the published
    bf16 config at the train CLI's defaults, trained, checkpointed,
    crashed, recovered and restored bit for bit in each scheme."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import train as tr
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.convert import numpy_params, params_from_reference
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.persistence import (DurableStore, HostBufferTier,
                                         PCSCheckpointManager, PersistScheme)
    with open(os.path.join(ROOT, "src", "repro_torch", "testdata",
                           "train_ref.json")) as f:
        ref = json.load(f)
    rtol = ref["rtol"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zero_kernel_counts()
    t_phase = time.time()
    out = {}

    # (a) the datum, f32
    cfg = get_config(ref["arch"])
    tree = numpy_params(cfg, ref["seed"])
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = params_from_reference(cfg32, tree, "cuda")
    opt_cfg = AdamWConfig(**ref["opt"])
    opt = adamw_init(opt_cfg, dict(model.named_parameters()))
    step = make_train_step(model, opt_cfg)
    worst, same_batches = train_datum_steps(np, ref, step, opt, cfg.vocab,
                                            "phase 12a train_ref.json")
    print(f"phase 12a {ref['arch']} f32 ({cfg.n_layers} layers, "
          f"{ref['batch']} x {ref['seq']} tokens, {len(ref['metrics'])} "
          f"AdamW steps): relative error against train_ref.json: loss "
          f"{worst['loss']:.3g}, grad_norm {worst['grad_norm']:.3g}, lr "
          f"{worst['lr']:.3g} (limit {rtol}); losses "
          f"{[round(float(x['loss']), 6) for x in ref['metrics']]}; the "
          f"datum's batches {'equal' if same_batches else 'differ from'} "
          f"SyntheticLMDataset's here (numpy {np.__version__}, datum's "
          f"{ref['numpy_version']}); {smi}")
    out["f32_datum_rel_err"] = worst
    out["f32_datum_batches_equal_dataset"] = same_batches
    del model, opt, step
    torch.cuda.empty_cache()

    # (b) the published bf16 config at the train CLI's defaults
    batch, seq, steps, every = 8, 128, 6, 3
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=steps)
    other = numpy_params(cfg, 1)
    out["schemes"] = {}
    for scheme in ("nopb", "pb", "pb_rf"):
        torch.cuda.reset_peak_memory_stats()
        model = params_from_reference(cfg, tree, "cuda")
        opt = adamw_init(opt_cfg, dict(model.named_parameters()))
        ckpt_bytes = sum(t.numel() * t.element_size() for t in
                         list(model.parameters()) + list(opt["m"].values())
                         + list(opt["v"].values()) + [opt["step"]])
        step = make_train_step(model, opt_cfg)
        data = SyntheticLMDataset(cfg.vocab, seq, batch)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        mgrs = []

        def manager():
            mgrs.append(PCSCheckpointManager(
                HostBufferTier(capacity_bytes=ckpt_bytes + (1 << 20)),
                DurableStore(tmp, write_delay_s=1e-3),
                scheme=PersistScheme(scheme)))
            return mgrs[-1]
        try:
            mgr = manager()
            run = tr.train(model, opt, data, step, mgr, start=0, steps=steps,
                           ckpt_every=every, log=lambda _: None)
            opt = run["opt_state"]
            restores = []
            for when in ("after persist", "after crash"):
                if when == "after crash":
                    mgr.crash()
                    redrained = mgr.recover()
                    mgr = manager()
                target = params_from_reference(cfg, other, "cuda")
                before = dict(mgr.stats)
                torch.cuda.synchronize()
                t0 = time.time()
                rec = tr.restore_state(mgr, target, adamw_init(
                    opt_cfg, dict(target.named_parameters())))
                torch.cuda.synchronize()
                dt = time.time() - t0
                if rec is None or rec[0] != steps:
                    fail(f"train {scheme}: restored version "
                         f"{rec and rec[0]}, expected {steps}")
                n = state_equal(torch, model, opt, rec[1], rec[2])
                restores.append(dict(
                    when=when, s=dt, tensors=n,
                    from_buffer=mgr.stats["restore_forwarded"]
                    - before["restore_forwarded"],
                    from_store=mgr.stats["restore_from_store"]
                    - before["restore_from_store"]))
                del target, rec
            if scheme == "pb_rf" and restores[0]["from_buffer"] == 0:
                fail("train pb_rf: no restore right after the persist was "
                     "served by the buffer")
            stats = dict(mgrs[0].stats)
        finally:
            for mg in mgrs:
                mg.close()
            shutil.rmtree(tmp, ignore_errors=True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [x["loss"] for x in run["metrics"]]
        if not all(np.isfinite(losses)):
            fail(f"train {scheme}: losses {losses}")
        out["schemes"][scheme] = dict(
            losses=losses, step_s=run["step_s"], persist_s=run["persist_s"],
            restores=restores, redrained_at_recovery=redrained,
            stats=stats, checkpoint_bytes=ckpt_bytes, peak_gib=peak)
        print(f"phase 12b {scheme}: smollm-135m bf16, {batch} x {seq} "
              f"tokens, {steps} steps, a checkpoint every {every} "
              f"({ckpt_bytes / 1e9:.3f} GB of state each, buffer of one); "
              f"persist s per checkpoint "
              f"{[round(x, 3) for x in run['persist_s']]}; restores "
              + "; ".join(f"{r['when']}: {r['s']:.3f} s, {r['from_buffer']} "
                          f"from the buffer, {r['from_store']} from the "
                          f"store" for r in restores)
              + f"; state equal bit for bit at version {steps} "
              f"({restores[-1]['tensors']} tensors); {redrained} re-drained "
              f"at recovery; stats {json.dumps(stats)}; peak "
              f"{peak:.2f} GiB; {smi}")
        if scheme != "pb_rf":
            del model, opt, step
            torch.cuda.empty_cache()

    # step time, warmed up, on the last scheme's model
    b = data.next_batch()
    for _ in range(2):
        opt, _ = step(opt, b)
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 5
    start.record()
    for _ in range(reps):
        opt, _ = step(opt, b)
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / reps
    out["step_ms"] = step_ms
    out["tokens_per_s"] = batch * seq / (step_ms / 1e3)
    holder = [opt]

    def one_step():
        holder[0], _ = step(holder[0], b)
    dev_ms, host_ms, top_dev, top_host = step_profile(torch, one_step)
    opt = holder[0]
    out["profile"] = dict(device_ms=dev_ms, host_self_ms=host_ms,
                          top_device=top_dev, top_host=top_host)
    print(f"phase 12b one bf16 train step under torch.profiler: device "
          f"{dev_ms:.2f} ms, host self time {host_ms:.2f} ms; {smi}")
    for what, top in (("device", top_dev), ("host", top_host)):
        for name, ms, calls in top:
            print(f"  train step, {what}: {ms:9.3f} ms {calls:6d} calls  "
                  f"{name[:90]}")
    out["kernel_launches"] = kernel_counts()
    if any(out["kernel_launches"].values()):
        fail(f"the training path launched kernels: "
             f"{out['kernel_launches']}")
    out["phase_s"] = time.time() - t_phase
    print(f"phase 12b smollm-135m bf16 train step (CUDA events, warmed up, "
          f"{reps} steps): {step_ms:.2f} ms, {out['tokens_per_s']:.0f} "
          f"tokens/s; kernel launches in the phase "
          f"{json.dumps(out['kernel_launches'])} (training runs no "
          f"hand-written kernel, as the reference's runs no Pallas one); "
          f"phase {out['phase_s']:.1f} s; {smi}")
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def phase_train_ssd(torch, np, smi):
    """Phase 12c: training through SSD layers (``models.ssm.ssd_chunked``),
    mamba2-1.3b at full width: the f32 copy cut to the datum's depth
    against train_ref_ssd.json, then the published bf16 config at full
    width and depth at the train CLI's defaults, timed; no kernel
    launches in the phase."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import (device_fill, numpy_params,
                                            params_from_reference)
    from repro_torch.optim import AdamWConfig, adamw_init
    with open(os.path.join(ROOT, "src", "repro_torch", "testdata",
                           "train_ref_ssd.json")) as f:
        ref = json.load(f)
    rtol = ref["rtol"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zero_kernel_counts()
    t_phase = time.time()
    out = {}

    # the datum, f32, cut in depth
    cfg = get_config(ref["arch"])
    cfg32 = dataclasses.replace(cfg, n_layers=ref["layers"],
                                dtype=torch.float32)
    model = params_from_reference(cfg32, numpy_params(cfg32, ref["seed"]),
                                  "cuda")
    opt_cfg = AdamWConfig(**ref["opt"])
    opt = adamw_init(opt_cfg, dict(model.named_parameters()))
    step = make_train_step(model, opt_cfg)
    worst, same_batches = train_datum_steps(np, ref, step, opt, cfg.vocab,
                                            "phase 12c train_ref_ssd.json")
    print(f"phase 12c {ref['arch']} f32 ({ref['layers']} of {cfg.n_layers} "
          f"layers, {ref['batch']} x {ref['seq']} tokens, "
          f"{len(ref['metrics'])} AdamW steps through ssd_chunked): relative "
          f"error against train_ref_ssd.json: loss {worst['loss']:.3g}, "
          f"grad_norm {worst['grad_norm']:.3g}, lr {worst['lr']:.3g} (limit "
          f"{rtol}); the datum's batches "
          f"{'equal' if same_batches else 'differ from'} SyntheticLMDataset's"
          f" here; {smi}")
    out["f32_datum_rel_err"] = worst
    out["f32_datum_batches_equal_dataset"] = same_batches
    del model, opt, step
    torch.cuda.empty_cache()

    # the published bf16 config at the train CLI's defaults (8 x 128
    # tokens, lr 3e-4), weights drawn on the card
    batch, seq, warm, reps = 8, 128, 2, 3
    torch.cuda.reset_peak_memory_stats()
    model = device_fill(T.Transformer(cfg, "cuda"), 0)
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=50)
    opt = adamw_init(opt_cfg, dict(model.named_parameters()))
    step = make_train_step(model, opt_cfg)
    data = SyntheticLMDataset(cfg.vocab, seq, batch)
    losses = []
    for _ in range(warm):
        opt, m = step(opt, data.next_batch())
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    ms = []
    for _ in range(reps):
        opt, m = step(opt, data.next_batch())
        ms.append(m)
    stop.record()
    torch.cuda.synchronize()
    losses += [float(m["loss"]) for m in ms]
    step_ms = start.elapsed_time(stop) / reps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(losses)):
        fail(f"phase 12c mamba2-1.3b bf16 losses {losses}")
    out["kernel_launches"] = kernel_counts()
    if any(out["kernel_launches"].values()):
        fail(f"phase 12c: the training path launched kernels: "
             f"{out['kernel_launches']}")
    out.update(step_ms=step_ms, tokens_per_s=batch * seq / (step_ms / 1e3),
               losses=losses, peak_gib=peak,
               phase_s=time.time() - t_phase)
    print(f"phase 12c mamba2-1.3b bf16 train step at full width and depth "
          f"({cfg.n_layers} layers, {batch} x {seq} tokens, AdamW, remat "
          f"{cfg.remat}; CUDA events over {reps} steps after {warm}): "
          f"{step_ms:.2f} ms, {out['tokens_per_s']:.0f} tokens/s; losses "
          f"{[round(x, 4) for x in losses]}; peak memory {peak:.2f} GiB; "
          f"kernel launches in the phase "
          f"{json.dumps(out['kernel_launches'])}; phase "
          f"{out['phase_s']:.1f} s; {smi}")
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def moe_grad_datum(torch, np, device):
    """``src/repro_torch/testdata/moe_grad_bf16_ref.json`` on ``device``:
    the port's ``moe_ffn`` at training's settings in bf16, the datum's
    loss ``sum(y.f32 * c) + 0.01 * aux`` and its gradients, each leaf's
    ``||port - ref|| / ||ref||`` and dtype; fails past the datum's
    ``rel_limit`` or on a dtype other than the reference's."""
    from repro_torch.models.moe import moe_ffn
    with open(os.path.join(ROOT, "src", "repro_torch", "testdata",
                           "moe_grad_bf16_ref.json")) as f:
        ref = json.load(f)
    b, s, d, f_, e = (ref[k] for k in ("batch", "seq", "d_model", "d_ff",
                                       "n_experts"))
    shapes = {"x": (b, s, d), "router": (d, e), "gate": (e, d, f_),
              "up": (e, d, f_), "down": (e, f_, d), "c": (b, s, d)}

    def leaf(vals, name):
        a = np.asarray(vals)
        t = (torch.from_numpy(a.astype(np.float32)) if name in ("router", "c")
             else torch.from_numpy(a.astype(np.uint16).view(np.int16))
             .view(torch.bfloat16))
        return t.reshape(shapes[name]).to(device)
    ins = {k: leaf(v, k).requires_grad_(k != "c")
           for k, v in ref["inputs"].items()}
    p = {"router": {"w": ins["router"]}, "gate": ins["gate"],
         "up": ins["up"], "down": ins["down"]}
    y, aux = moe_ffn(p, ins["x"], top_k=ref["top_k"],
                     capacity_factor=ref["capacity_factor"], drop=True,
                     groups=1)
    loss = torch.sum(y.float() * ins["c"]) + 0.01 * aux
    loss.backward()
    out = {"loss_rel": abs(float(loss.detach()) - ref["loss"]) / abs(ref["loss"]),
           "rel": {}, "dtypes": {}, "limit": ref["rel_limit"]}
    for k, want in ref["grads"].items():
        g = ins[k].grad
        out["dtypes"][k] = str(g.dtype).replace("torch.", "")
        w = leaf(want, k).double()
        out["rel"][k] = float(torch.linalg.vector_norm(g.double() - w)
                              / torch.linalg.vector_norm(w))
    bad = {k: v for k, v in out["rel"].items() if not v <= out["limit"]}
    if out["loss_rel"] > out["limit"] or bad or out["dtypes"] != ref["dtypes"]:
        fail(f"bf16 MoE gradients against moe_grad_bf16_ref.json: loss "
             f"{out['loss_rel']:.3g}, leaves over {out['limit']}: {bad}, "
             f"dtypes {out['dtypes']} (the reference's {ref['dtypes']})")
    return out


# phase 12d: mixtral-8x7b at full width, cut in depth, trained in bf16 at
# the train CLI's batch and length
TRAIN_MOE = ("mixtral-8x7b", 2, 8, 128, 2)   # arch, layers, batch, seq, steps


def phase_train_moe(torch, np, smi):
    """Phase 12d: bf16 training through MoE layers (``moe._BmmF32``'s
    gradient): the port's bf16 gradients against moe_grad_bf16_ref.json,
    then mixtral-8x7b at full width, cut in depth, trained a few steps in
    bf16 (weights drawn on the card), each step timed; no kernel launches
    in the phase."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import device_fill
    from repro_torch.optim import AdamWConfig, adamw_init
    zero_kernel_counts()
    t_phase = time.time()
    out = {"datum": moe_grad_datum(torch, np, "cuda")}
    dat = out["datum"]
    print(f"phase 12d bf16 MoE gradients against moe_grad_bf16_ref.json "
          f"(||port - ref|| / ||ref||, limit {dat['limit']}): loss "
          f"{dat['loss_rel']:.3g}, "
          + ", ".join(f"{k} {v:.3g}" for k, v in dat["rel"].items())
          + f"; dtypes {dat['dtypes']}; {smi}")

    arch, layers, batch, seq, steps = TRAIN_MOE
    torch.cuda.reset_peak_memory_stats()
    cfg = moe_config(arch, layers)
    model = device_fill(T.Transformer(cfg, "cuda"), 0)
    n_params = sum(p.numel() for p in model.parameters())
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=50)
    opt = adamw_init(opt_cfg, dict(model.named_parameters()))
    step = make_train_step(model, opt_cfg)
    data = SyntheticLMDataset(cfg.vocab, seq, batch)
    losses, step_ms = [], []
    for _ in range(steps):
        b = data.next_batch()
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        opt, m = step(opt, b)
        stop.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(losses)):
        fail(f"phase 12d {arch} bf16 losses {losses}")
    out["kernel_launches"] = kernel_counts()
    if any(out["kernel_launches"].values()):
        fail(f"phase 12d: the training path launched kernels: "
             f"{out['kernel_launches']}")
    out.update(arch=arch, layers=layers, params=n_params, step_ms=step_ms,
               tokens_per_s=[batch * seq / (t / 1e3) for t in step_ms],
               losses=losses, peak_gib=peak, phase_s=time.time() - t_phase)
    print(f"phase 12d {arch} bf16 train steps at full width, {layers} of "
          f"{get_config(arch).n_layers} layers ({n_params / 1e9:.3f} B "
          f"parameters, {batch} x {seq} tokens, AdamW f32 moments, remat "
          f"{cfg.remat}; CUDA events, each step): "
          f"{[round(t, 2) for t in step_ms]} ms, "
          f"{[round(t) for t in out['tokens_per_s']]} tokens/s; losses "
          f"{[round(x, 4) for x in losses]}; peak memory {peak:.2f} GiB; "
          f"kernel launches in the phase "
          f"{json.dumps(out['kernel_launches'])}; phase "
          f"{out['phase_s']:.1f} s; {smi}")
    del model, opt, step
    torch.cuda.empty_cache()
    return out


# ---- phase 15: the launch layer ---------------------------------------------
DRYRUN_SUMMARY = "dry-run: 70 ok, 10 skipped, 0 FAILED"
DRYRUN_LIMIT_S = 120.0     # the whole run's aim, reported (a host-CPU time)


def dryrun_arithmetic(torch, rows):
    """Each ok row's parameter and optimizer bytes per device from the
    specs alone (a leaf's bytes over the product of the mesh axes its
    spec splits it by; the default FLAGS), by (arch, shape, mesh)."""
    import types
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.models import transformer as T
    meshes = {"single": (("data", "model"), (16, 16)),
              "multi": (("pod", "data", "model"), (2, 16, 16))}
    params, out = {}, {}
    for r in rows:
        if r["status"] != "ok":
            continue
        if r["arch"] not in params:
            params[r["arch"]] = dict(T.Transformer(
                get_config(r["arch"]), device="meta").named_parameters())
        names, sizes = meshes[r["mesh"]]
        mesh = types.SimpleNamespace(mesh_dim_names=names, shape=sizes)
        pb = ob = 0
        moment = getattr(torch, r["moment_dtype"]).itemsize
        for name, t in params[r["arch"]].items():
            split = 1
            for e in sh.param_spec(mesh, name, t):
                if e is not None:
                    split *= sh._axis_size(mesh, e)
            pb += t.numel() * t.element_size() // split
            ob += 2 * t.numel() * moment // split
        train = r["shape"] == "train_4k"
        out[r["arch"], r["shape"], r["mesh"]] = (pb, ob + 4 if train else 0)
    return out


def phase_dryrun(torch):
    """Phase 15a: ``python -m repro_torch.launch.dryrun --arch all --shape
    all --mesh both`` in a subprocess that sees no CUDA device (its fake
    process group stays out of this process): its summary, exit code and
    seconds, each row's parameter and optimizer bytes per device against
    :func:`dryrun_arithmetic`, and the five largest per-device residents."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dryrun.json")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "all", "--shape", "all", "--mesh", "both", "--out", path],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
        secs = time.time() - t0
        lines = proc.stdout.splitlines()
        if proc.returncode != 0 or not lines or lines[-1] != DRYRUN_SUMMARY:
            fail(f"phase 15a dry-run exit {proc.returncode}, last lines "
                 f"{lines[-3:]}; stderr {proc.stderr[-2000:]}")
        with open(path) as f:
            rows = json.load(f)
    want = dryrun_arithmetic(torch, rows)
    for r in rows:
        if r["status"] != "ok":
            continue
        got = (r["param_bytes_per_device"], r["opt_bytes_per_device"])
        if got != want[r["arch"], r["shape"], r["mesh"]]:
            fail(f"phase 15a {r['arch']} x {r['shape']} x {r['mesh']}: "
                 f"parameter and optimizer bytes per device {got}, the "
                 f"specs' arithmetic {want[r['arch'], r['shape'], r['mesh']]}")
    keys = ("param", "opt", "batch", "cache")
    res = {(r["arch"], r["shape"], r["mesh"]):
           sum(r[f"{k}_bytes_per_device"] for k in keys)
           for r in rows if r["status"] == "ok"}
    top = sorted(res.items(), key=lambda kv: -kv[1])[:5]
    print(f"phase 15a dry-run of every (arch x shape x mesh) cell on the meta "
          f"device over the fake 256- and 512-rank groups: {lines[-1]}, in "
          f"{secs:.1f} s ({'within' if secs <= DRYRUN_LIMIT_S else 'PAST'} "
          f"the {DRYRUN_LIMIT_S} s aim; {os.cpu_count()} host cores); "
          f"parameter and optimizer bytes per device equal to the "
          f"specs' arithmetic on all {len(res)} ok rows; the five largest "
          f"per-device residents (parameters + optimizer + batch + caches):"
          + "".join(f"\n  {a} x {s} x {m}: {b / 2 ** 30:.3f} GiB"
                    for (a, s, m), b in top))
    return {"seconds": secs, "within_aim": secs <= DRYRUN_LIMIT_S,
            "summary": lines[-1], "rows": len(rows),
            "ok_rows": len(res),
            "largest_resident_gib": [[*k, b / 2 ** 30] for k, b in top],
            "meta_pass_s_sum": sum(r.get("meta_pass_s", 0.0) for r in rows)}


def phase_launch_host(torch, np, smi, served_tokens):
    """Phase 15b: the launch layer on the card.  ``make_host_mesh()`` is a
    1 x 1 CUDA mesh (NCCL, world size 1) on which ``shard_tree`` places
    smollm-135m's full-width parameters and AdamW state whole; the group
    is destroyed on leaving it.  Then smollm-135m (phase 7b's weights and
    batch) served through ``make_prefill_step`` / ``make_decode_step``:
    every step's logits bit for bit those of ``transformer.prefill`` /
    ``decode_step`` called directly, the tokens phase 7b's ``serve``
    returned, 30 tensor-core ``flash_attention`` launches at prefill."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import random_batch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import numpy_params, params_from_reference
    from repro_torch.optim import AdamWConfig, adamw_init
    with open(os.path.join(ROOT, "src", "repro_torch", "testdata",
                           "serve_ref.json")) as f:
        seed = json.load(f)["configs"]["smollm-135m"]["seed"]
    cfg = get_config("smollm-135m")
    model = params_from_reference(cfg, numpy_params(cfg, seed), "cuda")
    params = dict(model.named_parameters())
    opt = adamw_init(AdamWConfig(), params)
    out = {}
    with make_host_mesh() as mesh:
        if (mesh.device_type, tuple(mesh.shape), dist.get_backend(),
                dist.get_world_size()) != ("cuda", (1, 1), "nccl", 1):
            fail(f"phase 15b host mesh {mesh} on {dist.get_backend()}")
        n = 0
        for what, tree in (("parameter", params), ("AdamW state", opt)):
            src = sh.leaves(tree)
            for name, dt in sh.leaves(sh.shard_tree(mesh, tree)).items():
                loc = dt.to_local()
                if loc.shape != src[name].shape or loc.device.type != \
                        "cuda" or not torch.equal(loc, src[name]):
                    fail(f"phase 15b {what} {name}: local {tuple(loc.shape)}"
                         f" on {loc.device}, global "
                         f"{tuple(src[name].shape)}")
                n += 1
        out["leaves_placed"] = n
        out["mesh"] = str(mesh)
    if dist.is_initialized():
        fail("phase 15b: the host mesh left its process group behind")
    del opt

    batch = random_batch(cfg, 4, 1024, 0, "cuda")
    gen, s = 64, 1024

    def run(prefill, decode):
        logits_all, toks = [], []
        with torch.inference_mode():
            logits, caches = prefill(batch)
            launches = (fa.launches_tc, fa.launches_fma)
            tok = logits.argmax(dim=-1)[:, None]
            for i in range(gen):
                logits_all.append(logits)
                toks.append(tok[:, 0])
                logits, caches = decode(tok, caches, s + i)
                tok = logits.argmax(dim=-1)[:, None]
        torch.cuda.synchronize()
        return logits_all, torch.stack(toks, dim=1).cpu().numpy(), launches

    fa.launches_tc = fa.launches_fma = 0
    got, tokens, launches = run(
        make_prefill_step(model, s + gen), make_decode_step(model))
    if launches != (cfg.n_layers, 0) or cfg.n_layers != 30:
        fail(f"phase 15b prefill step launched tensor-core / FMA "
             f"flash_attention "
             f"{launches}, expected (30, 0)")
    want, want_tokens, _ = run(
        lambda b: T.prefill(model, b, s + gen),
        lambda t, c, p: T.decode_step(model, t, c, pos0=p))
    differ = [i for i, (a, b) in enumerate(zip(got, want))
              if not torch.equal(a, b)]
    if differ or not np.array_equal(tokens, want_tokens):
        fail(f"phase 15b steps' logits differ from prefill / decode_step "
             f"at steps {differ[:8]}")
    if served_tokens is not None and not np.array_equal(
            tokens, np.asarray(served_tokens)):
        fail("phase 15b steps' tokens differ from phase 7b's serve")
    out.update(launches_tc=launches[0], steps=len(got),
               logits_equal_direct=True,
               tokens_equal_phase_7b=served_tokens is not None)
    print(f"phase 15b make_host_mesh(): {out['mesh']} on NCCL, world size 1,"
          f" its group destroyed on exit; shard_tree placed {n} smollm-135m "
          f"parameter and AdamW-state leaves whole; make_prefill_step / "
          f"make_decode_step served 4 x {s} + {gen} greedy steps: "
          f"{launches[0]} tensor-core flash_attention launches at "
          f"prefill, all "
          f"{len(got)} steps' logits bit for bit those of prefill / "
          f"decode_step, tokens "
          f"{'equal to phase 7b serve' if served_tokens is not None else '(phase 7b not run)'}"
          f"; {smi}")
    del model
    torch.cuda.empty_cache()
    return out


# ---- phase 16: the static analysis ------------------------------------------
ANALYSIS_LIMIT_S = 30.0    # phase 16's aim, reported (a host-CPU time)


def phase_analysis(torch):
    """Phase 16: the port's analysis CLI in-process (a) and its exemplar
    cell through the cell-scan kernel under every scheme (b)."""
    import tempfile
    from repro_torch.analysis import __main__ as analysis_cli
    from repro_torch.analysis import _engine
    from repro_torch.kernels import cell_scan as cs
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "analysis.json")
        rc = analysis_cli.main(["--fail-on-findings", "--json", path])
        with open(path) as fh:
            summary = json.load(fh)
    if rc != 0 or summary["total_findings"]:
        fail(f"phase 16a analysis exit {rc}, "
             f"{summary['total_findings']} finding(s): "
             f"{summary['findings'][:5]}")
    cli_s = time.time() - t0
    print(f"phase 16a python -m repro_torch.analysis --fail-on-findings: "
          f"{len(summary['passes'])} passes clean "
          f"({', '.join(sorted(summary['passes']))}) in {cli_s:.1f} s")

    (ops, addrs, gaps, lengths, mlen), statics, sc = _engine.example_inputs()
    schemes = _engine.schemes()
    n = len(schemes)
    tables = cs.pack_configs([sc] * n, statics["n_tenants_max"], "cpu")
    args = ([ops[None], addrs[None], gaps[None], lengths[None],
             torch.zeros(n, dtype=torch.int32),
             torch.arange(n, dtype=torch.int32),
             torch.tensor(schemes, dtype=torch.int32)] + list(tables)
            + [mlen[None]])
    kw = dict(max_pbe=statics["max_pbe"], pm_banks=statics["pm_banks"],
              n_track=statics["n_track"],
              n_tenants_max=statics["n_tenants_max"],
              n_deep_max=statics["n_deep_max"],
              n_leaves_max=statics["n_leaves_max"], macro=statics["macro"])
    plain = cs.cell_scan(*args, **kw)
    before = cs.launches
    got = cs.cell_scan(*[a.cuda() for a in args], **kw)
    torch.cuda.synchronize()
    if cs.launches != before + 1:
        fail("phase 16b: the exemplar did not launch the cell-scan kernel")
    err = compare_outputs(plain, got, "phase 16b analysis exemplar")
    n_epochs = tables[4].shape[1]       # the epoch table's (K, E, ...)
    key = cs.instantiation(statics["max_pbe"], statics["n_deep_max"],
                           statics["n_leaves_max"], n_epochs,
                           statics["macro"])
    wall = time.time() - t0
    print(f"phase 16b analysis exemplar through cell_scan{list(key)} under "
          f"{n} schemes: exact on every output but lookups (runtimes "
          f"{got.runtime.tolist()}, slots {got.steps.tolist()}, macro "
          f"slots {got.macro_ops.tolist()})")
    print(f"phase 16 wall {wall:.1f} s (aim {ANALYSIS_LIMIT_S:.0f} s)")
    return dict(cli_s=cli_s, wall_s=wall, aim_s=ANALYSIS_LIMIT_S,
                passes=sorted(summary["passes"]),
                total_findings=summary["total_findings"],
                exemplar_cells=n, exemplar_instantiation=list(key),
                max_abs_err=err)


def main() -> int:
    if sys.argv[1:2] == ["--serve-turn"]:
        # SRC OUT ARCH...: this process's repro_torch is SRC's
        sys.path.insert(0, sys.argv[2])
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    # ---- phase 1: the card and the build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    if sys.argv[1:] == ["--train-only"]:
        print(json.dumps({"train": phase_train(torch, np, smi),
                          "train_ssd": phase_train_ssd(torch, np, smi),
                          "train_moe": phase_train_moe(torch, np, smi)}))
        return 0
    if sys.argv[1:] == ["--serve-only"]:
        t0 = time.time()
        _build.build_all(MODEL_SOURCES)
        print(f"phase 1 kernels built in {time.time() - t0:.1f} s "
              f"({', '.join(MODEL_SOURCES)})")
        flash = phase_flash(torch, np)
        ssd = phase_ssd(torch, np)
        served = phase_serve(torch, np)
        trees = DatumTrees(torch)
        family = phase_family(torch, np, trees)
        moe = phase_moe(torch, np, trees)
        print(json.dumps({"flash": flash, "ssd": ssd, "serve": served,
                          "family": family, "moe": moe}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:2] == ["--serve-turn"]:
        out = serve_turn(torch, sys.argv[4:])
        with open(sys.argv[3], "w") as f:
            json.dump(out, f)
        return 0
    if len(sys.argv) >= 3 and sys.argv[1] == "--serve-against":
        print(json.dumps({"serve_against": serve_against(sys.argv[2],
                                                         sys.argv[3:]
                                                         or list(MOE_SERVE))}))
        return 0
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

    walls = {"1": time.time() - t0}

    def timed(phase, fn, *args):
        t = time.time()
        res = fn(*args)
        walls[phase] = walls.get(phase, 0.0) + time.time() - t
        return res
    smem_ns = timed("1", smem_round_trip_ns, torch)
    print(f"phase 1 one dependent shared-memory load: {smem_ns:.3f} ns")
    tat = timed("2", phase_tat_lookup, torch, np)
    traces, configs = paper_grid()
    scan, full = timed("3", phase_cell_scan, torch, smem_ns, traces,
                       configs)
    main_path = timed("4", phase_main_path, torch, np, smem_ns, traces,
                      configs, full)
    scan_profile = timed("4", phase_cell_scan_profile, torch, traces,
                         configs, full)
    # phase 13's weights, drawn meanwhile: phases 8-11 time single long
    # launches and share the host with process pools anyway, while the
    # thread would slow the host-bound numbers of phases 4 and 5-7
    trees = DatumTrees(torch)
    chains = timed("8", phase_chains, torch, np, smem_ns)
    fab = timed("9", phase_fabric, torch, np, smem_ns, traces, sass_against)
    epochs = timed("10", phase_epochs, torch, np, smem_ns, traces)
    epochs["coverage"] = timed("10g", phase_coverage, torch)
    macro = timed("11", phase_macro, torch, np, smem_ns, traces, configs,
                  scan)
    flash = timed("5", phase_flash, torch, np)
    ssd = timed("6", phase_ssd, torch, np)
    served = timed("7", phase_serve, torch, np)
    family = timed("13", phase_family, torch, np, trees)
    moe = timed("14", phase_moe, torch, np, trees)
    trained = timed("12", phase_train, torch, np, smi)
    trained_ssd = timed("12c", phase_train_ssd, torch, np, smi)
    trained_moe = timed("12d", phase_train_moe, torch, np, smi)
    launch = {"dryrun": timed("15a", phase_dryrun, torch),
              "host": timed("15b", phase_launch_host, torch, np, smi,
                            served["smollm-135m"]["tokens"])}
    analysis = timed("16", phase_analysis, torch)
    launch["phase_wall_s"] = walls
    print("phase walls (s): " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in walls.items())
          + f"; in all {time.time() - t0:.1f}")

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
             plain_note="the eager scan_cell's seconds summed over the 6 "
                        "cells at depths 0 and 4 (run on the host, a pool "
                        "of processes); the kernel on the same cells: "
                        "ms_plain_cells",
             ms_plain_cells=chains["fig1"]["ms_plain_cells"],
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
                        "fig_fabric's 20 cells with 1 or 8 leaves at its "
                        "smoke size (150 pairs a core; run on the host, a "
                        "pool of processes); the kernel on the same cells: "
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
                        "summed over the 7 cells (run on the host, a "
                        "pool of processes)",
             bound_ms=macro["plain"]["bound_ms"], bound_by="bytes",
             library_ms=None,
             shape="7 workloads x PB_RF at persist_budget=2000",
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
        dict(name=fa.WS_BF16[0], route="cuda",
             source=f"src/repro_torch/kernels/csrc/{fa.WS_BF16[0]}.cu",
             replaces="src/repro/kernels/flash_attention.py:68",
             entry=fa.WS_BF16[1],
             launches=served["smollm-135m"]["counts_by_entry"].get(
                 fa.WS_BF16[1], 0),
             main_path="smollm-135m bf16 serve, 4 x 1024 prompt + 64 "
                       "decode steps: one launch per layer at prefill "
                       "(the bf16 route of flash_attention from D = 64)",
             f8_counts=flash["f8_counts"],
             f8_counts_wide=flash["f8_counts_wide"],
             ptxas=flash["ptxas_ws"],
             max_abs_err=flash["bfloat16"]["max_abs_err"],
             ms=flash["bfloat16"]["ms"],
             ms_turns=flash["bfloat16"]["ms_turns"],
             present_kernel_ms=flash["bfloat16"]["present_ms"],
             plain_ms=flash["bfloat16"]["plain_ms"],
             bound_ms=flash["bfloat16"]["bound_ms"],
             bound_by=flash["bfloat16"]["bound_by"],
             library_ms=flash["bfloat16"]["library_ms"],
             library="scaled_dot_product_attention (K/V repeated per "
                     "query head)",
             shape="q (4, 9, 1024, 64), k/v (4, 3, 1024, 64), bf16, "
                   "causal"),
        dict(name="flash_attention_tc", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
             replaces="src/repro/kernels/flash_attention.py:68",
             entry="flash_attention_tc_launch",
             launches=served["smollm-135m"]["counts_by_entry"].get(
                 "flash_attention_tc_launch", 0),
             main_path="the bf16 route of flash_attention at D <= 32 (the "
                       "JAX sweep's head dims; phase 5), not launched by "
                       "any served model; held and timed through launch in "
                       "turns with flash_attention_ws at every bf16 path "
                       "shape",
             max_abs_err=flash["bfloat16"]["present_err"],
             ms=sum(flash["bfloat16"]["present_ms"]) / 2,
             ms_turns=flash["bfloat16"]["present_ms"],
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
             launches=family["datum"]["gemma3-12b"]["launches"].get(
                 "flash_attention_tc_f32_256_launch", 0),
             main_path="the f32 route of flash_attention at D = 256: "
                       "gemma3-12b's f32 datum prefill of phase 13a (2 x "
                       "1100 prompt, 6 layers, 5 windowed), one launch per "
                       "layer; held over 8 seeds and timed at gemma2-2b's "
                       "head layout in phase 5, in turns with the FMA "
                       "kernel, and at the datum's shapes in phase 13c "
                       "(row flash_attention_tc_f32_256_gemma3_12b)",
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
    fk, fs = family["kernel"], family["serve"]
    WS_ENTRY = fa.WS_BF16[1]

    mk, ms_ = moe["kernel"], moe["serve"]

    def family_row(name, row, launches, main_path, extra_rows=(), table=fk):
        k = table[row]
        lib = fa.WS_BF16[0] if k["entry"] == WS_ENTRY else fa.TC_BF16[0]
        rec = dict(name=name, route="cuda",
                   source=f"src/repro_torch/kernels/csrc/{lib}.cu",
                   replaces="src/repro/kernels/flash_attention.py:68",
                   entry=k["entry"], launches=launches, main_path=main_path,
                   max_abs_err=k["max_abs_err"], ms=k["ms"],
                   plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                   bound_by=k["bound_by"], library_ms=k["library_ms"],
                   library="scaled_dot_product_attention (enable_gqa; a "
                           "boolean mask where there is a window)",
                   library_err=k["library_err"], kept_pairs=k["pairs"],
                   shape=k["shape"], checked_err=k["checked"],
                   checked_how=k["checked_how"], checked_limit=k["limit"],
                   planted_window_fault=k["planted_window_fault"],
                   present_kernel=k["present"])
        for key, other in extra_rows:
            rec[key] = {f: table[other][f] for f in (
                "shape", "max_abs_err", "checked", "planted_window_fault",
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "pairs", "present")}
        return rec
    kernels += [
        family_row("flash_attention_ws_gemma3_12b", "gemma3-12b",
                   fs["gemma3-12b"]["launches"].get(
                       WS_ENTRY, 0),
                   "gemma3-12b bf16 serve at full width and depth, 4 x 2048 "
                   "prompt + 64 decode steps (phase 13b): one launch per "
                   "layer at prefill, 40 with window 1024 (this row's "
                   "shape) and 8 global",
                   (("global_shape", "gemma3-12b global"),)),
        family_row("flash_attention_tc_f32_256_gemma3_12b",
                   "gemma3-12b f32 datum",
                   family["datum"]["gemma3-12b"]["launches"].get(
                       "flash_attention_tc_f32_256_launch", 0),
                   "gemma3-12b f32 datum prefill of phase 13a (6 layers, 2 "
                   "x 1100 prompt): one launch per layer, 5 with window "
                   "1024 (this row's shape) and 1 global; S is not a "
                   "multiple of the 32-key tile",
                   (("global_shape", "gemma3-12b f32 datum global"),)),
        family_row("flash_attention_ws_deepseek_67b", "deepseek-67b",
                   fs["deepseek-67b"]["launches"].get(
                       WS_ENTRY, 0),
                   "deepseek-67b bf16 serve at full width, 16 of 95 layers "
                   "(one card), 4 x 1024 prompt + 64 decode steps (phase "
                   "13b): one launch per layer at prefill"),
        family_row("flash_attention_ws_seamless_m4t_large_v2",
                   "seamless-m4t-large-v2",
                   fs["seamless-m4t-large-v2"]["launches"].get(
                       WS_ENTRY, 0),
                   "seamless-m4t-large-v2 bf16 serve at full width and "
                   "depth, 4 x 1024 prompt and 256 frames + 64 decode steps "
                   "(phase 13b): one launch per self-attention layer at "
                   "prefill, 12 in the decoder (this row's shape) and 12 "
                   "non-causal in the encoder; cross-attention takes the "
                   "plain softmax",
                   (("encoder_shape", "seamless-m4t-large-v2 encoder"),)),
        family_row("flash_attention_ws_mixtral_8x7b", "mixtral-8x7b",
                   ms_["mixtral-8x7b"]["launches"].get(
                       WS_ENTRY, 0),
                   "mixtral-8x7b bf16 serve at full width, 16 of 32 layers "
                   "(one card), 2 x 4160 prompt + 64 decode steps (phase "
                   "14b): one launch per layer at prefill, window 4096 "
                   "(windowed D = 128 in bf16)", table=mk),
        family_row("flash_attention_tc_f32_mixtral_8x7b",
                   "mixtral-8x7b f32 datum",
                   moe["datum"]["mixtral-8x7b"]["launches"].get(
                       "flash_attention_tc_f32_launch", 0),
                   "mixtral-8x7b f32 datum prefill of phase 14a (1 layer, 1 "
                   "x 4160 prompt, window 4096)", table=mk),
        family_row("flash_attention_ws_phi3_5_moe_42b", "phi3.5-moe-42b",
                   ms_["phi3.5-moe-42b"]["launches"].get(
                       WS_ENTRY, 0),
                   "phi3.5-moe-42b bf16 serve at full width, 16 of 32 "
                   "layers (one card), 4 x 1024 prompt + 64 decode steps "
                   "(phase 14b): one launch per layer at prefill", table=mk),
        family_row("flash_attention_tc_f32_phi3_5_moe_42b",
                   "phi3.5-moe-42b f32 datum",
                   moe["datum"]["phi3.5-moe-42b"]["launches"].get(
                       "flash_attention_tc_f32_launch", 0),
                   "phi3.5-moe-42b f32 datum prefill of phase 14a (1 layer, "
                   "2 x 256 prompt)", table=mk),
        family_row("flash_attention_ws_jamba_1_5_large_398b",
                   "jamba-1.5-large-398b",
                   ms_["jamba-1.5-large-398b"]["launches"].get(
                       WS_ENTRY, 0),
                   "jamba-1.5-large-398b bf16 serve at full width, the first "
                   "5 of 72 layers (one card), 2 x 1024 prompt + 64 decode "
                   "steps (phase 14b): its one attn layer at prefill",
                   table=mk),
    ]
    js = mk["jamba-1.5-large-398b ssd"]
    kernels.append(dict(
        name="ssd_scan_tc_jamba_1_5_large_398b", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan_tc.cu",
        replaces="src/repro/kernels/ssd_scan.py:68", entry=js["entry"],
        launches=ms_["jamba-1.5-large-398b"]["ssd_scan_tc_launches"],
        main_path="jamba-1.5-large-398b bf16 serve at full width, the first "
                  "5 of 72 layers, 2 x 1024 prompt + 64 decode steps (phase "
                  "14b): one launch per ssm layer at prefill (4), 256 heads",
        max_abs_err=js["max_abs_err"], past_abs_limit=js["past_abs_limit"],
        least_y_past=js["least_y_past"],
        over_abs_and_ulp=js["over_abs_and_ulp"],
        ms=js["ms"], plain_ms=js["plain_ms"], bound_ms=js["bound_ms"],
        bound_by=js["bound_by"], library_ms=None, shape=js["shape"]))
    print(json.dumps({"serve": served}))
    print(json.dumps({"family": family}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"train": trained, "train_ssd": trained_ssd,
                      "train_moe": trained_moe}))
    print(json.dumps({"launch": launch}))
    print(json.dumps({"analysis": analysis}))
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
