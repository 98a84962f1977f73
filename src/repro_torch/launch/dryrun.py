"""Multi-pod dry-run: every (arch x shape x mesh) cell's step, traced on
the meta device over the production meshes (port of
``repro.launch.dryrun``).

Proves that the distribution config is coherent without the hardware.
Each cell builds its production mesh (16x16 single-pod, 2x16x16
multi-pod) over torch's fake process group of 256 or 512 ranks
(``launch.mesh``), the counterpart of the reference's 512 placeholder
host devices; takes the spec and a meta DTensor of every leaf
(parameters, optimizer state, batch and caches; ``launch.sharding``);
and runs the cell's step (train, prefill or decode) on the meta device
at the production shape under ``torch.utils.flop_counter
.FlopCounterMode``, the counterpart of the reference's ``.lower()``.
It runs on the meta device and the fake group by contract, as the
reference's runs on forced host devices: it touches no CUDA device, has
no device argument, and is no CPU fallback of anything (the meta device
computes nothing).  A cell whose step does not trace is a FAILED row.

Each row holds ``arch``, ``shape``, ``mesh``, ``status``, ``chips``;
``analytic`` (the reference's first-principles residency and HBM
traffic, :func:`analytic_cell`); ``param_bytes_per_device``,
``opt_bytes_per_device``, ``batch_bytes_per_device`` and
``cache_bytes_per_device``, the sums of the DTensors' local shards (the
counterpart of ``memory_analysis``' argument bytes; a prefill's caches
are its output, so only a decode cell has cache bytes);
``flops_per_device``, the step's counted flops divided by the chips (no
partitioner runs, so this is the even share, not a per-device count);
``t_compute_s`` and ``t_memory_s`` at one H100's peaks (:data:`PEAKS`)
and the larger of the two as ``bottleneck``; the ``moe_groups`` and the
``activation_spec`` chosen, and the seconds the meta pass and the
sharding took.  It has no collective keys: the reference reads those
from the partitioned HLO (and its ``cost_analysis``, ROADMAP F4), and no
partitioner runs here.  The port's layer stack is a Python loop, so the
meta pass counts every layer at full depth; the reference's unrolled
1- and 2-block probes have no counterpart.

The meta pass of a cell runs once for the meshes whose step is the same:
only the MoE routing groups differ between the meshes, so a model
without MoE layers shares one pass between them.  The cells run in a
pool of spawned processes, one per core (one cell alone runs in this
process).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both \\
        --out results/dryrun.json
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
import types
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, Shape, applicable
from repro_torch.launch.specs import (decode_specs, opt_state_specs,
                                      params_specs, train_batch_specs)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense): the card every
# number of the port is measured on.
PEAKS = {"card": "NVIDIA H100 80GB HBM3, 700.00 W",
         "bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}

MICROBATCHES = [1]


def _mesh_shape(multi_pod: bool):
    """The production mesh's axis names and sizes, without a group."""
    if multi_pod:
        return types.SimpleNamespace(
            mesh_dim_names=("pod", "data", "model"), shape=(2, 16, 16))
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(16, 16))


def _msize(mesh, axes) -> int:
    return sh._axis_size(mesh, tuple(axes))


def cell_plan(cfg: T.ModelConfig, shape: Shape, mesh):
    """(activation spec, MoE routing groups) of a cell, as the
    reference's ``_lower_cell`` chooses them."""
    dp = sh.batch_axes(mesh)
    bdim = (dp if shape.global_batch % _msize(mesh, dp) == 0
            and shape.global_batch > 1 else None)
    mode = sh.FLAGS["act_shard"]
    if mode == "seq" and shape.seq_len % sh._axis_size(mesh, "model") == 0:
        act = (bdim, "model")
    elif mode == "d":
        act = (bdim, None, "model")
    else:
        act = (bdim,)
    n_tokens = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1)
    g = _msize(mesh, dp) if bdim is not None and n_tokens % _msize(
        mesh, dp) == 0 else 1
    return act, g


def analytic_cell(cfg, shape, chips: int, moment_bytes: int) -> dict:
    """First-principles per-device residency and HBM traffic (bytes), the
    reference's model of a cell."""
    P_total = cfg.param_count()
    P_local = P_total / chips
    dp = max(chips // 16, 1) if shape.global_batch > 1 else 1
    b_loc = max(shape.global_batch // dp, 1)
    s = shape.seq_len
    d = cfg.d_model
    v_loc = cfg.vocab / 16 if cfg.vocab % 16 == 0 else cfg.vocab
    act_frac = cfg.active_param_count() / P_total

    if shape.kind == "train":
        resident = P_local * (2 + 2 * moment_bytes)      # params + m + v
        # saved block inputs; only one microbatch's worth is live at once
        resident += cfg.reps * b_loc * s * d * 2 / MICROBATCHES[0]
        traffic = P_local * (2 * 3 * act_frac + 2 * moment_bytes + 2)
        traffic += cfg.reps * b_loc * s * d * 2 * 2
        traffic += b_loc * s * v_loc * 4 * 2
    elif shape.kind == "prefill":
        resident = P_local * 2 + _cache_bytes(cfg, shape, chips)
        traffic = P_local * 2 * act_frac + _cache_bytes(cfg, shape, chips)
        traffic += b_loc * s * d * 2 * cfg.n_layers / 4   # block activations
    else:  # decode: one token
        cache = _cache_bytes(cfg, shape, chips)
        resident = P_local * 2 + cache
        traffic = P_local * 2 * act_frac + cache          # read whole cache
    return {"resident_bytes": float(resident), "traffic_bytes": float(traffic)}


def _cache_bytes(cfg, shape, chips: int) -> float:
    """Per-device KV/SSM cache bytes for this shape."""
    total = 0.0
    reps = cfg.reps
    for spec in cfg.block_pattern:
        if spec.kind == "ssm":
            d_inner = cfg.ssm_expand * cfg.d_model
            h = d_inner // cfg.ssm_head_dim
            total += reps * shape.global_batch * (
                h * cfg.ssm_head_dim * cfg.ssm_state * 4
                + 3 * (d_inner + 2 * cfg.ssm_state) * 2)
        else:
            alloc = shape.seq_len
            if spec.kind == "swa" and cfg.window:
                alloc = min(alloc, cfg.window)
            total += (reps * shape.global_batch * alloc
                      * cfg.n_kv_heads * cfg.hd * 2 * 2)
    return total / chips


def opt_config(cfg: T.ModelConfig) -> AdamWConfig:
    """bf16 moments above 1e11 parameters (jamba's 398B), as the
    reference's dry-run takes them."""
    big = cfg.param_count() > 1e11
    return AdamWConfig(moment_dtype=torch.bfloat16 if big
                       else torch.float32)


def _bmm_flop(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """``bmm``'s flops, for its ``out_dtype`` overload too (the flop
    counter's own formula takes that argument for ``out_shape``): the
    MoE expert products over training's capacity buffer."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


def _mm_flop(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """``mm``'s flops, for its ``out_dtype`` overload too: the MoE expert
    products over serving's routed rows, one expert at a time."""
    m, k = a_shape
    return 2 * m * k * b_shape[-1]


FLOP_FORMULAS = {torch.ops.aten.bmm: _bmm_flop, torch.ops.aten.mm: _mm_flop}


def meta_pass(cfg: T.ModelConfig, shape: Shape, opt_cfg: AdamWConfig,
              groups: int, act=None) -> int:
    """The cell's step on the meta device at the production shape, under
    ``moe_groups(groups)`` and ``activation_sharding(act)``: its flops
    as ``FlopCounterMode`` counts them.  Raises where it does not trace."""
    from torch.utils.flop_counter import FlopCounterMode
    model = params_specs(cfg)
    counter = FlopCounterMode(display=False, custom_mapping=FLOP_FORMULAS)
    with counter, T.moe_groups(groups), T.activation_sharding(act):
        if shape.kind == "train":
            opt = opt_state_specs(cfg, opt_cfg,
                                  dict(model.named_parameters()))
            step = make_train_step(model, opt_cfg,
                                   microbatches=MICROBATCHES[0])
            step(opt, train_batch_specs(cfg, shape))
        elif shape.kind == "prefill":
            batch = train_batch_specs(cfg, shape)
            batch.pop("labels")
            with torch.inference_mode():
                make_prefill_step(model, shape.seq_len)(batch)
        else:
            d = decode_specs(cfg, shape)
            with torch.inference_mode():
                make_decode_step(model)(d["tokens_last"], d["caches"],
                                        d["pos0"], d.get("enc_out"),
                                        d.get("enc_pos"))
    return counter.get_total_flops()


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               for t in sh.leaves(tree).values())


def sharded_bytes(cfg: T.ModelConfig, shape: Shape, mesh,
                  opt_cfg: AdamWConfig) -> Dict[str, int]:
    """Every leaf of the cell's step as a meta DTensor on ``mesh``: the
    local bytes of one device, by group (parameters, optimizer state,
    batch, caches)."""
    params = dict(params_specs(cfg).named_parameters())
    out = {"param": _local_bytes(sh.shard_tree(mesh, params)), "opt": 0,
           "batch": 0, "cache": 0}
    if shape.kind == "train":
        out["opt"] = _local_bytes(sh.shard_tree(
            mesh, opt_state_specs(cfg, opt_cfg, params)))
    if shape.kind != "decode":
        batch = train_batch_specs(cfg, shape)
        if shape.kind == "prefill":
            batch.pop("labels")
        out["batch"] = _local_bytes(sh.shard_batch(mesh, batch))
        return out
    d = decode_specs(cfg, shape)
    batch = {k: d[k] for k in ("tokens_last", "enc_out") if k in d}
    rest = {k: d[k] for k in ("pos0", "enc_pos") if k in d}
    out["batch"] = (_local_bytes(sh.shard_batch(mesh, batch))
                    + _local_bytes(sh.replicated(mesh, rest)))
    out["cache"] = _local_bytes(sh.shard_caches(mesh, d["caches"],
                                                shape.global_batch))
    return out


def _mesh_name(multi_pod: bool) -> str:
    return "multi" if multi_pod else "single"


def _skipped(arch: str, shape_name: str, multi_pod: bool) -> dict:
    return {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
            "status": "skipped (full-attention arch, long-context cell)"}


def run_cells(cfg: T.ModelConfig, shape: Shape, multi_pods: Sequence[bool],
              arch: Optional[str] = None, verbose: bool = True
              ) -> List[dict]:
    """One row per mesh of ``multi_pods`` for an applicable cell, with one
    meta pass for the meshes whose MoE routing groups are equal."""
    arch = arch or cfg.name
    opt_cfg = opt_config(cfg)
    moment_bytes = 2 if opt_cfg.moment_dtype == torch.bfloat16 else 4
    passes: Dict[int, tuple] = {}
    rows = []
    for mp in multi_pods:
        act, g = cell_plan(cfg, shape, _mesh_shape(mp))
        key = g if cfg.n_experts else 0
        if key not in passes:
            t0 = time.time()
            passes[key] = (meta_pass(cfg, shape, opt_cfg, g, act),
                           time.time() - t0)
        flops, pass_s = passes[key]
        t0 = time.time()
        with make_production_mesh(multi_pod=mp) as mesh:
            chips = mesh.size()
            local = sharded_bytes(cfg, shape, mesh, opt_cfg)
        shard_s = time.time() - t0
        ana = analytic_cell(cfg, shape, chips, moment_bytes)
        t_compute = flops / chips / PEAKS["bf16_flops_per_s"]
        t_memory = ana["traffic_bytes"] / PEAKS["hbm_bytes_per_s"]
        res = {
            "arch": arch, "shape": shape.name, "mesh": _mesh_name(mp),
            "status": "ok", "chips": chips,
            "moment_dtype": str(opt_cfg.moment_dtype).replace("torch.", ""),
            "moe_groups": g, "activation_spec": act,
            "flops": flops, "flops_per_device": flops / chips,
            "param_bytes_per_device": local["param"],
            "opt_bytes_per_device": local["opt"],
            "batch_bytes_per_device": local["batch"],
            "cache_bytes_per_device": local["cache"],
            "t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_at": PEAKS["card"], "analytic": ana,
            "bottleneck": "compute" if t_compute >= t_memory else "memory",
            "meta_pass_s": pass_s, "shard_s": shard_s,
        }
        if verbose:
            print(f"  {arch} x {shape.name} x {res['mesh']}: meta pass "
                  f"{pass_s:.1f}s, sharding {shard_s:.1f}s | params "
                  f"{local['param'] / 2**30:.2f}GiB opt "
                  f"{local['opt'] / 2**30:.2f}GiB batch "
                  f"{local['batch'] / 2**30:.3f}GiB cache "
                  f"{local['cache'] / 2**30:.2f}GiB | resident "
                  f"{ana['resident_bytes'] / 2**30:.2f}GiB | flops/dev "
                  f"{flops / chips:.3g} bytes/dev "
                  f"{ana['traffic_bytes']:.3g} -> {res['bottleneck']}-bound",
                  flush=True)
        rows.append(res)
    return rows


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True) -> dict:
    """One cell's row (its own meta pass)."""
    cfg = get_config(arch)
    if not applicable(cfg, SHAPES[shape_name]):
        return _skipped(arch, shape_name, multi_pod)
    return run_cells(cfg, SHAPES[shape_name], [multi_pod], arch, verbose)[0]


def _task(arch: str, shape_name: str, multi_pods: Sequence[bool],
          flags: dict, microbatch: int) -> List[dict]:
    """A pool worker's cells: the parent's FLAGS first (a spawned worker
    imports this module afresh); a cell that does not trace gives FAILED
    rows, each naming the error."""
    sh.FLAGS.update(flags)
    MICROBATCHES[0] = microbatch
    try:
        return run_cells(get_config(arch), SHAPES[shape_name], multi_pods,
                         arch)
    except Exception as e:  # a failure here is a sharding or model bug
        print(f"  {arch} x {shape_name} FAILED: {e!r}", flush=True)
        return [{"arch": arch, "shape": shape_name,
                 "mesh": _mesh_name(mp), "status": f"FAILED: {e!r}"}
                for mp in multi_pods]


def _tasks(archs, shapes, meshes):
    """(rows of skipped cells, pool tasks): one task per (arch, shape)
    and meta pass, the longest first."""
    skipped, tasks = [], []
    for arch in archs:
        cfg = get_config(arch)
        for name in shapes:
            shape = SHAPES[name]
            if not applicable(cfg, shape):
                skipped += [_skipped(arch, name, mp) for mp in meshes]
                continue
            by_pass: Dict[int, list] = {}
            for mp in meshes:
                g = cell_plan(cfg, shape, _mesh_shape(mp))[1]
                by_pass.setdefault(g if cfg.n_experts else 0, []).append(mp)
            kind = ("train", "prefill", "decode").index(shape.kind)
            for g, mps in by_pass.items():
                cost = (-(cfg.n_experts > 0) * g, kind, -cfg.n_layers)
                tasks.append((cost, arch, name, mps))
    tasks.sort()
    return skipped, [t[1:] for t in tasks]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--set", action="append", default=[],
                    help="sharding FLAGS override, e.g. --set "
                         "moe_expert_parallel=1")
    args = ap.parse_args(argv)

    MICROBATCHES[0] = args.microbatch
    for kv in args.set:
        k, _, v = kv.partition("=")
        if k not in sh.FLAGS or not v:
            ap.error(f"unknown flag {kv!r}; have {sorted(sh.FLAGS)}")
        sh.FLAGS[k] = v if k == "act_shard" else bool(int(v))

    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    t0 = time.time()
    results, tasks = _tasks(archs, shapes, meshes)
    work = [(arch, name, mps, dict(sh.FLAGS), MICROBATCHES[0])
            for arch, name, mps in tasks]
    if len(work) == 1:
        results += _task(*work[0])
    elif work:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(len(work), os.cpu_count() or 1),
                                 mp_context=ctx, initializer=torch.set_num_threads,
                                 initargs=(1,)) as pool:
            for rows in pool.map(_task, *zip(*work)):
                results += rows
    order = {(a, s, m): i for i, (a, s, m) in enumerate(
        (a, s, _mesh_name(mp)) for a in archs for s in shapes
        for mp in meshes)}
    results.sort(key=lambda r: order[r["arch"], r["shape"], r["mesh"]])
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    ok = sum(r["status"] == "ok" for r in results)
    skipped = sum("skipped" in r["status"] for r in results)
    failures = sum(r["status"].startswith("FAILED") for r in results)
    print(f"dry-run finished in {time.time() - t0:.1f} s")
    print(f"dry-run: {ok} ok, {skipped} skipped, {failures} FAILED")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
