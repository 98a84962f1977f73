"""End-to-end training launcher with PCS-tier checkpointing (port of
``repro.launch.train``).

Trains ``--arch`` (full or ``--smoke``) on one device, persisting the
train state through the PCS checkpoint manager (``--scheme
nopb|pb|pb_rf``), with failure detection, elastic remesh planning and
straggler mitigation wired in as in the reference.  Weights are
``models.convert.numpy_params(cfg, 0)``, the tree the reference can be
fed.  Without ``--device`` it runs on CUDA and raises where there is
none.

Checkpoints are the reference's: one shard per leaf of ``{"params":
<the reference's stacked tree>, "opt": <its optimizer state>}``, named
by the leaf's ``jax.tree_util.keystr`` path (``['params']['blocks'][0]
['attn']['wq']['w']``, ``['opt']['step']``, ...) and persisted in JAX's
flatten order, then ``__meta__``.  The port restacks its per-layer
tensors on save and splits them on restore, so a store directory written
by either package restores in the other (bf16 leaves: see
``persistence.store``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --device cpu --steps 50 --ckpt-every 10 --ckpt-dir CKPT
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.launch.serve import _sync
from repro_torch.launch.steps import Step, make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.convert import (numpy_params, opt_state_from_reference,
                                        param_shapes, params_from_reference,
                                        stack_layers, unstack_layers)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.persistence import (DurableStore, HostBufferTier,
                                     PCSCheckpointManager, PersistScheme)
from repro_torch.runtime import FailureDetector, StragglerMitigator, plan_mesh


def _paths(tree, prefix: str = "") -> Iterator:
    """``(keystr path, leaf)`` in JAX's flatten order (dict keys sorted);
    dicts and lists are nodes, anything else a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _paths(t, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _with_paths(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_paths(fn, t, f"{prefix}[{i}]")
                for i, t in enumerate(tree)]
    return fn(prefix, tree)


def state_tree(model: T.Transformer, opt_state: Dict[str, Any]) -> dict:
    """``{"params", "opt"}`` in the reference's layout (tensors on the
    model's device)."""
    cfg = model.cfg
    opt = {k: v for k, v in opt_state.items() if k not in ("m", "v")}
    opt["m"] = stack_layers(cfg, opt_state["m"])
    opt["v"] = stack_layers(cfg, opt_state["v"])
    return {"params": stack_layers(cfg, dict(model.named_parameters())),
            "opt": opt}


def _shape_tree(cfg: T.ModelConfig, opt_state: Dict[str, Any]) -> dict:
    """:func:`state_tree`'s layout with shapes for leaves (no tensors)."""
    shapes = param_shapes(cfg)
    opt = {k: shapes for k in opt_state if k != "step"}
    opt["step"] = ()
    return {"params": shapes, "opt": opt}


@torch.no_grad()
def save_state(mgr: PCSCheckpointManager, version: int,
               model: T.Transformer, opt_state: Dict[str, Any],
               data_state: dict) -> float:
    """Persist the train state as per-leaf shards; returns persist seconds.

    Each leaf is its own shard (the cluster analogue of a cache line):
    write coalescing and read forwarding then operate per leaf.
    """
    t0 = time.time()
    for name, leaf in _paths(state_tree(model, opt_state)):
        mgr.persist(name, version, leaf.cpu())
    mgr.persist("__meta__", version, {"data": data_state, "version": version})
    return time.time() - t0


@torch.no_grad()
def restore_state(mgr: PCSCheckpointManager, model: T.Transformer,
                  opt_state: Dict[str, Any]):
    """Restore the newest consistent state into ``model`` (in place) and a
    new optimizer state shaped as ``opt_state``; returns ``(version,
    model, opt_state, data_state)``, or ``None`` with no checkpoint."""
    meta = mgr.restore("__meta__")
    if meta is None:
        return None
    version = meta[1]["version"]
    cfg = model.cfg
    shapes = _shape_tree(cfg, opt_state)
    got = {}
    for name, _ in _paths(shapes):
        rec = mgr.restore(name)
        if rec is None or rec[0] < version:
            raise RuntimeError(f"shard {name} is missing or older "
                               f"({rec and rec[0]}) than the checkpoint "
                               f"(version {version})")
        got[name] = rec[1]
    tree = _with_paths(lambda name, _: got[name], shapes)
    dev = next(model.parameters()).device
    for name, t in unstack_layers(cfg, tree["params"]).items():
        model.get_parameter(name).copy_(t)
    return (version, model, opt_state_from_reference(cfg, tree["opt"], dev),
            meta[1]["data"])


def make_manager(args) -> PCSCheckpointManager:
    scheme = PersistScheme(args.scheme)
    buffer = HostBufferTier(capacity_bytes=args.buffer_mb << 20)
    store = DurableStore(args.ckpt_dir, write_delay_s=args.store_delay_ms / 1e3)
    return PCSCheckpointManager(buffer, store, scheme=scheme)


def train(model: T.Transformer, opt_state: Dict[str, Any],
          data: SyntheticLMDataset, step_fn: Step,
          mgr: PCSCheckpointManager, *, start: int, steps: int,
          ckpt_every: int, log: Callable[[str], None] = print) -> dict:
    """The training loop of :func:`main`: steps ``start .. steps - 1``,
    a checkpoint every ``ckpt_every`` steps and after the last.  Returns
    the final optimizer state, each step's metrics (floats) and host
    seconds (the step ends in a device synchronize), and each
    checkpoint's persist seconds."""
    dev = next(model.parameters()).device
    detector = FailureDetector(["node0"])
    straggler = StragglerMitigator()
    out = {"metrics": [], "step_s": [], "persist_s": []}
    for step in range(start, steps):
        t0 = time.time()
        opt_state, metrics = step_fn(opt_state, data.next_batch())
        _sync(dev)
        dt = time.time() - t0
        metrics = {k: float(v) for k, v in metrics.items()}
        out["metrics"].append(metrics)
        out["step_s"].append(dt)
        detector.heartbeat("node0")
        if straggler.observe(dt):
            log(f"  straggler flagged at step {step} ({dt:.2f}s)")
        if (step + 1) % ckpt_every == 0 or step + 1 == steps:
            psec = save_state(mgr, step + 1, model, opt_state, data.state())
            out["persist_s"].append(psec)
            log(f"step {step+1:4d} loss {metrics['loss']:.4f} "
                f"gnorm {metrics['grad_norm']:.3f} "
                f"step_s {dt:.2f} persist_s {psec:.3f}")
    out["opt_state"] = opt_state
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--scheme", default="pb_rf",
                    choices=["nopb", "pb", "pb_rf"])
    ap.add_argument("--buffer-mb", type=int, default=256)
    ap.add_argument("--store-delay-ms", type=float, default=20.0,
                    help="durable-store write latency (object-store analogue)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-ratio", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
    model = params_from_reference(cfg, numpy_params(cfg, 0), dev)
    opt_state = adamw_init(opt_cfg, dict(model.named_parameters()))
    data = SyntheticLMDataset(cfg.vocab, args.seq, args.batch,
                              d_model=cfg.d_model, frontend=cfg.frontend,
                              frontend_seq=cfg.frontend_seq)

    mgr = make_manager(args)
    start = 0
    if args.resume:
        rec = restore_state(mgr, model, opt_state)
        if rec is not None:
            start, model, opt_state, data_state = rec
            data.restore(data_state)
            print(f"resumed at step {start} "
                  f"(forwarded={mgr.stats['restore_forwarded']}, "
                  f"store={mgr.stats['restore_from_store']})")

    step_fn = make_train_step(model, opt_cfg,
                              compress_ratio=args.compress_ratio)
    try:
        out = train(model, opt_state, data, step_fn, mgr, start=start,
                    steps=args.steps, ckpt_every=args.ckpt_every,
                    log=lambda s: print(s, flush=True))
    finally:
        mgr.close()
    print("train done; persistence stats:", mgr.stats)
    # elastic plan sanity (what we would do on chip loss)
    plan = plan_mesh(255, model_parallel=16)
    print("elastic plan if 1 chip of 256 dies:", plan)
    out["stats"] = dict(mgr.stats)
    return out


if __name__ == "__main__":
    main()
