"""AdamW with dtype-configurable moments, global-norm clip, schedules
(port of ``repro.optim.adamw``).

Functional, as the reference: the state is a tree mirroring the
parameters, ``{"m": <tree>, "v": <tree>, "step": int32 scalar}``, and
:func:`adamw_update` returns new tensors (under ``torch.no_grad()``).  A
tree is a tensor, or a dict or list of trees; dict keys are visited in
sorted order, as JAX flattens them, so sums over leaves run in the
reference's order when both are fed the same tree.  Tuples are leaves
(:func:`adamw_update` maps to one).

The order of operations is the reference's: clip by the global norm
first (the clipped gradient is f32, as JAX promotes a bf16 gradient
times an f32 scale), then the bias corrections in f32, then
``p - (lr * delta).to(p.dtype)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: Any = torch.float32
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"            # "cosine" | "linear" | "const"


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of ``tree`` in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of its shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def adamw_init(cfg: AdamWConfig, params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "linear":
        return cfg.lr * warm * (1.0 - frac)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = cosine_schedule(cfg, step)
    b1t = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2t = 1.0 - cfg.b2 ** step.to(torch.float32)
    md = cfg.moment_dtype

    def upd(p, g, m, v):
        # clipped leaf by leaf, so that no second copy of every gradient
        # is alive at once
        if scale is not None:
            g = g.to(torch.promote_types(g.dtype, scale.dtype)) * scale
        g32 = g.to(md)
        m2 = cfg.b1 * m + (1 - cfg.b1) * g32
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        mh = m2 / b1t
        vh = v2 / b2t
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(md)
        return p - (lr * delta).to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, {
        "grad_norm": gnorm, "lr": lr}
