"""Carrying weights between the reference's layout and the port's model.

The reference's ``init_params`` tree is nested dicts of arrays::

    {"embed": {"table"}, "final_norm": {"scale"},
     "blocks": [<one dict per block position, every leaf with a leading
                 reps axis>]}

and the port holds one ``Block`` per layer, whose parameter names are
the same paths joined by dots (``attn.wq.w``, ``ssm.A_log``, ...).
Layer ``r * len(block_pattern) + j`` is repetition ``r`` of position
``j``.

* :func:`reference_tree` reads a model back into that layout (on the
  meta device it gives the shapes alone);
* :func:`params_from_reference` builds a model holding a tree's weights;
* :func:`numpy_params` makes such a tree from ``numpy.random
  .default_rng(seed)``, every leaf random at an init-like scale, so that
  a leaf carried to the wrong place shows; the tests and the datum
  script feed the same tree to both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import ModelConfig, Transformer


def _nest(items) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, val in items:
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = val
    return out


def _top_leaves(model: Transformer):
    return {"embed.table": model.embed.table,
            "final_norm.scale": model.final_norm.scale}


def reference_tree(model: Transformer) -> Dict[str, Any]:
    """The model's weights in the reference's stacked layout."""
    p = len(model.cfg.block_pattern)
    tree = _nest(_top_leaves(model).items())
    tree["blocks"] = []
    for j in range(p):
        layers = list(model.layers)[j::p]
        tree["blocks"].append(_nest(
            (name, torch.stack([l.get_parameter(name) for l in layers]))
            for name, _ in layers[0].named_parameters()))
    return tree


def _map_dict(d: Dict[str, Any], fn: Callable[[str, Any], Any],
              prefix: str) -> Dict[str, Any]:
    return {k: (_map_dict(v, fn, f"{prefix}{k}.") if isinstance(v, dict)
                else fn(f"{prefix}{k}", v)) for k, v in d.items()}


def _map_tree(tree: Dict[str, Any],
              fn: Callable[[str, Any], Any]) -> Dict[str, Any]:
    """``fn(name, leaf)`` over a reference tree, in layout order; names
    are dotted paths, with ``blocks.<j>.`` before a block's leaves."""
    out = _map_dict({k: v for k, v in tree.items() if k != "blocks"}, fn,
                    "")
    out["blocks"] = [_map_dict(blk, fn, f"blocks.{j}.")
                     for j, blk in enumerate(tree["blocks"])]
    return out


def _leaves(tree: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    _map_tree(tree, out.__setitem__)
    return out


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference tree's leaf shapes (from a model on the meta device)."""
    return _map_tree(reference_tree(Transformer(cfg, device="meta")),
                     lambda name, t: tuple(t.shape))


def params_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                          device=None) -> Transformer:
    """A model holding ``tree``'s weights (numpy arrays, reference layout),
    cast to each parameter's dtype."""
    model = Transformer(cfg, device)
    want = _leaves(param_shapes(cfg))
    got = _leaves(tree)
    if set(got) != set(want):
        raise ValueError(f"tree leaves differ from {cfg.name}'s layout: "
                         f"missing {sorted(set(want) - set(got))}, "
                         f"extra {sorted(set(got) - set(want))}")
    for name, arr in got.items():
        if tuple(np.shape(arr)) != want[name]:
            raise ValueError(f"{name}: shape {np.shape(arr)}, expected "
                             f"{want[name]}")
    p = len(cfg.block_pattern)
    with torch.no_grad():
        for name, param in _top_leaves(model).items():
            param.copy_(torch.from_numpy(np.asarray(got[name])))
        for name, arr in got.items():
            if not name.startswith("blocks."):
                continue
            _, j, leaf = name.split(".", 2)
            arr = np.asarray(arr)
            for r in range(cfg.reps):
                model.layers[r * p + int(j)].get_parameter(leaf).copy_(
                    torch.from_numpy(arr[r]))
    return model


# Standard deviations of the normal leaves; "w" takes 1/sqrt(d_in).  The
# conv taps and bias take 0.3, about PyTorch's Conv1d default (uniform
# within 1/sqrt(4), std 0.29): at the reference's 0.1 the conv output is
# so small that the SSD scan barely moves mamba2's logits, and a check
# of the logits would not see the scan.
_NORMAL_STD = {"table": 0.02, "scale": 0.1, "conv_w": 0.3, "conv_b": 0.3}


def _init_leaf(rng: np.random.Generator, name: str,
               shape: Tuple[int, ...]) -> np.ndarray:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "w" or leaf in _NORMAL_STD:
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= (1.0 / np.sqrt(shape[-2])) if leaf == "w" else _NORMAL_STD[leaf]
        return a
    u = rng.random(shape, dtype=np.float32)
    if leaf == "A_log":                   # A = -exp(A_log) in [-16, -1]
        return np.log(1.0 + 15.0 * u).astype(np.float32)
    if leaf == "D":
        return (0.5 + u).astype(np.float32)
    if leaf == "dt_bias":                 # softplus^-1 of dt in [1e-3, 0.1]
        dt = np.exp(np.log(1e-3) + u * (np.log(0.1) - np.log(1e-3)))
        return (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    raise ValueError(f"no init rule for leaf {name}")


def numpy_params(cfg: ModelConfig, seed: int) -> Dict[str, Any]:
    """A random f32 tree in the reference's layout, from
    ``numpy.random.default_rng(seed)`` (leaves drawn in layout order)."""
    rng = np.random.default_rng(seed)
    return _map_tree(param_shapes(cfg),
                     lambda name, shape: _init_leaf(rng, name, shape))
