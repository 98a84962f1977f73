"""Carrying weights between the reference's layout and the port's model.

The reference's ``init_params`` tree is nested dicts of arrays::

    {"embed": {"table"}, "final_norm": {"scale"},
     "blocks": [<one dict per block position, every leaf with a leading
                 reps axis>],
     # an encoder-decoder also has
     "enc_blocks": [<one dict: n_enc_layers plain "attn" layers>],
     "enc_norm": {"scale"}}

and the port holds one ``Block`` per layer (``layers``, and the
encoder's ``enc_layers``), whose parameter names are the same paths
joined by dots (``attn.wq.w``, ``attn.q_norm.scale``, ``cross.wk.w``,
``ssm.A_log``, ``moe.router.w``, ``moe.gate``, ...).  Layer ``r * len(block_pattern) + j`` is repetition
``r`` of position ``j``.

* :func:`reference_tree` reads a model back into that layout (on the
  meta device it gives the shapes alone);
* :func:`params_from_reference` builds a model holding a tree's weights;
* :func:`numpy_params` makes such a tree from ``numpy.random
  .default_rng(seed)``, every leaf random at an init-like scale, so that
  a leaf carried to the wrong place shows; the tests and the datum
  script feed the same tree to both packages;
* :func:`device_fill` draws the same leaf rules straight into a model's
  parameters on its own device (for full-width runs on the card, where
  a host fill would take minutes);
* :func:`stack_layers` / :func:`unstack_layers` move any per-parameter
  tree (the model's weights, the optimizer's moments) between the two
  layouts, and :func:`opt_state_to_reference` /
  :func:`opt_state_from_reference` carry the optimizer state:
  ``{"m", "v", "step"}`` and, when compressing, ``"err"``, which the
  port keeps in the reference's stacked layout (``launch.steps``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import (ENC_PATTERN, ModelConfig,
                                            Transformer)


def _nest(items) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, val in items:
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = val
    return out


# (reference key, the port's module list) of each stacked layer group
STACKS = (("blocks", "layers"), ("enc_blocks", "enc_layers"))


def _stack_shape(cfg: ModelConfig, key: str):
    """(block pattern, repetitions) of the stack under ``key``."""
    if key == "blocks":
        return cfg.block_pattern, cfg.reps
    return ENC_PATTERN, cfg.n_enc_layers


def reference_path(cfg: ModelConfig, name: str) -> Tuple[str, int]:
    """(the reference's dotted path, the repetition) of the port's
    parameter ``name``: ``layers.<r * len(pattern) + j>.<leaf>`` is
    ``blocks.<j>.<leaf>`` at repetition ``r`` (``enc_layers`` likewise
    under ``enc_blocks``); a top leaf is its own path, repetition -1."""
    mod, _, rest = name.partition(".")
    for key, m in STACKS:
        if mod == m:
            i, leaf = rest.split(".", 1)
            p = len(_stack_shape(cfg, key)[0])
            return f"{key}.{int(i) % p}.{leaf}", int(i) // p
    return name, -1


def stack_layers(cfg: ModelConfig,
                 named: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A tree keyed by the model's parameter names (``layers.<i>.<leaf>``,
    ``enc_layers.<i>.<leaf>`` and the top leaves) in the reference's
    stacked layout."""
    mods = tuple(f"{mod}." for _, mod in STACKS)
    tree = _nest((n, t) for n, t in named.items() if not n.startswith(mods))
    for key, mod in STACKS:
        if key == "enc_blocks" and not cfg.is_enc_dec:
            continue
        pattern, reps = _stack_shape(cfg, key)
        p = len(pattern)
        tree[key] = []
        for j in range(p):
            leaves = [n.split(".", 2)[2] for n in named
                      if n.startswith(f"{mod}.{j}.")]
            tree[key].append(_nest(
                (leaf, torch.stack([named[f"{mod}.{r * p + j}.{leaf}"]
                                    for r in range(reps)]))
                for leaf in leaves))
    return tree


def _tensor(arr) -> torch.Tensor:
    """A tensor of ``arr`` (copied only if it is a read-only array)."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.require(arr, requirements="W"))


def unstack_layers(cfg: ModelConfig,
                   tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`stack_layers`; leaves may be numpy arrays
    (of dtypes torch has) or tensors, and come back as tensors."""
    mods = dict(STACKS)
    out: Dict[str, torch.Tensor] = {}
    for name, arr in _leaves(tree).items():
        t = _tensor(arr)
        key, _, rest = name.partition(".")
        if key not in mods:
            out[name] = t
            continue
        j, leaf = rest.split(".", 1)
        pattern, reps = _stack_shape(cfg, key)
        for r in range(reps):
            out[f"{mods[key]}.{r * len(pattern) + int(j)}.{leaf}"] = t[r]
    return out


def reference_tree(model: Transformer) -> Dict[str, Any]:
    """The model's weights in the reference's stacked layout."""
    return stack_layers(model.cfg, dict(model.named_parameters()))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def opt_state_to_reference(cfg: ModelConfig,
                           state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's optimizer state as the reference's (numpy, stacked):
    ``m`` and ``v`` restacked, ``step`` and ``err`` (already stacked)
    as they are.  Leaves must have numpy dtypes (f32 moments, int32
    step; ``err`` in the gradients' dtype)."""
    out = {"m": _numpy(stack_layers(cfg, state["m"])),
           "v": _numpy(stack_layers(cfg, state["v"])),
           "step": _numpy(state["step"])}
    if "err" in state:
        out["err"] = _numpy(state["err"])
    return out


def opt_state_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                             device=None) -> Dict[str, Any]:
    """The reference's optimizer state (numpy or tensors, stacked) as the
    port's, on ``device``."""
    dev = resolve_device(device)
    on = lambda t: _tensor(t).to(dev)
    state = {k: {n: on(t) for n, t in unstack_layers(cfg, tree[k]).items()}
             for k in ("m", "v")}
    state["step"] = on(tree["step"])
    if "err" in tree:
        state["err"] = _map_tree(tree["err"], lambda _, t: on(t))
    return state


def _map_dict(d: Dict[str, Any], fn: Callable[[str, Any], Any],
              prefix: str) -> Dict[str, Any]:
    return {k: (_map_dict(v, fn, f"{prefix}{k}.") if isinstance(v, dict)
                else fn(f"{prefix}{k}", v)) for k, v in d.items()}


def _map_tree(tree: Dict[str, Any],
              fn: Callable[[str, Any], Any]) -> Dict[str, Any]:
    """``fn(name, leaf)`` over a reference tree, in layout order (the top
    leaves, then ``blocks``, then ``enc_blocks``); names are dotted
    paths, with ``blocks.<j>.`` before a block's leaves."""
    keys = [k for k, _ in STACKS]
    out = _map_dict({k: v for k, v in tree.items() if k not in keys}, fn,
                    "")
    for key in keys:
        if key in tree:
            out[key] = [_map_dict(blk, fn, f"{key}.{j}.")
                        for j, blk in enumerate(tree[key])]
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
    with torch.no_grad():
        for name, t in unstack_layers(cfg, tree).items():
            model.get_parameter(name).copy_(t)
    return model


# Leaves drawn as normals at 1/sqrt(d_in), d_in = shape[-2]: a linear
# layer's "w" (the MoE router's too) and the stacked expert weights, the
# reference's init_moe scales (1/sqrt(d) for gate and up, 1/sqrt(f) for
# down).
_FAN_IN = ("w", "gate", "up", "down")
# Standard deviations of the other normal leaves.  The
# conv taps and bias take 0.3, about PyTorch's Conv1d default (uniform
# within 1/sqrt(4), std 0.29): at the reference's 0.1 the conv output is
# so small that the SSD scan barely moves mamba2's logits, and a check
# of the logits would not see the scan.
_NORMAL_STD = {"table": 0.02, "scale": 0.1, "conv_w": 0.3, "conv_b": 0.3}


def _init_leaf(rng: np.random.Generator, name: str,
               shape: Tuple[int, ...]) -> np.ndarray:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _FAN_IN or leaf in _NORMAL_STD:
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= ((1.0 / np.sqrt(shape[-2])) if leaf in _FAN_IN
              else _NORMAL_STD[leaf])
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


@torch.no_grad()
def device_fill(model: Transformer, seed: int) -> Transformer:
    """Fill ``model``'s parameters in place on their own device, by the
    leaf rules of :func:`numpy_params` (normals at the same scales, the
    SSD leaves' uniform draws mapped the same way), drawn from a
    ``torch.Generator`` seeded with ``seed``, in the parameters' dtype.

    The numbers differ from ``numpy_params``'s: use it for timing and
    launch counts at full width, never against a datum made from
    ``numpy_params``.
    """
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, t in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _FAN_IN or leaf in _NORMAL_STD:
            std = (1.0 / np.sqrt(t.shape[-2]) if leaf in _FAN_IN
                   else _NORMAL_STD[leaf])
            t.normal_(0.0, float(std), generator=gen)
            continue
        u = torch.rand(t.shape, generator=gen, device=dev)
        if leaf == "A_log":
            t.copy_(torch.log1p(15.0 * u))
        elif leaf == "D":
            t.copy_(0.5 + u)
        elif leaf == "dt_bias":
            lo, hi = np.log(1e-3), np.log(0.1)
            dt = torch.exp(lo + u * (hi - lo))
            t.copy_(dt + torch.log(-torch.expm1(-dt)))
        else:
            raise ValueError(f"no init rule for leaf {name}")
    return model
