"""Sharding rules: FSDP over 'data', tensor-parallel over 'model' (port of
``repro.launch.sharding``), as placements on a torch ``DeviceMesh``.

Rules are name-based over the parameters and divisibility-aware: an axis
is only sharded when its size divides the mesh axis, otherwise it falls
back to replication (e.g. seamless' vocab of 256206 is not 16-divisible,
so its embedding shards d_model instead).

KV caches shard their *sequence* dimension over 'model' (+'data' for the
single-request long-context shape): the assigned GQA configs have 1-16 KV
heads, which cannot split over a 16-way model axis, while 32k/500k
sequences always can.

A spec is a tuple with one entry per tensor dim, each ``None``, a mesh
axis name or a tuple of axis names, with the reference's
``PartitionSpec`` meaning and axis order (``()`` replicates).  The port's
leaves are per layer (``layers.<i>.attn.wq.w``, ``layers.<i>.moe.gate``,
``embed.table``, ...; an optimizer-state leaf is its parameter's name
after ``m.`` or ``v.``), where the reference's carry a leading ``reps``
dim that is never sharded: a port spec is the reference's with that
entry dropped.  Caches are per layer too: ``(b, s, h, d)`` against the
reference's ``(r, b, s, h, d)``.

The rules read only ``mesh.mesh_dim_names`` and ``mesh.shape``, so a
``DeviceMesh`` or any stand-in with those two does.  :func:`placements`
turns a spec into DTensor placements, one per mesh dim.  Where a dim is
split over several axes, JAX splits it with the first-named axis major;
DTensor applies placements in mesh-dim order, so an axis named after
one that comes later in the mesh takes a ``_StridedShard`` whose split
factor is the size of those later axes: each device then holds the
block the reference's device at the same mesh coordinate holds, not
only a block of the same shape.  :func:`shard_tree`,
:func:`shard_batch` and :func:`shard_caches` return a DTensor per leaf
(its ``placements`` are the leaf's): on the meta device, built from the
local shape alone (nothing moves; the dry-run's use), else through
``distribute_tensor``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import data_axes

Spec = Tuple[Any, ...]

# Perf-iteration knobs.  Defaults = the baseline FSDP('data') x TP('model')
# layout; the dry-run CLI overrides them with --set.
FLAGS = {
    # experts on the model axis (expert parallelism) instead of d_ff TP
    "moe_expert_parallel": False,
    # dense FFN/attn weights pure-TP (replicated over data, no FSDP
    # all-gathers; only viable for small models)
    "dense_pure_tp": False,
    # activation sharding between blocks: 'none' (replicated over model),
    # 'seq' (sequence parallelism: S over 'model'), or 'd' (feature dim
    # over 'model')
    "act_shard": "none",
    # batch (and activations) sharded over BOTH mesh axes: pure-FSDP
    # data parallelism, no tensor parallelism (use with fsdp_same_dim)
    "batch_both": False,
    # stack the FSDP ('data') shards on the SAME dim as TP ('model')
    # instead of the contraction dim
    "fsdp_same_dim": False,
}


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def _ok(mesh, dim_size: int, axis) -> bool:
    return axis is not None and dim_size % _axis_size(mesh, axis) == 0


def _maybe(mesh, dim: int, axis):
    return axis if _ok(mesh, dim, axis) else None


def _entry(axes: tuple):
    """A spec entry for a dim split over ``axes``: one axis by its name,
    as ``PartitionSpec`` keeps it."""
    return axes[0] if len(axes) == 1 else axes


def _names(path: Union[str, Sequence]) -> List[str]:
    return path.split(".") if isinstance(path, str) else [str(n) for n in path]


def param_spec(mesh, path, leaf) -> Spec:
    """The spec of one parameter (or optimizer-state) leaf given its name
    (dotted, or a sequence of keys)."""
    names = _names(path)
    shape = tuple(leaf.shape)
    dp = "data"
    if "embed" in names and "table" in names:
        v, d = shape
        if FLAGS["fsdp_same_dim"] and v % _axis_size(mesh, ("model", dp)) == 0:
            return (("model", dp), None)
        if v % _axis_size(mesh, "model") == 0:
            if FLAGS["fsdp_same_dim"]:
                return ("model", None)
            return (_maybe(mesh, v, "model"), _maybe(mesh, d, dp))
        return (None, _maybe(mesh, d, "model"))
    if len(shape) <= 1:  # norms, biases, A_log, dt_bias, step...
        return (None,) * len(shape)
    if "router" in names:
        return (None,) * len(shape)
    if any(n in names for n in ("gate", "up")) and "moe" in names:
        e, d, f = shape
        if FLAGS["moe_expert_parallel"] and e % _axis_size(mesh, "model") == 0:
            return ("model", _maybe(mesh, d, dp), None)
        if FLAGS["dense_pure_tp"]:
            return (None, None, _maybe(mesh, f, "model"))
        if FLAGS["fsdp_same_dim"]:
            ax = ("model", dp) if f % _axis_size(mesh, ("model", dp)) == 0 \
                else "model"
            return (None, None, _maybe(mesh, f, ax))
        return (None, _maybe(mesh, d, dp), _maybe(mesh, f, "model"))
    if "down" in names and "moe" in names:
        e, f, d = shape
        if FLAGS["moe_expert_parallel"] and e % _axis_size(mesh, "model") == 0:
            return ("model", None, _maybe(mesh, d, dp))
        if FLAGS["dense_pure_tp"]:
            return (None, _maybe(mesh, f, "model"), None)
        if FLAGS["fsdp_same_dim"]:
            ax = ("model", dp) if f % _axis_size(mesh, ("model", dp)) == 0 \
                else "model"
            return (None, _maybe(mesh, f, ax), None)
        return (None, _maybe(mesh, f, "model"), _maybe(mesh, d, dp))
    if "conv_w" in names:
        k, c = shape
        return (None, _maybe(mesh, c, "model"))
    if any(n in names for n in ("wo", "down", "out_proj")):
        a, b = shape
        if FLAGS["dense_pure_tp"]:
            return (_maybe(mesh, a, "model"), None)
        if FLAGS["fsdp_same_dim"]:
            ax = ("model", dp) if a % _axis_size(mesh, ("model", dp)) == 0 \
                else "model"
            return (_maybe(mesh, a, ax), None)
        return (_maybe(mesh, a, "model"), _maybe(mesh, b, dp))
    if len(shape) == 2:
        # wq/wk/wv, ffn gate/up, ssm in_proj: (d_in, d_out)
        a, b = shape
        if FLAGS["dense_pure_tp"]:
            return (None, _maybe(mesh, b, "model"))
        if FLAGS["fsdp_same_dim"]:
            ax = ("model", dp) if b % _axis_size(mesh, ("model", dp)) == 0 \
                else "model"
            return (None, _maybe(mesh, b, ax))
        return (_maybe(mesh, a, dp), _maybe(mesh, b, "model"))
    return (None,) * len(shape)


def batch_axes(mesh) -> tuple:
    dp = data_axes(mesh)
    if FLAGS["batch_both"]:
        return dp + ("model",)
    return dp


def batch_spec(mesh, leaf) -> Spec:
    dp = batch_axes(mesh)
    if leaf.ndim == 0 or leaf.shape[0] % _axis_size(mesh, dp) != 0:
        return (None,) * leaf.ndim
    return (_entry(dp),) + (None,) * (leaf.ndim - 1)


def cache_spec(mesh, path, leaf, batch: int) -> Spec:
    """Decode-cache spec of one per-layer cache leaf (``k``, ``v``,
    ``pos``, ``length``; ``conv``, ``state``), named by its field last."""
    names = _names(path)
    dp = data_axes(mesh)
    shape = tuple(leaf.shape)
    if names and names[-1] in ("k", "v"):
        b, s, h, d = shape
        if batch > 1 and b % _axis_size(mesh, dp) == 0:
            seq_ax = _maybe(mesh, s, "model")
            return (_entry(dp), seq_ax, None, None)
        seq_ax = (("data", "model")
                  if s % _axis_size(mesh, ("data", "model")) == 0 else None)
        return (None, seq_ax, None, None)
    if names and names[-1] == "state":
        b, h, p_, n = shape
        bd = (_entry(dp) if (batch > 1 and b % _axis_size(mesh, dp) == 0)
              else None)
        return (bd, _maybe(mesh, h, "model"), None, None)
    if names and names[-1] == "conv":
        b, k, c = shape
        bd = (_entry(dp) if (batch > 1 and b % _axis_size(mesh, dp) == 0)
              else None)
        return (bd, None, _maybe(mesh, c, "model"))
    return (None,) * len(shape)




# ------------------------------------------------------------ placements
def placements(mesh, spec: Spec) -> list:
    """DTensor placements (one per mesh dim) for ``spec``, in the
    reference's block order (see the module's docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = (entry if isinstance(entry, tuple)
                else () if entry is None else (entry,))
        for t, a in enumerate(axes):
            m = names.index(a)
            if not isinstance(out[m], Replicate):
                raise ValueError(f"spec {spec} names mesh axis {a} twice")
            split = 1
            for b in axes[:t]:
                if names.index(b) > m:
                    split *= _axis_size(mesh, b)
            if split == 1:
                out[m] = Shard(d)
            else:
                from torch.distributed.tensor.placement_types import \
                    _StridedShard
                out[m] = _StridedShard(d, split_factor=split)
    return out


def local_shape(mesh, shape, spec: Spec) -> Tuple[int, ...]:
    """One device's block of a ``shape`` leaf under ``spec`` (every rule
    shards only dims the axes divide)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n if e is None else n // _axis_size(mesh, e)
                 for n, e in zip(shape, spec))


def dtensor(mesh, leaf: torch.Tensor, spec: Spec):
    """``leaf`` as a DTensor on ``mesh`` under ``spec``: a meta leaf from
    its local shape alone, any other through ``distribute_tensor``."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(mesh, spec)
    if leaf.device.type != "meta":
        return distribute_tensor(leaf, mesh, pl)
    local = torch.empty(local_shape(mesh, leaf.shape, spec),
                        dtype=leaf.dtype, device="meta")
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=leaf.shape, stride=leaf.stride())


def _map(fn, tree, prefix: str = ""):
    """``fn(dotted name, leaf)`` over dicts, lists and NamedTuples of
    tensors (a NamedTuple's fields are named)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, f"{prefix}{k}.")
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def shard_tree(mesh, tree):
    """A DTensor for every leaf of a tree of parameters or optimizer
    state (dicts keyed by name; names dotted down the tree)."""
    return _map(lambda name, leaf: dtensor(mesh, leaf,
                                           param_spec(mesh, name, leaf)),
                tree)


def shard_batch(mesh, batch: Dict[str, torch.Tensor]):
    return _map(lambda name, leaf: dtensor(mesh, leaf,
                                           batch_spec(mesh, leaf)), batch)


def shard_caches(mesh, caches, batch: int):
    """A DTensor for every leaf of ``init_caches``' list (one cache a
    layer)."""
    return _map(lambda name, leaf: dtensor(
        mesh, leaf, cache_spec(mesh, name, leaf, batch)), caches)


def replicated(mesh, tree):
    """A replicated DTensor (spec ``()``) for every leaf of ``tree``."""
    return _map(lambda name, leaf: dtensor(mesh, leaf, ()), tree)


def leaves(tree) -> Dict[str, Any]:
    """The leaves of a tree by dotted name."""
    out: Dict[str, Any] = {}
    _map(out.__setitem__, tree)
    return out
