"""Fan-out fabric layer: leaf switches sharing one spine (torch port of
``repro.core.engine.fabric``).

A :class:`~repro_torch.core.params.FabricTopology` lowers onto the chain
machinery (``engine.chain``): the leaves *partition the hop-1 slot
axis* (leaf ``i`` owns the contiguous slot window starting at
``sc["leaf_base"][i]``), and the spine is deep-hop row 0 — its
occupancy-serialized ``hpbc`` FIFO is the fan-in contention point,
because drains from every leaf serialize through it.

Everything here is a mask/index helper over the config's lowered
``n_leaves`` / ``leaf_of_t`` / ``leaf_base`` / ``bp_high``
(``state.scalars_from_config``):

* ``slot_leaf`` maps each hop-1 slot to its owning leaf from the base
  vector (non-fabric configs lower ``leaf_base = [0, INF, ...]``, so
  every slot maps to leaf 0);
* ``leaf_mask`` scopes hop-1 lookup/alloc/victim/drain to the issuing
  tenant's leaf window; the ``n_leaves < 2`` bypass restores the global
  hop-1 behaviour exactly for chain cells sharing the grid;
* ``spine_live`` is the spine PB's Dirty occupancy — the backpressure
  signal ``params.spine_defer`` compares against ``bp_high``.

The per-leaf PBC clocks live in ``MachineState.lpbc`` (shape ``(NL,)``
with NL = the grid's ``n_leaves_max`` when > 1, else 0); ``NL == 0``
skips every fabric branch.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine.state import DIRTY


def has_fabric(st) -> bool:
    """Does this *grid* carry the fabric axis at all?"""
    return st.lpbc.shape[0] > 0


def leaf_of_tenant(sc, tenant):
    """Leaf id of the issuing tenant (0 for non-fabric configs)."""
    return sc["leaf_of_t"][tenant].to(torch.int32)


def slot_leaf(sc, slot_ids):
    """Owning leaf of each hop-1 slot, from the base vector.

    ``leaf_base`` is cumulative capacity offsets padded with INF past
    the config's leaf count, so the count of bases at-or-below a slot id
    minus one is its leaf.
    """
    nl = sc["leaf_base"].shape[0]
    below = slot_ids[:, None] >= sc["leaf_base"][None, :]
    lf = below.sum(1).to(torch.int32) - 1
    return torch.clamp(lf, 0, nl - 1)


def leaf_mask(sc, sl, my_leaf):
    """Hop-1 slot mask scoping a tenant's PB operations to its leaf
    (``sl`` is :func:`slot_leaf`'s output); ``n_leaves < 2`` keeps the
    global hop-1 window."""
    return (sl == my_leaf) | (sc["n_leaves"] < 2.0)


def spine_live(sc, dstate_row, slot_ids):
    """Spine PB Dirty occupancy (entries, f64) inside the spine's real
    capacity ``deep_pbe[0]``: the backpressure signal."""
    live = (slot_ids < sc["deep_pbe"][0]) & (dstate_row == DIRTY)
    return live.to(torch.float64).sum()
