"""Mixture-of-Experts feed-forward with top-k dispatch (port of
``repro.models.moe``).

:func:`moe_ffn` and :func:`_moe_group` give the reference's functions'
outputs in plain torch on tensors; :class:`MoE` holds the leaves under
the reference's names (``router.w``, an f32 ``(d, e)`` even in a bf16
model; ``gate`` and ``up`` ``(e, d, f)``; ``down`` ``(e, f, d)``).

* Routing: an f32 softmax over the router's logits, then ``top_k``
  rounds of ``argmax`` (the first maximal index, as ``jnp.argmax``),
  each masking the chosen expert out (a ``scatter`` of the zero that the
  reference's ``1 - one_hot`` product makes); the gates gathered from
  the probabilities in one call.
* Dispatch by index (:func:`_dispatch`): one stable sort of the
  assignments' experts in the reference's (round, token) order, and
  each expert's count.  An assignment's position within its expert
  (:func:`_positions`) is its rank in the sorted order less its
  expert's offset: the reference's cumsum position, exactly.
* ``drop=True`` (training): an expert holds ``cap = max(int(
  capacity_factor * k * n / e), 1)`` assignments in a ``(e * cap + 1,
  d)`` buffer; one past that goes to the pad slot and is dropped.
* ``drop=False`` (serving: the caller passes ``drop=cache is None``)
  drops nothing, so routing is independent of the batch and decode
  equals teacher forcing.  The reference gives each expert a buffer as
  long as the token group (``cap = n``), ``e / k`` times the routed
  rows, all but those zeros; here the routed rows alone, in sorted
  order, go through each expert with at least one row, over its
  contiguous slice (:func:`_ragged_experts`): gate and up write into
  one f32 buffer each, the activation runs once over all rows, down
  writes into the output.  The counts reach the host once per routing
  group: one copy of ``e`` integers.
* The expert products run in the model dtype with an f32 result (the
  reference's ``preferred_element_type=f32``); ``silu(hg) * hu`` in f32,
  cast to the model dtype before ``down``.  The reference computes them
  outside any Pallas kernel, so they stay library products here (F6).
* Combine: each assignment's output weighted by its gate (0 when
  dropped), summed per token in f32, cast to the input dtype.
* The Switch load-balance loss ``e * sum(me * pe)``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear


def _product_f32(a, b, out=None):
    """``a @ b`` in the operands' dtype with an f32 result, into ``out``
    where given: batched (3-D operands, ``torch.bmm``) or not (2-D,
    ``torch.mm``).  A bf16 product takes ``out_dtype``, which the CPU
    build of torch lacks (``aten::bmm.dtype``, ``aten::mm.dtype``): bf16
    experts run on the card."""
    mm = torch.bmm if a.dim() == 3 else torch.mm
    kw = {} if out is None else {"out": out}
    if a.dtype == torch.float32:
        return mm(a, b, **kw)
    return mm(a, b, out_dtype=torch.float32, **kw)


class _BmmF32(torch.autograd.Function):
    """:func:`_product_f32` and its gradient.  Autograd has no formula for
    the ``out_dtype`` overload, so the backward is written out.

    It is what ``jax.grad`` makes of the reference's ``einsum(...,
    preferred_element_type=f32)``: the f32 cotangent times the other
    operand upcast to f32, an f32 product, each gradient cast to its
    operand's dtype (bf16 gradients for bf16 operands).  For f32
    operands these are autograd's own products for ``torch.bmm`` and
    ``torch.mm``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        mm = torch.bmm if a.dim() == 3 else torch.mm
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = mm(g, b.float().transpose(-2, -1)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = mm(a.float().transpose(-2, -1), g).to(b.dtype)
        return ga, gb


def _bmm_f32(a, b, out=None):
    """Every expert product: :class:`_BmmF32` where a gradient is wanted
    (its result copied into ``out``, a slice, where given), else
    :func:`_product_f32` alone, which writes ``out`` itself."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        y = _BmmF32.apply(a, b)
        return y if out is None else out.copy_(y)
    return _product_f32(a, b, out)


def moe_ffn(p: Dict[str, Any], x: torch.Tensor, *, top_k: int = 2,
            capacity_factor: float = 1.25, drop: bool = True,
            groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss).  x: (B, S, d); ``p`` is the reference's
    leaf tree: ``{"router": {"w"}, "gate", "up", "down"}``.

    ``groups`` > 1 (with ``B * S`` a multiple of it) routes that many
    equal token groups independently, each with its own capacity, and
    averages their aux losses.
    """
    b, s, d = x.shape
    n_total = b * s
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, drop=drop)
    if groups > 1 and n_total % groups == 0:
        outs = [_moe_group(p, xi, **kw)
                for xi in x.reshape(groups, n_total // groups, d)]
        y = torch.stack([o[0] for o in outs])
        return y.reshape(b, s, d), torch.stack([o[1] for o in outs]).mean()
    y, aux = _moe_group(p, x.reshape(n_total, d), **kw)
    return y.reshape(b, s, d), aux


def _dispatch(expert_flat: torch.Tensor, e: int):
    """(order, counts) of the assignments ``expert_flat`` (``(n * k,)``,
    in the reference's (round, token) order): ``order`` sorts them by
    expert, stably; ``counts`` (int64, ``(e,)``) is each expert's number
    of assignments."""
    order = torch.sort(expert_flat, stable=True).indices
    counts = torch.zeros(e, dtype=torch.long,
                         device=expert_flat.device).index_add_(
        0, expert_flat, torch.ones_like(expert_flat))
    return order, counts


def _positions(expert_flat: torch.Tensor, order: torch.Tensor,
               counts: torch.Tensor) -> torch.Tensor:
    """Each assignment's position within its expert: its rank in
    ``order`` less its expert's offset (the counts' exclusive cumsum).
    Integers throughout, so this equals the reference's cumsum over the
    ``(n * k, e)`` one-hot exactly."""
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(order.shape[0], device=order.device)
    return torch.empty_like(order).scatter_(
        0, order, rank - offsets[expert_flat[order]])


def _ragged_experts(p: Dict[str, Any], xs: torch.Tensor,
                    counts: torch.Tensor) -> torch.Tensor:
    """The expert FFN over the routed rows ``xs`` (``(n * k, d)``, sorted
    by expert; ``counts`` rows each): per expert with at least one row,
    ``gate`` and ``up`` over its contiguous slice, written into one f32
    buffer each; ``silu(hg) * hu`` once over all rows; then ``down`` per
    expert into the f32 output.  An expert with no row is skipped and
    its weights are not read.  Returns ``(n * k, d)`` in f32, in
    ``xs``'s order.

    The counts reach the host (one sync).  A meta tensor has none: there
    each expert takes ``ceil(n * k / e)`` rows, the last ones fewer so
    that they sum to ``n * k`` (shapes only, as the kernel wrappers'
    meta arm)."""
    rows, e = xs.shape[0], counts.shape[0]
    if xs.device.type == "meta":
        per = -(-rows // e)
        sizes = [min(per, max(rows - j * per, 0)) for j in range(e)]
    else:
        sizes = counts.tolist()
    # each expert with a row and its rows; at decode most experts have
    # none, and every view and launch is host time on a host-bound step
    spans, start = [], 0
    for j, m in enumerate(sizes):
        if m:
            spans.append((j, slice(start, start + m)))
            start += m
    hg = xs.new_empty((rows, p["gate"].shape[-1]), dtype=torch.float32)
    hu = torch.empty_like(hg)
    for j, r in spans:
        xj = xs[r]
        _bmm_f32(xj, p["gate"][j], hg[r])
        _bmm_f32(xj, p["up"][j], hu[r])
    h = (F.silu(hg) * hu).to(xs.dtype)
    ye = xs.new_empty(xs.shape, dtype=torch.float32)
    for j, r in spans:
        _bmm_f32(h[r], p["down"][j], ye[r])
    return ye


def _moe_group(p: Dict[str, Any], xt: torch.Tensor, *, top_k: int,
               capacity_factor: float, drop: bool):
    """Route one token group.  xt: (n, d)."""
    n, d = xt.shape
    e = p["router"]["w"].shape[1]
    dev = xt.device
    probs = torch.softmax(xt.float() @ p["router"]["w"], dim=-1)

    # top-k by rounds of argmax (the first maximal index), each masking its
    # choice: scatter writes the +0 that remaining * (1 - one_hot) makes
    # of a probability, and leaves the others as they are
    idxs, remaining = [], probs
    for r in range(top_k):
        idxs.append(torch.argmax(remaining, dim=-1))           # (n,)
        if r + 1 < top_k:
            remaining = remaining.scatter(1, idxs[-1][:, None], 0.0)

    # index dispatch, in the reference's (round, token) order
    chosen = torch.stack(idxs)                                # (k, n)
    expert_flat = chosen.reshape(-1)                          # (n*k,)
    gate_flat = torch.gather(probs.t(), 0, chosen).reshape(-1)
    order, counts = _dispatch(expert_flat, e)

    # With top_k = 2 every token sums two terms onto a zero, and a sum of
    # two floats does not depend on their order, so neither the sorted
    # order nor index_add's atomic order on the card changes the result.
    if not drop:
        tok = order % n                    # assignment i is token i mod n
        ye = _ragged_experts(p, xt[tok], counts)              # (n*k, d)
        y = torch.zeros((n, d), dtype=torch.float32, device=dev).index_add_(
            0, tok, ye * gate_flat[order][:, None])
    else:
        token_flat = torch.arange(n, device=dev).repeat(top_k)
        cap = max(int(capacity_factor * top_k * n / e), 1)
        pos = _positions(expert_flat, order, counts)
        keep = pos < cap
        buf = torch.where(keep, expert_flat * cap + pos, e * cap)

        # scatter into the (e*cap + pad, d) buffer; only the pad slot
        # takes more than one row, and it is cut off
        xe = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=dev)
        xe = xe.index_put((buf,), xt[token_flat])[:-1].reshape(e, cap, d)

        # expert FFN in the model dtype with f32 results
        hg = _bmm_f32(xe, p["gate"])
        hu = _bmm_f32(xe, p["up"])
        h = (F.silu(hg) * hu).to(xt.dtype)
        ye = _bmm_f32(h, p["down"])                           # (e, cap, d)

        # combine: gather each assignment's output, weighted by its gate
        ye_pad = torch.cat([ye.reshape(e * cap, d),
                            torch.zeros((1, d), dtype=ye.dtype, device=dev)])
        contrib = ye_pad[buf] * (gate_flat * keep)[:, None]  # (n*k, d)
        y = torch.zeros((n, d), dtype=torch.float32,
                        device=dev).index_add(0, token_flat, contrib)

    # load-balancing auxiliary loss (Switch-style); the counts are exact
    # integers in f32, the reference's sum of ones
    me = counts.float() / (n * top_k)
    pe = probs.mean(dim=0)                                    # router mass
    aux = e * torch.sum(me * pe)
    return y.to(xt.dtype), aux


class MoE(nn.Module):
    """The expert FFN's leaves: ``router.w`` (f32), ``gate``, ``up`` and
    ``down`` stacked per expert, in the model dtype."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, dtype,
                 device=None):
        super().__init__()
        self.router = Linear(d_model, n_experts, torch.float32, device)

        def experts(*shape):
            return nn.Parameter(torch.zeros((n_experts,) + shape,
                                            dtype=dtype, device=device),
                                requires_grad=False)
        self.gate = experts(d_model, d_ff)
        self.up = experts(d_model, d_ff)
        self.down = experts(d_ff, d_model)

    def forward(self, x: torch.Tensor, **kw):
        p = {"router": {"w": self.router.w}, "gate": self.gate,
             "up": self.up, "down": self.down}
        return moe_ffn(p, x, **kw)
