"""Mixture-of-Experts feed-forward with capacity-based top-k dispatch (port
of ``repro.models.moe``).

:func:`moe_ffn` and :func:`_moe_group` are the reference's functions in
plain torch on tensors, step by step; :class:`MoE` holds the leaves under
the reference's names (``router.w``, an f32 ``(d, e)`` even in a bf16
model; ``gate`` and ``up`` ``(e, d, f)``; ``down`` ``(e, f, d)``).

* Routing: an f32 softmax over the router's logits, then ``top_k``
  rounds of ``argmax`` (the first maximal index, as ``jnp.argmax``),
  each masking the chosen expert out by ``1 - one_hot``.
* Dispatch by index: each assignment's position within its expert comes
  from a cumsum over the ``(n * k, e)`` one-hot in (round, token) order;
  an expert holds ``cap`` assignments (``n`` with ``drop=False``, else
  ``max(int(capacity_factor * k * n / e), 1)``) and one past that goes
  to a pad slot, which is dropped.
* The expert products run in the model dtype with an f32 result (the
  reference's ``preferred_element_type=f32``); ``silu(hg) * hu`` in f32,
  cast to the model dtype before ``down``.  The reference computes them
  outside any Pallas kernel, so they stay library products here (F6).
* Combine: each assignment's output weighted by its gate (0 when
  dropped), summed per token in f32, cast to the input dtype.
* The Switch load-balance loss ``e * sum(me * pe)``.

``drop=False`` (serving: the caller passes ``drop=cache is None``) makes
routing independent of the batch, so decode equals teacher forcing; the
price is an expert buffer as long as the whole token group, ``e / k``
times the routed rows (ROADMAP: ragged dispatch).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear


class _BmmF32(torch.autograd.Function):
    """Batched ``a @ b`` in the operands' dtype with an f32 result, and
    its gradient.  A bf16 product takes ``out_dtype``, which the CPU
    build of torch lacks (``aten::bmm.dtype``): bf16 experts run on the
    card.  Autograd has no formula for that overload, so the backward is
    written out.

    It is what ``jax.grad`` makes of the reference's ``einsum(...,
    preferred_element_type=f32)``: the f32 cotangent times the other
    operand upcast to f32, an f32 product, each gradient cast to its
    operand's dtype (bf16 gradients for bf16 operands).  For f32
    operands these are autograd's own products for ``torch.bmm``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.dtype == torch.float32:
            return torch.bmm(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = g.bmm(b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = a.float().transpose(1, 2).bmm(g).to(b.dtype)
        return ga, gb


_bmm_f32 = _BmmF32.apply


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


def _moe_group(p: Dict[str, Any], xt: torch.Tensor, *, top_k: int,
               capacity_factor: float, drop: bool):
    """Route one token group.  xt: (n, d)."""
    n, d = xt.shape
    e = p["router"]["w"].shape[1]
    dev = xt.device
    cap = n if not drop else max(int(capacity_factor * top_k * n / e), 1)
    probs = torch.softmax(xt.float() @ p["router"]["w"], dim=-1)

    # top-k assignment (expert ids + gate weights per round)
    idxs, gvals = [], []
    remaining = probs
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                 # (n,)
        idxs.append(idx)
        gvals.append(torch.gather(probs, 1, idx[:, None])[:, 0])
        remaining = remaining * (1.0 - F.one_hot(idx, e).to(remaining.dtype))

    # index dispatch, in the reference's (round, token) order
    expert_flat = torch.cat(idxs)                             # (n*k,)
    gate_flat = torch.cat(gvals)                              # (n*k,)
    token_flat = torch.arange(n, device=dev).repeat(top_k)
    onehot_pos = (expert_flat[:, None]
                  == torch.arange(e, device=dev)[None, :]).long()
    pos = (torch.cumsum(onehot_pos, dim=0) - onehot_pos)[
        torch.arange(n * top_k, device=dev), expert_flat]    # (n*k,)
    keep = pos < cap
    buf = torch.where(keep, expert_flat * cap + pos, e * cap)

    # scatter into the (e*cap + pad, d) buffer; only the pad slot takes
    # more than one row, and it is cut off
    xe = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=dev)
    xe = xe.index_put((buf,), xt[token_flat])[:-1].reshape(e, cap, d)

    # expert FFN in the model dtype with f32 results
    hg = _bmm_f32(xe, p["gate"])
    hu = _bmm_f32(xe, p["up"])
    h = (F.silu(hg) * hu).to(xt.dtype)
    ye = _bmm_f32(h, p["down"])                               # (e, cap, d)

    # combine: gather each assignment's output and weight it by its gate.
    # With top_k = 2 every token sums two terms onto a zero, and a sum of
    # two floats does not depend on their order, so index_add's atomic
    # order on the card cannot change the result.
    ye_pad = torch.cat([ye.reshape(e * cap, d),
                        torch.zeros((1, d), dtype=ye.dtype, device=dev)])
    contrib = ye_pad[buf] * (gate_flat * keep)[:, None]      # (n*k, d)
    y = torch.zeros((n, d), dtype=torch.float32,
                    device=dev).index_add(0, token_flat, contrib)

    # load-balancing auxiliary loss (Switch-style)
    me = torch.zeros(e, dtype=torch.float32, device=dev).index_add(
        0, expert_flat, torch.ones(n * top_k, device=dev)) / (n * top_k)
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
