"""Shared building blocks (port of ``repro.models.layers``).

Weights keep the reference's layout: a linear layer holds ``w`` as
``(d_in, d_out)`` and computes ``x @ w``; the embedding table is
``(vocab, d)`` and is tied to the readout.  Norm scales are f32 in the
``(1 + scale)`` form, so a zero scale is the identity.  Each module
holds its tensors under the reference's leaf names (``scale``,
``table``, ``w``), which is what ``models.convert`` maps by.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


# --------------------------------------------------------------------- norm
def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale)).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(
            torch.zeros(d, dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x)


# ---------------------------------------------------------------- embedding
def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied readout: (..., d) @ (vocab, d)^T -> (..., vocab)."""
    return x @ table.t()


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device=None):
        super().__init__()
        self.table = nn.Parameter(
            torch.zeros(vocab, d, dtype=dtype, device=device),
            requires_grad=False)


# ------------------------------------------------------------------- linear
def linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w


class Linear(nn.Module):
    """``x @ w`` with ``w`` of shape ``(d_in, d_out)``, as the reference."""

    def __init__(self, d_in: int, d_out: int, dtype, device=None):
        super().__init__()
        self.w = nn.Parameter(
            torch.zeros(d_in, d_out, dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.w, x)


# ------------------------------------------------------------ gated MLP
class MLP(nn.Module):
    """SwiGLU feed-forward (llama/gemma/mixtral family)."""

    def __init__(self, d: int, d_ff: int, dtype, device=None):
        super().__init__()
        self.gate = Linear(d, d_ff, dtype, device)
        self.up = Linear(d, d_ff, dtype, device)
        self.down = Linear(d_ff, d, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


# --------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, Dh), positions: (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (Dh/2,)
    angles = positions[..., :, None, None].float() * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ softcap
def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """gemma2-style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
