"""Mamba2 SSD mixer (port of ``repro.models.ssm``).

The SSD scan takes one of two routes, fixed by the call's contract (as
``Attention.kernel`` fixes attention's), never by trying:

* **prefill and the no-grad forward** run the chunked scan through the
  ``ssd_scan`` wrapper (the CUDA kernel on the card, its plain version
  ``kernels.ref.ssd_scan_ref`` on the CPU), seeded from the cached state
  when one is threaded through;
* **a forward that records gradients** (no cache, an input of the scan
  requiring grad) runs ``ssd_chunked``, the reference model's own
  chunked SSD math in plain torch with autograd: the kernel's plain
  version ``kernels.ref.ssd_scan_ref`` under the reference's name.  The
  kernel has no backward, and its wrapper refuses inputs that require
  grad.

Decode runs the one-token recurrence ``ssd_decode_step`` in plain torch,
as the reference does outside any kernel.  The projections, the
depthwise causal conv and the gate stay plain torch.

Decode keeps O(1) per-token state: ``state: (B, H, P, N)`` plus a
depthwise-conv ring of the last ``K - 1`` inputs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ref import ssd_scan_ref as ssd_chunked
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import Linear


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, K-1, conv_dim) ring of last K-1 inputs
    state: torch.Tensor  # (B, H, P, N) SSD recurrent state (f32)


def init_ssm_cache(batch: int, d_model: int, *, d_state: int = 128,
                   expand: int = 2, head_dim: int = 64, conv_kernel: int = 4,
                   dtype=torch.bfloat16, device=None) -> SSMCache:
    d_inner = expand * d_model
    h = d_inner // head_dim
    return SSMCache(
        conv=torch.zeros((batch, conv_kernel - 1, d_inner + 2 * d_state),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, h, head_dim, d_state),
                          dtype=torch.float32, device=device),
    )


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 carry: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B,S,C), w: (K,C).  Returns (y, carry).

    The taps are summed in the reference's order and dtype (``sum`` of
    ``xp[:, i:i+S] * w[i]``)."""
    k = w.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([carry, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    y = y + b.to(y.dtype)
    return y, xp[:, -(k - 1):]


def ssd_decode_step(x, dt, A, B, C, state):
    """One-token recurrence.  x:(B,H,P) dt:(B,H) B/C:(B,N) state:(B,H,P,N)."""
    x, dt, B, C = (t.float() for t in (x, dt, B, C))
    decay = torch.exp(dt * A[None, :])                     # (B,H)
    new_state = (state * decay[..., None, None]
                 + torch.einsum("bh,bhp,bn->bhpn", dt, x, B))
    y = torch.einsum("bn,bhpn->bhp", C, new_state)
    return y, new_state


class SSDBlock(nn.Module):
    """Mamba2 block: in_proj -> conv -> SSD -> gate -> out_proj, with the
    reference's leaves (``in_proj``, ``conv_w``, ``conv_b``, ``A_log``,
    ``D``, ``dt_bias``, ``out_proj``)."""

    def __init__(self, d_model: int, *, d_state: int = 128, expand: int = 2,
                 head_dim: int = 64, conv_kernel: int = 4, chunk: int = 128,
                 dtype, device=None):
        super().__init__()
        d_inner = expand * d_model
        n_heads = d_inner // head_dim
        conv_dim = d_inner + 2 * d_state
        self.d_inner, self.d_state = d_inner, d_state
        self.head_dim, self.chunk = head_dim, chunk

        def f32(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                            device=device),
                                requires_grad=False)
        # fused input projection: [z (gate), x, B, C, dt]
        self.in_proj = Linear(d_model, 2 * d_inner + 2 * d_state + n_heads,
                              dtype, device)
        self.conv_w = nn.Parameter(
            torch.zeros((conv_kernel, conv_dim), dtype=dtype, device=device),
            requires_grad=False)
        self.conv_b = f32(conv_dim)
        self.A_log = f32(n_heads)
        self.D = f32(n_heads)
        self.dt_bias = f32(n_heads)
        self.out_proj = Linear(d_inner, d_model, dtype, device)

    def forward(self, x: torch.Tensor, cache: Optional[SSMCache] = None):
        """Training/prefill: x (B,S,d).  Decode: x (B,1,d) + cache.  The
        scan's route is the module docstring's."""
        b, s, _ = x.shape
        d_inner, d_state, hd = self.d_inner, self.d_state, self.head_dim
        h = d_inner // hd
        zxbcdt = self.in_proj(x)
        z, xbc, dt_raw = torch.split(
            zxbcdt, [d_inner, d_inner + 2 * d_state, h], dim=-1)

        conv_carry = cache.conv if cache is not None else None
        xbc, new_conv = _causal_conv(xbc, self.conv_w, self.conv_b,
                                     conv_carry)
        xbc = F.silu(xbc)
        xs, B, C = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)

        dt = F.softplus(dt_raw.float() + self.dt_bias)
        A = -torch.exp(self.A_log)
        xh = xs.reshape(b, s, h, hd)

        if cache is not None and s == 1:
            y1, new_state = ssd_decode_step(
                xh[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], cache.state)
            y = y1[:, None].to(x.dtype)
        elif cache is None and any(t.requires_grad for t in (xh, dt, A, B,
                                                             C)):
            y, new_state = ssd_chunked(xh, dt, A, B, C, chunk=self.chunk)
        else:
            y, new_state = ssd_scan(
                xh, dt, A, B, C, chunk=self.chunk,
                init_state=cache.state if cache is not None else None)
        new_cache = SSMCache(conv=new_conv, state=new_state)

        y = y + self.D[None, None, :, None] * xh.float()
        y = y.reshape(b, s, d_inner).to(x.dtype)
        y = y * F.silu(z)
        return self.out_proj(y), new_cache
