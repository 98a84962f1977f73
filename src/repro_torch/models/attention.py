"""Grouped-query self-attention with RoPE and a ring KV cache (port of
``repro.models.attention``, the parts the serving slice runs).

Prefill (``cache`` given, ``S > 1``) and the training-mode forward
(``cache=None``) attend causally over the fresh K/V; with no softcap,
prefix or window that is exactly the ``flash_attention`` contract once
query head ``h`` reads KV head ``h // g`` (the reference's
``qg.reshape(b, s, n_kv, g, hd)`` grouping), so those calls go to the
flash wrapper (ROADMAP Fault F6: no JAX code path makes this call).
Decode (``S == 1``) attends over the ring cache with ``_sdpa``, plain
torch, as the reference does outside any kernel.

Unlike the reference, the ring write updates the cache tensors in place
(the decode loop owns its cache; this saves a copy of every layer's
cache per step) and returns a ``KVCache`` with the new length.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import Linear, apply_rope


class KVCache(NamedTuple):
    """Preallocated decode cache for one attention layer (ring buffer)."""

    k: torch.Tensor       # (B, S_alloc, Hkv, Dh)
    v: torch.Tensor       # (B, S_alloc, Hkv, Dh)
    pos: torch.Tensor     # (S_alloc,) int32 — absolute position, -1 empty
    length: torch.Tensor  # () int32 — total tokens seen so far


def init_kv_cache(batch: int, alloc: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, alloc, n_kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, alloc, n_kv_heads, head_dim), dtype=dtype,
                      device=device),
        pos=torch.full((alloc,), -1, dtype=torch.int32, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def make_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """(S, T) causal attend-mask from absolute positions (-1 k = empty):
    the reference's ``make_mask`` with ``causal=True`` and no window or
    prefix, the only form this slice runs."""
    return (k_pos[None, :] <= q_pos[:, None]) & (k_pos >= 0)[None, :]


def _sdpa(q, k, v, *, mask) -> torch.Tensor:
    """q: (B,S,Hkv,G,D)  k/v: (B,T,Hkv,D)  mask: (S,T)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshgd,bthd->bhgst", q.float(), k.float()) * scale
    logits = logits.masked_fill(~mask[None, None, None],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.to(v.dtype)


class Attention(nn.Module):
    """Self-attention: ``wq``/``wk``/``wv``/``wo`` as in the reference."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, *, rope_theta: float = 10_000.0, dtype,
                 device=None):
        super().__init__()
        self.n_heads, self.n_kv_heads = n_heads, n_kv_heads
        self.head_dim, self.rope_theta = head_dim, rope_theta
        self.wq = Linear(d_model, n_heads * head_dim, dtype, device)
        self.wk = Linear(d_model, n_kv_heads * head_dim, dtype, device)
        self.wv = Linear(d_model, n_kv_heads * head_dim, dtype, device)
        self.wo = Linear(n_heads * head_dim, d_model, dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[KVCache] = None):
        """Causal self-attention; ``(y, new_cache)`` (``None`` without a
        cache).  ``positions``: (S,) absolute positions of the tokens."""
        h, hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        g = h // hkv
        b, s = x.shape[0], x.shape[1]
        q = apply_rope(self.wq(x).view(b, s, h, hd), positions,
                       self.rope_theta)
        k = apply_rope(self.wk(x).view(b, s, hkv, hd), positions,
                       self.rope_theta)
        v = self.wv(x).view(b, s, hkv, hd)

        new_cache = None
        if cache is not None:
            alloc = cache.k.shape[1]
            # ring write; when the update is longer than the ring, only
            # the last `alloc` tokens survive.
            kw, vw, posw, start, n_w = k, v, positions, cache.length, s
            if s > alloc:
                kw, vw, posw = k[:, -alloc:], v[:, -alloc:], positions[-alloc:]
                start, n_w = cache.length + (s - alloc), alloc
            slots = ((start + torch.arange(n_w, device=x.device)) % alloc
                     ).long()
            cache.k[:, slots] = kw.to(cache.k.dtype)
            cache.v[:, slots] = vw.to(cache.v.dtype)
            cache.pos[slots] = posw.to(torch.int32)
            new_cache = KVCache(cache.k, cache.v, cache.pos,
                                cache.length + s)
        if cache is not None and s == 1:
            out = _sdpa(q.view(b, s, hkv, g, hd), cache.k, cache.v,
                        mask=make_mask(positions, cache.pos))
        else:
            # prefill / training: causal over the fresh K/V (early queries
            # need keys the ring may already have evicted)
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True)
            out = out.transpose(1, 2)
        return self.wo(out.reshape(b, s, h * hd)), new_cache
