"""Grouped-query attention with RoPE, sliding windows, softcap, qk-norm,
prefix-LM masks, cross-attention and a ring KV cache (port of
``repro.models.attention``).

The route is fixed by the layer's static contract (``Attention.kernel``
and the call's own mask arguments), never by trying the kernel:

* **``flash_attention``** takes prefill (``cache`` given, ``S > 1``) and
  the no-grad forward of a self-attention layer with no softcap and no
  prefix that is causal (with or without a window) or non-causal with no
  window.  Over the fresh K/V that is exactly the kernel's contract once
  query head ``h`` reads KV head ``h // g`` (the reference's
  ``qg.reshape(b, s, n_kv, g, hd)`` grouping).  ROADMAP Fault F6: no JAX
  code path makes this call.
* **``_sdpa``**, the reference's masked softmax in plain torch, takes
  everything else: softcapped layers (gemma2), a prefix-LM prefill
  (paligemma), cross-attention (seamless's decoder), decode (``S == 1``
  over the ring cache), and any call whose queries record gradients (the
  kernel has no backward, and its wrapper refuses inputs that require
  grad).  The Pallas kernel has neither a softcap nor a prefix, so the
  port's has neither.

Sliding-window layers keep a ring of ``min(max_len, window)`` slots
(``transformer.init_caches``); each slot stores its absolute position,
which is what the decode mask reads.  Unlike the reference, the ring
write updates the cache tensors in place (the decode loop owns its
cache; this saves a copy of every layer's cache per step) and returns a
``KVCache`` with the new length.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import Linear, RMSNorm, apply_rope, softcap


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


def make_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
              window: Optional[int], prefix_len=None) -> torch.Tensor:
    """(S, T) boolean attend-mask from absolute positions (-1 k = empty)."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=k_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    if prefix_len is not None:
        m |= k_pos[None, :] < prefix_len
    m &= (k_pos >= 0)[None, :]
    return m


def _sdpa(q, k, v, *, mask, cap: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,Hkv,G,D)  k/v: (B,T,Hkv,D)  mask: (S,T) or None.  The
    softcap goes on the scaled f32 logits before the mask."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshgd,bthd->bhgst", q.float(), k.float()) * scale
    logits = softcap(logits, cap)
    if mask is not None:
        logits = logits.masked_fill(~mask[None, None, None],
                                    torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.to(v.dtype)


class Attention(nn.Module):
    """Self- or cross-attention: ``wq``/``wk``/``wv``/``wo`` and, with
    ``qk_norm``, ``q_norm``/``k_norm`` (gemma-style RMSNorm over the head
    dim, before RoPE), as in the reference.

    ``cap`` is the logit softcap, ``rope_theta`` the layer kind's RoPE
    base.  ``cross`` marks a cross-attention sublayer: it never takes the
    kernel, whether or not its call is given the encoder output.
    """

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, *, rope_theta: float = 10_000.0,
                 cap: Optional[float] = None, qk_norm: bool = False,
                 cross: bool = False, dtype, device=None):
        super().__init__()
        self.n_heads, self.n_kv_heads = n_heads, n_kv_heads
        self.head_dim, self.rope_theta = head_dim, rope_theta
        self.cap, self.cross = cap, cross
        self.wq = Linear(d_model, n_heads * head_dim, dtype, device)
        self.wk = Linear(d_model, n_kv_heads * head_dim, dtype, device)
        self.wv = Linear(d_model, n_kv_heads * head_dim, dtype, device)
        self.wo = Linear(n_heads * head_dim, d_model, dtype, device)
        if qk_norm:
            self.q_norm = RMSNorm(head_dim, device)
            self.k_norm = RMSNorm(head_dim, device)

    def kernel(self, *, causal: bool, window: Optional[int],
               prefix_len) -> bool:
        """Whether a prefill or no-grad forward of this layer with these
        mask arguments is the ``flash_attention`` contract."""
        return (not self.cross and self.cap is None and prefix_len is None
                and (causal or window is None))

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[KVCache] = None, *, causal: bool = True,
                window: Optional[int] = None, prefix_len=None,
                kv_x: Optional[torch.Tensor] = None,
                kv_positions: Optional[torch.Tensor] = None,
                use_rope: bool = True):
        """``(y, new_cache)`` (``None`` without a cache).  ``positions``:
        (S,) absolute positions of the query tokens; ``kv_x`` (the encoder
        output, cross-attention: no cache, no RoPE) and ``kv_positions``
        its positions."""
        h, hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        g = h // hkv
        b, s = x.shape[0], x.shape[1]
        src = x if kv_x is None else kv_x
        q = self.wq(x).view(b, s, h, hd)
        k = self.wk(src).view(b, src.shape[1], hkv, hd)
        v = self.wv(src).view(b, src.shape[1], hkv, hd)
        if hasattr(self, "q_norm"):
            q, k = self.q_norm(q), self.k_norm(k)
        k_pos = positions if kv_x is None else kv_positions
        if use_rope and kv_x is None:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, k_pos, self.rope_theta)

        new_cache = None
        if cache is not None:
            alloc = cache.k.shape[1]
            # ring write; when the update is longer than the ring, only
            # the last `alloc` tokens survive.
            kw, vw, posw, start, n_w = k, v, k_pos, cache.length, s
            if s > alloc:
                kw, vw, posw = k[:, -alloc:], v[:, -alloc:], k_pos[-alloc:]
                start, n_w = cache.length + (s - alloc), alloc
            slots = ((start + torch.arange(n_w, device=x.device)) % alloc
                     ).long()
            cache.k[:, slots] = kw.to(cache.k.dtype)
            cache.v[:, slots] = vw.to(cache.v.dtype)
            cache.pos[slots] = posw.to(torch.int32)
            new_cache = KVCache(cache.k, cache.v, cache.pos,
                                cache.length + s)
        mask_kw = dict(causal=causal, window=window, prefix_len=prefix_len)
        if cache is not None and s == 1:
            # decode: over the ring
            out = _sdpa(q.view(b, s, hkv, g, hd), cache.k, cache.v,
                        mask=make_mask(positions, cache.pos, **mask_kw),
                        cap=self.cap)
        elif q.requires_grad or not self.kernel(**mask_kw):
            # over the fresh K/V (early queries need keys the ring may
            # already have evicted); the reference builds no mask for
            # non-causal, unwindowed cross-attention given its keys
            mask = None
            if cache is not None or causal or window is not None \
                    or kv_x is None:
                mask = make_mask(positions, k_pos, **mask_kw)
            out = _sdpa(q.view(b, s, hkv, g, hd), k, v, mask=mask,
                        cap=self.cap)
        else:
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window)
            out = out.transpose(1, 2)
        return self.wo(out.reshape(b, s, h * hd)), new_cache
