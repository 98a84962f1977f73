"""Decoder-only LM stack (port of ``repro.models.transformer``, serving
slice).

A model is a ``ModelConfig`` whose ``block_pattern`` is a short
repeating tuple of layer specs.  The reference stacks each block
position's parameters over the repetitions and runs the stack with
``lax.scan``; the port holds one ``Block`` module per layer (layer
``r * len(pattern) + j`` is repetition ``r`` of position ``j``) and runs
them in a Python loop.  ``models.convert`` maps between the two layouts.

This slice serves global-attention ("attn") and Mamba2 ("ssm") layers
with dense or no feed-forward: ``smollm-135m`` and ``mamba2-1.3b``.
MoE, softcaps, qk-norm, sliding-window layers, the vision prefix and the
encoder-decoder raise ``NotImplementedError`` (ROADMAP Queue A), as do
the training pieces (``loss_fn``, remat, sharding contexts).

Serving: the same blocks run prefill (S = prompt, writes the KV / SSM
caches) and decode (S = 1 against the caches).  Caches are one entry per
layer.  Prefill reads out only the last position, which is all the
reference returns from it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, KVCache, init_kv_cache
from repro_torch.models.layers import (MLP, Embedding, RMSNorm, embed,
                                       softcap, unembed)
from repro_torch.models.ssm import SSDBlock, SSMCache, init_ssm_cache

SCOPE = "ROADMAP Queue A: model-side configurations beyond this slice"


class LayerSpec(NamedTuple):
    kind: str          # "attn" | "swa" | "ssm"
    moe: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    block_pattern: Tuple[LayerSpec, ...] = (LayerSpec("attn"),)
    head_dim: Optional[int] = None
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # for "swa" layers
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qk_norm: bool = False
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    n_enc_layers: int = 0                 # > 0 => encoder-decoder
    frontend: Optional[str] = None        # None | "audio" | "vision"
    frontend_seq: int = 0                 # stub prefix length (vision)
    remat: bool = True
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.n_layers % len(self.block_pattern):
            raise ValueError(f"{self.name}: {self.n_layers} layers are not "
                             f"a multiple of the block pattern "
                             f"({len(self.block_pattern)})")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def reps(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def is_enc_dec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def attn_free(self) -> bool:
        return all(s.kind == "ssm" for s in self.block_pattern)

    def param_count(self) -> int:
        """Total parameters, counted on a model built on the meta device."""
        model = Transformer(self, device="meta")
        return sum(p.numel() for p in model.parameters())


def check_scope(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run."""
    out = []
    if cfg.n_experts or any(s.moe for s in cfg.block_pattern):
        out.append("MoE")
    if cfg.attn_softcap is not None or cfg.final_softcap is not None:
        out.append("softcap")
    if cfg.qk_norm:
        out.append("qk_norm")
    if any(s.kind not in ("attn", "ssm") for s in cfg.block_pattern):
        out.append("sliding-window (swa) layers")
    if cfg.frontend is not None:
        out.append(f"the {cfg.frontend} frontend")
    if cfg.is_enc_dec:
        out.append("encoder-decoder")
    if out:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(out)} not ported ({SCOPE})")


def _device(device) -> torch.device:
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


class Block(nn.Module):
    """One layer: pre-norm mixer (attention or SSD) and dense SwiGLU FFN
    (absent when ``d_ff == 0``), with residuals."""

    def __init__(self, spec: LayerSpec, cfg: ModelConfig, device=None):
        super().__init__()
        self.kind = spec.kind
        self.ln1 = RMSNorm(cfg.d_model, device)
        if spec.kind == "attn":
            self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.hd, rope_theta=cfg.rope_theta,
                                  dtype=cfg.dtype, device=device)
        else:
            self.ssm = SSDBlock(cfg.d_model, d_state=cfg.ssm_state,
                                expand=cfg.ssm_expand,
                                head_dim=cfg.ssm_head_dim, dtype=cfg.dtype,
                                device=device)
        if cfg.d_ff > 0:
            self.ln2 = RMSNorm(cfg.d_model, device)
            self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.dtype, device)

    def forward(self, h, positions, cache=None):
        hin = self.ln1(h)
        if self.kind == "attn":
            y, new_cache = self.attn(hin, positions, cache)
        else:
            y, new_cache = self.ssm(hin, cache=cache)
        h = h + y
        if hasattr(self, "ffn"):
            h = h + self.ffn(self.ln2(h))
        return h, new_cache


class Transformer(nn.Module):
    """The model: tied embedding, ``n_layers`` blocks, final norm.

    ``device=None`` means CUDA (and raises without it); ``"meta"`` builds
    the shapes alone.  Weights start at zero: ``models.convert`` fills
    them from a reference-layout tree.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_scope(cfg)
        dev = _device(device)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab, cfg.d_model, cfg.dtype, dev)
        self.final_norm = RMSNorm(cfg.d_model, dev)
        pat = cfg.block_pattern
        self.layers = nn.ModuleList(
            Block(pat[i % len(pat)], cfg, dev) for i in range(cfg.n_layers))

    def embed_in(self, tokens: torch.Tensor) -> torch.Tensor:
        h = embed(self.embed.table, tokens) * math.sqrt(self.cfg.d_model)
        return h.to(self.cfg.dtype)

    def logits_out(self, h: torch.Tensor) -> torch.Tensor:
        h = self.final_norm(h)
        logits = unembed(self.embed.table, h).float()
        return softcap(logits, self.cfg.final_softcap)

    def run(self, h, positions, caches=None):
        """The layer loop (the reference's ``_run_stack``)."""
        new = []
        for i, layer in enumerate(self.layers):
            h, c = layer(h, positions,
                         caches[i] if caches is not None else None)
            new.append(c)
        return h, (new if caches is not None else None)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Training-mode forward (the reference's ``forward`` without the
        MoE aux loss): (B, S) ids -> (B, S, vocab) f32 logits."""
        h = self.embed_in(tokens)
        positions = torch.arange(h.shape[1], device=h.device)
        h, _ = self.run(h, positions)
        return self.logits_out(h)


Cache = Union[KVCache, SSMCache]


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> List[Cache]:
    """One cache per layer (the reference stacks them per block
    position)."""
    check_scope(cfg)
    dev = resolve_device(device)
    caches: List[Cache] = []
    for i in range(cfg.n_layers):
        spec = cfg.block_pattern[i % len(cfg.block_pattern)]
        if spec.kind == "ssm":
            caches.append(init_ssm_cache(
                batch, cfg.d_model, d_state=cfg.ssm_state,
                expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                dtype=cfg.dtype, device=dev))
        else:
            caches.append(init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                        cfg.hd, cfg.dtype, device=dev))
    return caches


def prefill(model: Transformer, batch: Dict[str, torch.Tensor],
            max_len: int):
    """Run the prompt through the model, seeding the caches.  Returns the
    last position's logits (B, vocab) and the caches."""
    tokens = batch["tokens"]
    h = model.embed_in(tokens)
    caches = init_caches(model.cfg, tokens.shape[0], max_len, tokens.device)
    positions = torch.arange(h.shape[1], device=h.device)
    h, caches = model.run(h, positions, caches)
    return model.logits_out(h[:, -1:])[:, -1], caches


def decode_step(model: Transformer, tokens_last: torch.Tensor,
                caches: List[Cache], *, pos0=None):
    """One decode step.  tokens_last: (B, 1).  Returns (logits, caches).

    ``pos0`` overrides the query position (required for attention-free
    models, whose caches carry no position counter).
    """
    if pos0 is None:
        pos0 = _cache_len(model.cfg, caches)
    h = model.embed_in(tokens_last)
    positions = pos0 + torch.arange(tokens_last.shape[1],
                                    device=h.device)
    h, caches = model.run(h, positions, caches)
    return model.logits_out(h)[:, -1], caches


def _cache_len(cfg: ModelConfig, caches: List[Cache]):
    for i, c in enumerate(caches):
        if cfg.block_pattern[i % len(cfg.block_pattern)].kind != "ssm":
            return c.length
    # attention-free model: SSM state has no position; use a counter the
    # caller threads (decode positions only matter for RoPE in attention)
    return torch.zeros((), dtype=torch.int32, device=caches[0].state.device)
