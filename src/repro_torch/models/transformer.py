"""Composable transformer stack (port of ``repro.models.transformer``).

A model is a ``ModelConfig`` whose ``block_pattern`` is a short
repeating tuple of layer specs.  The reference stacks each block
position's parameters over the repetitions and runs the stack with
``lax.scan``; the port holds one ``Block`` module per layer (layer
``r * len(pattern) + j`` is repetition ``r`` of position ``j``) and runs
them in a Python loop.  ``models.convert`` maps between the two layouts.

Layer kinds: ``"attn"`` (global self-attention, RoPE base
``cfg.rope_theta``), ``"swa"`` (sliding-window self-attention, RoPE base
10 000, a ring cache of ``min(max_len, window)`` slots) and ``"ssm"``
(Mamba2 SSD), each with a SwiGLU feed-forward (absent when ``d_ff ==
0``): dense, or the expert FFN of ``models.moe`` where the spec says
``moe``.  Topologies: decoder-only LMs, the prefix-LM with stub patch
embeddings (``frontend="vision"``: ``prefix_embeds`` go before the
tokens, attended bidirectionally, and are stripped before the logits)
and the encoder-decoder with stub frame embeddings (``n_enc_layers >
0``: a non-causal encoder stack, then a cross-attention sublayer in every
decoder block).  This covers all ten configurations.

MoE layers are called as the reference calls them: ``drop=cache is
None`` (training and the no-cache forward drop tokens past an expert's
capacity; prefill and decode keep every token) and ``groups`` from the
innermost :class:`moe_groups` context (1 outside any).  The layers' load
balance losses are summed into ``forward``'s aux, which ``loss_fn`` adds
at 0.01.

Training: :func:`loss_fn` is the reference's next-token cross-entropy.
Parameters are frozen (``requires_grad=False``) until
:func:`set_trainable` turns them on, which only the training path
(``launch.steps.make_train_step``) does; serving runs under
``torch.inference_mode()``.  With ``cfg.remat`` the layer loop
recomputes each layer's activations in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` of
its scanned block does; the numbers, the aux included, are the same
either way.

Serving: the same blocks run prefill (S = prompt, writes the KV / SSM
caches) and decode (S = 1 against the caches).  Caches are one entry per
decoder layer.  Prefill reads out only the last position, which is all
the reference returns from it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, KVCache, init_kv_cache
from repro_torch.models.layers import (MLP, Embedding, RMSNorm, embed,
                                       softcap, unembed)
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import SSDBlock, SSMCache, init_ssm_cache


class LayerSpec(NamedTuple):
    kind: str          # "attn" | "swa" | "ssm"
    moe: bool = False


# The activation spec a launcher chose (``launch.sharding.FLAGS
# ["act_shard"]``): the reference constrains the residual stream to it in
# every block; the port records it only.
_ACT_SPEC: list = [None]


class activation_sharding:
    """Context manager: record ``spec``, the (B, S, d) activations' spec
    in the launch layer's form, as the innermost choice
    (:func:`activation_spec` reads it).  It applies no constraint: the
    reference's is a hint to XLA's partitioner, and no partitioner runs
    in the port (the dry-run records the choice in its rows)."""

    def __init__(self, spec):
        self.spec = spec

    def __enter__(self):
        _ACT_SPEC.append(self.spec)

    def __exit__(self, *exc):
        _ACT_SPEC.pop()


def activation_spec():
    """The innermost :class:`activation_sharding`'s spec (None outside)."""
    return _ACT_SPEC[-1]


# GShard-style MoE routing groups (see models/moe.py): the launcher sets
# this to the data-parallel shard count so dispatch stays shard-local.
_MOE_GROUPS: list = [1]


class moe_groups:
    """Context manager: route MoE layers in ``n`` token groups."""

    def __init__(self, n: int):
        self.n = max(int(n), 1)

    def __enter__(self):
        _MOE_GROUPS.append(self.n)

    def __exit__(self, *exc):
        _MOE_GROUPS.pop()


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

    @property
    def full_attention_only(self) -> bool:
        """True when every token-mixing layer is global attention."""
        return all(s.kind == "attn" for s in self.block_pattern)

    def param_count(self) -> int:
        """Total parameters, counted on a model built on the meta device."""
        model = Transformer(self, device="meta")
        return sum(p.numel() for p in model.parameters())

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        total = self.param_count()
        if self.n_experts == 0:
            return total
        n_moe = sum(s.moe for s in self.block_pattern) * self.reps
        expert = 3 * self.d_model * self.d_ff
        inactive = n_moe * (self.n_experts - self.top_k) * expert
        return total - inactive


def _device(device) -> torch.device:
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


class Block(nn.Module):
    """One layer: pre-norm mixer (attention or SSD), the cross-attention
    sublayer in a decoder block of an encoder-decoder (``cross``), and a
    SwiGLU FFN, dense (``ffn``) or expert (``moe``, where the spec says
    so), absent when ``d_ff == 0``; with residuals."""

    def __init__(self, spec: LayerSpec, cfg: ModelConfig, cross: bool,
                 device=None):
        super().__init__()
        self.kind = spec.kind
        self.window = cfg.window if spec.kind == "swa" else None
        self.ln1 = RMSNorm(cfg.d_model, device)
        if spec.kind in ("attn", "swa"):
            theta = cfg.rope_theta if spec.kind == "attn" else 10_000.0
            self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.hd, rope_theta=theta,
                                  cap=cfg.attn_softcap, qk_norm=cfg.qk_norm,
                                  dtype=cfg.dtype, device=device)
        else:
            self.ssm = SSDBlock(cfg.d_model, d_state=cfg.ssm_state,
                                expand=cfg.ssm_expand,
                                head_dim=cfg.ssm_head_dim, dtype=cfg.dtype,
                                device=device)
        if cross:
            self.ln_cross = RMSNorm(cfg.d_model, device)
            self.cross = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, cross=True, dtype=cfg.dtype,
                                   device=device)
        if cfg.d_ff > 0:
            self.ln2 = RMSNorm(cfg.d_model, device)
            if spec.moe:
                self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts,
                               cfg.dtype, device)
                self.moe_kw = dict(top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor)
            else:
                self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.dtype, device)

    def forward(self, h, positions, cache=None, *, causal=True,
                prefix_len=None, enc_out=None, enc_pos=None, groups=1):
        """(h, the layer's new cache, its MoE aux loss or None);
        ``groups``: the MoE layer's routing groups."""
        hin = self.ln1(h)
        if self.kind == "ssm":
            y, new_cache = self.ssm(hin, cache=cache)
        else:
            y, new_cache = self.attn(hin, positions, cache, causal=causal,
                                     window=self.window,
                                     prefix_len=prefix_len)
        h = h + y
        if hasattr(self, "cross"):
            y, _ = self.cross(self.ln_cross(h), positions, causal=False,
                              kv_x=enc_out, kv_positions=enc_pos,
                              use_rope=False)
            h = h + y
        aux = None
        if hasattr(self, "ffn"):
            h = h + self.ffn(self.ln2(h))
        elif hasattr(self, "moe"):
            y, aux = self.moe(self.ln2(h), drop=cache is None,
                              groups=groups, **self.moe_kw)
            h = h + y
        return h, new_cache, aux


ENC_PATTERN = (LayerSpec("attn"),)


class Transformer(nn.Module):
    """The model: tied embedding, ``n_layers`` decoder blocks, final norm;
    with ``n_enc_layers``, an encoder of that many plain ``attn`` blocks
    (``enc_layers``) and its norm (``enc_norm``).

    ``device=None`` means CUDA (and raises without it); ``"meta"`` builds
    the shapes alone.  Weights start at zero: ``models.convert`` fills
    them from a reference-layout tree, or on the device
    (``convert.device_fill``).
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = _device(device)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab, cfg.d_model, cfg.dtype, dev)
        self.final_norm = RMSNorm(cfg.d_model, dev)
        pat = cfg.block_pattern
        self.layers = nn.ModuleList(
            Block(pat[i % len(pat)], cfg, cfg.is_enc_dec, dev)
            for i in range(cfg.n_layers))
        if cfg.is_enc_dec:
            self.enc_layers = nn.ModuleList(
                Block(ENC_PATTERN[0], cfg, False, dev)
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = RMSNorm(cfg.d_model, dev)

    def embed_in(self, tokens: torch.Tensor) -> torch.Tensor:
        h = embed(self.embed.table, tokens) * math.sqrt(self.cfg.d_model)
        return h.to(self.cfg.dtype)

    def logits_out(self, h: torch.Tensor) -> torch.Tensor:
        h = self.final_norm(h)
        logits = unembed(self.embed.table, h).float()
        return softcap(logits, self.cfg.final_softcap)

    def run(self, h, positions, caches=None, *, layers=None, **kw):
        """The layer loop (the reference's ``_run_stack``) over ``layers``
        (the decoder's by default); ``kw`` goes to every block.  Returns
        (h, the new caches or None, the summed MoE aux loss, f32).  With
        ``cfg.remat``, each layer of a forward that records gradients is
        recomputed in the backward; the checkpoint returns its aux with
        ``h``.  The MoE routing groups are read here, once, so that a
        recomputation outside the caller's :class:`moe_groups` routes as
        the forward did."""
        layers = self.layers if layers is None else layers
        kw = dict(kw, groups=_MOE_GROUPS[-1])
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        remat = caches is None and self.cfg.remat and torch.is_grad_enabled()
        new = []
        for i, layer in enumerate(layers):
            c = caches[i] if caches is not None else None
            if remat:
                h, c, a = checkpoint(layer, h, positions, use_reentrant=False,
                                     **kw)
            else:
                h, c, a = layer(h, positions, c, **kw)
            new.append(c)
            if a is not None:
                aux = aux + a
        return h, (new if caches is not None else None), aux

    def encode(self, enc_embeds: torch.Tensor):
        """The (stub-fronted) encoder over precomputed frame embeddings:
        (encoder output, its positions), as the reference's ``_encode``."""
        pos = torch.arange(enc_embeds.shape[1], device=enc_embeds.device)
        h, _, _ = self.run(enc_embeds.to(self.cfg.dtype), pos,
                           layers=self.enc_layers, causal=False)
        return self.enc_norm(h), pos

    def inputs(self, batch: Dict[str, torch.Tensor]):
        """The decoder's input stream and keywords from a batch: the token
        embeddings after any vision prefix (cast to the model dtype, not
        scaled), ``prefix_len``, and the encoder output of an enc-dec."""
        h = self.embed_in(batch["tokens"])
        kw: Dict[str, Any] = {}
        if self.cfg.frontend == "vision" and "prefix_embeds" in batch:
            pre = batch["prefix_embeds"].to(self.cfg.dtype)
            h = torch.cat([pre, h], dim=1)
            kw["prefix_len"] = pre.shape[1]
        if self.cfg.is_enc_dec:
            kw["enc_out"], kw["enc_pos"] = self.encode(batch["enc_embeds"])
        return h, kw

    def logits_and_aux(self, tokens: torch.Tensor, **stubs):
        """Training-mode forward (the reference's ``forward``): (B, S) ids
        and the batch's stub inputs (``STUB_INPUTS``) -> ((B, S, vocab)
        f32 logits, the summed MoE aux loss)."""
        h, kw = self.inputs({"tokens": tokens, **stubs})
        positions = torch.arange(h.shape[1], device=h.device)
        h, _, aux = self.run(h, positions, **kw)
        if "prefix_len" in kw:
            h = h[:, kw["prefix_len"]:]
        return self.logits_out(h), aux

    def forward(self, tokens: torch.Tensor, **stubs) -> torch.Tensor:
        """The training-mode forward's (B, S, vocab) f32 logits."""
        return self.logits_and_aux(tokens, **stubs)[0]


STUB_INPUTS = ("enc_embeds", "prefix_embeds")


def forward(model: Transformer, batch: Dict[str, torch.Tensor]):
    """The reference's ``forward(cfg, params, batch)``: (logits, aux),
    where aux is the MoE layers' summed load-balance loss (0 without
    MoE)."""
    return model.logits_and_aux(
        batch["tokens"], **{k: batch[k] for k in STUB_INPUTS if k in batch})


def set_trainable(model: Transformer, on: bool = True) -> None:
    """Let the model's parameters record gradients (the training path)."""
    for p in model.parameters():
        p.requires_grad_(on)


def loss_fn(model: Transformer,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross-entropy (labels = batch['labels'], -1 = ignore),
    in the reference's logsumexp / one-hot form, plus ``0.01 * aux``, the
    MoE load-balance loss.  ``batch`` may hold the reference's
    ``enc_embeds`` / ``prefix_embeds``."""
    logits, aux = forward(model, batch)
    labels = batch["labels"]
    valid = labels >= 0
    lab = torch.where(valid, labels, 0).long()
    log_z = torch.logsumexp(logits, dim=-1)
    onehot = F.one_hot(lab, model.cfg.vocab).to(logits.dtype)
    true_logit = torch.sum(logits * onehot, dim=-1)
    nll = log_z - true_logit
    loss = torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1)
    return loss + 0.01 * aux


Cache = Union[KVCache, SSMCache]


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> List[Cache]:
    """One cache per decoder layer (the reference stacks them per block
    position); a sliding-window layer's ring has ``min(max_len, window)``
    slots.  ``device``: as :class:`Transformer`'s (``"meta"`` gives the
    shapes alone)."""
    dev = _device(device)
    caches: List[Cache] = []
    for i in range(cfg.n_layers):
        spec = cfg.block_pattern[i % len(cfg.block_pattern)]
        if spec.kind == "ssm":
            caches.append(init_ssm_cache(
                batch, cfg.d_model, d_state=cfg.ssm_state,
                expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                dtype=cfg.dtype, device=dev))
        else:
            win = cfg.window if spec.kind == "swa" else None
            alloc = min(max_len, win) if win else max_len
            caches.append(init_kv_cache(batch, alloc, cfg.n_kv_heads,
                                        cfg.hd, cfg.dtype, device=dev))
    return caches


def prefill(model: Transformer, batch: Dict[str, torch.Tensor],
            max_len: int):
    """Run the prompt through the model, seeding the caches.  ``batch``
    holds ``tokens`` and, per config, ``enc_embeds`` / ``prefix_embeds``.
    Returns the last position's logits (B, vocab) and the caches."""
    h, kw = model.inputs(batch)
    caches = init_caches(model.cfg, h.shape[0], max_len, h.device)
    positions = torch.arange(h.shape[1], device=h.device)
    h, caches, _ = model.run(h, positions, caches, **kw)
    return model.logits_out(h[:, -1:])[:, -1], caches


def decode_step(model: Transformer, tokens_last: torch.Tensor,
                caches: List[Cache], *, pos0=None, enc_out=None,
                enc_pos=None):
    """One decode step.  tokens_last: (B, 1).  Returns (logits, caches).

    ``pos0`` overrides the query position (required for attention-free
    models, whose caches carry no position counter).  ``enc_out`` /
    ``enc_pos`` are an encoder-decoder's encoder output and positions
    (``Transformer.encode``); without them its cross-attention attends
    over the decoded token alone, as the reference's does.
    """
    if pos0 is None:
        pos0 = _cache_len(model.cfg, caches)
    h = model.embed_in(tokens_last)
    positions = pos0 + torch.arange(tokens_last.shape[1],
                                    device=h.device)
    h, caches, _ = model.run(h, positions, caches, enc_out=enc_out,
                             enc_pos=enc_pos)
    return model.logits_out(h)[:, -1], caches


def _cache_len(cfg: ModelConfig, caches: List[Cache]):
    for i, c in enumerate(caches):
        if cfg.block_pattern[i % len(cfg.block_pattern)].kind != "ssm":
            return c.length
    # attention-free model: SSM state has no position; use a counter the
    # caller threads (decode positions only matter for RoPE in attention)
    return torch.zeros((), dtype=torch.int32, device=caches[0].state.device)
