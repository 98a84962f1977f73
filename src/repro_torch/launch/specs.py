"""Shape-only stand-ins for every model input (port of
``repro.launch.specs``).

The reference's stand-ins are ``jax.ShapeDtypeStruct``s from
``jax.eval_shape``; the port's are tensors on the meta device, which
hold a shape and a dtype and no data, so nothing is allocated.  They
mirror what the data pipeline and the serving front end produce; the
dry-run runs each step on them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.launch.shapes import Shape
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init

AUDIO_FRAME_RATE = 4  # tokens per encoder frame (stub conformer stride)


def _sd(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: T.ModelConfig, shape: Shape) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _sd((b, s), torch.int32),
             "labels": _sd((b, s), torch.int32)}
    if cfg.is_enc_dec:
        batch["enc_embeds"] = _sd((b, s // AUDIO_FRAME_RATE, cfg.d_model),
                                  torch.float32)
    if cfg.frontend == "vision":
        batch["prefix_embeds"] = _sd((b, cfg.frontend_seq, cfg.d_model),
                                     torch.float32)
    return batch


def params_specs(cfg: T.ModelConfig) -> T.Transformer:
    """The model on the meta device: its named parameters are the specs."""
    return T.Transformer(cfg, device="meta")


def opt_state_specs(cfg: T.ModelConfig, opt_cfg: AdamWConfig,
                    params: Dict[str, torch.Tensor] = None):
    """``adamw_init`` on the meta parameters (``params``, else those of
    :func:`params_specs`): moments in ``opt_cfg.moment_dtype``."""
    if params is None:
        params = dict(params_specs(cfg).named_parameters())
    return adamw_init(opt_cfg, params)


def decode_specs(cfg: T.ModelConfig, shape: Shape) -> Dict[str, Any]:
    """``tokens_last``, ``caches``, ``pos0`` and, for an encoder-decoder,
    ``enc_out`` / ``enc_pos``: the decode step's inputs."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens_last": _sd((b, 1), torch.int32),
           "caches": T.init_caches(cfg, b, s, "meta"),
           "pos0": _sd((), torch.int32)}
    if cfg.is_enc_dec:
        out["enc_out"] = _sd((b, s // AUDIO_FRAME_RATE, cfg.d_model),
                             cfg.dtype)
        out["enc_pos"] = _sd((s // AUDIO_FRAME_RATE,), torch.int32)
    return out
