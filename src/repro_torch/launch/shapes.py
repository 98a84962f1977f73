"""Assigned input shapes and per-architecture applicability (port of
``repro.launch.shapes``)."""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: Shape) -> bool:
    """long_500k needs a sub-quadratic path (SSM or sliding-window); pure
    full-attention archs skip it.  Decode shapes would be skipped for
    encoder-only archs (none assigned)."""
    if shape.name == "long_500k":
        return not cfg.full_attention_only
    return True


def cells(cfg: ModelConfig) -> List[Shape]:
    return [s for s in SHAPES.values() if applicable(cfg, s)]
