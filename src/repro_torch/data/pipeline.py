"""Deterministic synthetic LM data pipeline (port of
``repro.data.pipeline``: numpy batches, equal to the reference's for the
same seed and step).

Seeded, shardable, and checkpointable: the cursor (global step) is the
only state, so restoring a checkpoint resumes the exact token stream.
Batches are Zipf-distributed token ids with a simple Markov structure so
the loss actually decreases (useful for the end-to-end examples).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SyntheticLMDataset:
    def __init__(self, vocab: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, d_model: Optional[int] = None,
                 frontend: Optional[str] = None, frontend_seq: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.d_model = d_model
        self.frontend = frontend
        self.frontend_seq = frontend_seq
        self.step = 0
        # fixed Markov shift makes next-token partially predictable
        self._shift = 7

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
        assert int(state["seed"]) == self.seed, "seed mismatch on restore"

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed << 20) ^ step)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._rng(self.step)
        self.step += 1
        b, s = self.global_batch, self.seq_len
        base = rng.zipf(1.3, size=(b, s // 8 + 1)).clip(1, self.vocab - 1)
        toks = np.repeat(base, 8, axis=1)[:, :s]
        toks = (toks + self._shift * np.arange(s)[None, :]) % self.vocab
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        out = {"tokens": toks.astype(np.int32),
               "labels": labels.astype(np.int32)}
        if self.frontend == "audio":
            out["enc_embeds"] = rng.standard_normal(
                (b, s // 4, self.d_model), dtype=np.float32) * 0.02
        if self.frontend == "vision":
            out["prefix_embeds"] = rng.standard_normal(
                (b, self.frontend_seq, self.d_model), dtype=np.float32) * 0.02
        return out
