"""Top-k gradient compression with error feedback (port of
``repro.optim.compress``).

Before the data-parallel all-reduce, each shard keeps only the largest-k
magnitudes of its gradient (per leaf) and accumulates the residual into
an error-feedback buffer that is added back next step.  The threshold is
the k-th largest |x| and the mask is ``|x| >= threshold``, so every
entry tied with the k-th is kept, as in the reference.  Off by default;
the train launcher enables it with ``--compress-ratio``.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_map


def _topk_mask(x: torch.Tensor, ratio: float) -> torch.Tensor:
    n = x.numel()
    k = max(int(n * ratio), 1)
    flat = torch.abs(x.reshape(-1))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x) >= thresh).to(x.dtype)


@torch.no_grad()
def topk_compress_grads(grads, error, ratio: float):
    """Returns (compressed_grads, new_error).  ``error`` may be None."""
    if error is None:
        error = tree_map(torch.zeros_like, grads)

    def comp(g, e):
        acc = g + e.to(g.dtype)
        kept = acc * _topk_mask(acc, ratio)
        return kept, acc - kept

    out = tree_map(comp, grads, error)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)
