"""Plain PyTorch versions of the port's kernels (the correctness contract).

``tat_lookup_ref`` is the port of ``repro.kernels.ref.tat_lookup_ref``;
the plain version of the cell-scan kernel is the eager
``repro_torch.core.engine.step.scan_cell``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def tat_lookup_ref(req_tags: torch.Tensor, tat: torch.Tensor,
                   states: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fully-associative lookup.

    req_tags: (R,) int32 request tags
    tat:      (N,) int32 table tags
    states:   (N,) int32 entry states (0 = Empty — an Empty entry never
              matches, mirroring PBCS semantics)
    Returns (idx: (R,) int32 first match index or -1,
             state: (R,) int32 matched entry's state or 0).
    """
    match = (req_tags[:, None] == tat[None, :]) & (states[None, :] != 0)
    has = match.any(dim=1)
    idx = torch.argmax(match.to(torch.int8), dim=1)
    st = torch.where(has, states[idx], torch.zeros_like(states[idx]))
    return (torch.where(has, idx, torch.full_like(idx, -1)).to(torch.int32),
            st.to(torch.int32))
