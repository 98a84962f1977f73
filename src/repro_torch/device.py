"""The device rule of every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means CUDA; asking for CUDA without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "the plain version on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
