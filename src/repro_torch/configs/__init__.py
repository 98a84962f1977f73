"""Architecture registry: ``get_config(arch_id)`` / ``ARCHS`` (port of
``repro.configs``).

The ids are the reference's.  This slice ports two of them,
``smollm-135m`` and ``mamba2-1.3b``; ``get_config`` raises
``NotImplementedError`` for the other eight (ROADMAP Queue A).  Each
ported ``<id>.py`` module exports

    config()        -> the full published configuration
    smoke_config()  -> a reduced same-family configuration for CPU tests
"""
from __future__ import annotations

import importlib
from typing import List

ARCHS: List[str] = [
    "seamless-m4t-large-v2",
    "gemma2-2b",
    "deepseek-67b",
    "smollm-135m",
    "gemma3-12b",
    "jamba-1.5-large-398b",
    "phi3.5-moe-42b",
    "mixtral-8x7b",
    "mamba2-1.3b",
    "paligemma-3b",
]
PORTED = ("smollm-135m", "mamba2-1.3b")

_ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi3.5-moe-42b",
    "jamba-1.5-large": "jamba-1.5-large-398b",
}


def get_config(arch_id: str, *, smoke: bool = False):
    arch_id = _ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCHS}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet (ROADMAP Queue A); the port "
            f"serves {PORTED}")
    name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke_config() if smoke else mod.config()
