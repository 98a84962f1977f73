"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, sliding window
4096 on every layer.
"""
import torch

from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab=32000, head_dim=128, window=4096, n_experts=8, top_k=2,
        block_pattern=(LayerSpec("swa", moe=True),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16, window=8, n_experts=4, top_k=2,
        block_pattern=(LayerSpec("swa", moe=True),),
        remat=False, dtype=torch.float32)
