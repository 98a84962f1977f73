"""gemma2-2b [dense] — local:global 1:1, logit softcaps [arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, head_dim 256,
sliding window 4096, attn softcap 50, final softcap 30.
"""
import torch

from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
        vocab=256000, head_dim=256, window=4096,
        attn_softcap=50.0, final_softcap=30.0,
        block_pattern=(LayerSpec("swa"), LayerSpec("attn")),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16, window=8,
        attn_softcap=50.0, final_softcap=30.0,
        block_pattern=(LayerSpec("swa"), LayerSpec("attn")),
        remat=False, dtype=torch.float32)
