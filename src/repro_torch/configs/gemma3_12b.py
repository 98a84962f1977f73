"""gemma3-12b [dense] — 5:1 local:global, 128k ctx [hf:google/gemma-3; unverified].

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144, head_dim 256,
sliding window 1024, qk-norm, global rope theta 1e6.
"""
import torch

from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
        vocab=262144, head_dim=256, window=1024, qk_norm=True,
        rope_theta=1_000_000.0,
        block_pattern=tuple([LayerSpec("swa")] * 5 + [LayerSpec("attn")]),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16, window=8, qk_norm=True,
        block_pattern=tuple([LayerSpec("swa")] * 5 + [LayerSpec("attn")]),
        remat=False, dtype=torch.float32)
