"""deepseek-67b [dense] — llama architecture [arXiv:2401.02954; hf].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400, head_dim 128.
"""
import torch

from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
        vocab=102400, head_dim=128,
        block_pattern=(LayerSpec("attn"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=512, head_dim=16,
        block_pattern=(LayerSpec("attn"),), remat=False, dtype=torch.float32)
