"""smollm-135m [dense] — small llama [hf:HuggingFaceTB/SmolLM-135M; hf].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, head_dim 64.
"""
import torch

from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
        vocab=49152, head_dim=64,
        block_pattern=(LayerSpec("attn"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke", n_layers=3, d_model=48, n_heads=3, n_kv_heads=3,
        d_ff=96, vocab=512, head_dim=16,
        block_pattern=(LayerSpec("attn"),), remat=False, dtype=torch.float32)
