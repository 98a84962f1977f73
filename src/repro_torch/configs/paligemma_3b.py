"""paligemma-3b [vlm] — SigLIP + gemma prefix-LM [arXiv:2407.07726; hf].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.  The SigLIP
vision tower is a STUB: ``launch.serve.random_batch`` draws 256
precomputed patch embeddings as the (bidirectional) prefix.
"""
import torch

from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
        vocab=257216, head_dim=256, frontend="vision", frontend_seq=256,
        block_pattern=(LayerSpec("attn"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab=512, head_dim=16,
        frontend="vision", frontend_seq=8,
        block_pattern=(LayerSpec("attn"),), remat=False, dtype=torch.float32)
