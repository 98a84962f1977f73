"""mamba2-1.3b [ssm] — SSD, attention-free [arXiv:2405.21060; unverified].

48L d_model=2048 vocab=50280 ssm_state=128, expand 2, head_dim 64,
no feed-forward sublayer (d_ff=0).
"""
import torch

from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
        block_pattern=(LayerSpec("ssm"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", n_layers=3, d_model=64, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=512, ssm_state=16, ssm_head_dim=16,
        block_pattern=(LayerSpec("ssm"),), remat=False, dtype=torch.float32)
