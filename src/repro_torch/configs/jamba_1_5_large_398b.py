"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7, MoE [arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2 on
every other layer, one attention layer per 8 (1:7 attn:mamba).  The SSD
mixer is Mamba2 (the published model uses Mamba1; the reference chose
SSD's chunked form, and the port follows it).
"""
import torch

from repro_torch.models.transformer import LayerSpec, ModelConfig

_BLOCK = (
    LayerSpec("ssm"), LayerSpec("ssm", moe=True),
    LayerSpec("ssm"), LayerSpec("ssm", moe=True),
    LayerSpec("attn"), LayerSpec("ssm", moe=True),
    LayerSpec("ssm"), LayerSpec("ssm", moe=True),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
        vocab=65536, head_dim=128, n_experts=16, top_k=2,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2,
        block_pattern=_BLOCK,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16, n_experts=4, top_k=2,
        ssm_state=16, ssm_head_dim=16,
        block_pattern=tuple(
            LayerSpec(s.kind, s.moe) for s in _BLOCK),
        remat=False, dtype=torch.float32)
