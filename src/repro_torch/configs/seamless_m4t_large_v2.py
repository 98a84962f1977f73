"""seamless-m4t-large-v2 [audio] — enc-dec multimodal [arXiv:2308.11596; hf].

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.  The 24 layers
are split 12 encoder + 12 decoder (the published model pairs a speech
encoder with a text decoder); the audio frontend (conformer feature
extractor) is a STUB — ``launch.serve.random_batch`` draws precomputed
frame embeddings at a 4x frame-to-token rate.
"""
import torch

from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        n_layers=12, n_enc_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
        vocab=256206, frontend="audio",
        block_pattern=(LayerSpec("attn"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", n_layers=2, n_enc_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        frontend="audio", block_pattern=(LayerSpec("attn"),),
        remat=False, dtype=torch.float32)
