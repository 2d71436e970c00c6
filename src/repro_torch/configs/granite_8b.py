"""Granite-8B (code) [arXiv:2405.04324].

Dense llama-arch 36L, d_model 4096, 32 heads (GQA kv=8, head_dim 128),
d_ff 14336, vocab 49152."""

import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=49152, rope_theta=10_000_000.0,
        max_seq=131072, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, max_seq=128, dtype=torch.float32, remat="none",
    )
