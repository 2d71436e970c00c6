"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407].

Dense 40L, d_model 5120, 32 heads (GQA kv=8, head_dim 128), d_ff 14336,
vocab 131072 (Tekken), 128k context (rope_theta 1M)."""

import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=131072, rope_theta=1_000_000.0,
        max_seq=131072, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, rope_theta=1_000_000.0,
        max_seq=128, dtype=torch.float32, remat="none",
    )
