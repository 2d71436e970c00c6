"""Phi-4-mini 3.8B [arXiv:2412.08905].

Dense 32L, d_model 3072, 24 heads (GQA kv=8, head_dim 128), d_ff 8192,
vocab 200064; RoPE + SwiGLU + GQA."""

import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=200064, rope_theta=10_000.0,
        max_seq=131072, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, head_dim=16,
        d_ff=96, vocab=512, max_seq=128, dtype=torch.float32, remat="none",
    )
