"""Command-R+ 104B [hf:CohereForAI/c4ai-command-r-plus; unverified].

Dense 64L, d_model 12288, 96 heads (GQA kv=8, head_dim 128), d_ff 33792,
vocab 256000; no-bias linears (all our linears are bias-free)."""

import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
        d_ff=33792, vocab=256000, rope_theta=75_000_000.0,
        max_seq=131072, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab=512, max_seq=128, dtype=torch.float32, remat="none",
    )
