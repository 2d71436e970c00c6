"""Zamba2-7B [arXiv:2411.15242; unverified] — Mamba2 + shared attention.

Hybrid 81L Mamba2 backbone (d_model 3584, ssm_state 64, expand 2), one
*shared* attention block (32 heads, kv=32) applied every 6 layers over
Route([hidden, embed0]) (2·d_model input), d_ff 14336 (shared-block MLP in
the original; the Mamba d_inner here is 2×3584), vocab 32000."""

import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
        d_ff=14336, vocab=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
        max_seq=524288, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, ssm_state=8, ssm_head_dim=16, ssm_expand=2,
        attn_every=2, max_seq=128, dtype=torch.float32, remat="none",
    )
