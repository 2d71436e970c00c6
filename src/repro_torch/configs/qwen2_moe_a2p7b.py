"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

MoE 24L, d_model 2048, 16 heads (kv=16, MHA), routed expert d_ff 1408,
vocab 151936; 60 routed experts top-4 + 4 shared experts (shared d_ff
4×1408 = 5632)."""

import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=5632, vocab=151936, rope_theta=1_000_000.0,
        num_experts=60, top_k=4, n_shared=4, moe_d_ff=1408,
        # the JAX package's layout settings, kept field for field: 64
        # physical experts (the pad experts get no tokens), no sequence
        # parallelism around dispatch, the lower-triangle plain prefill
        moe_pad_experts=64,
        moe_drop_sp=True,
        attn_impl="triangular",
        max_seq=32768, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab=512, num_experts=8, top_k=4, n_shared=1, moe_d_ff=32,
        max_seq=128, dtype=torch.float32, remat="none",
    )
