"""Llama-4-Scout 17B-active 16-expert [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified].

MoE 48L, d_model 5120, 40 heads (GQA kv=8, head_dim 128), expert d_ff 8192,
vocab 202048, 16 routed experts top-1 + 1 shared expert (early-fusion
multimodal in the original; text backbone here)."""

import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=202048, rope_theta=500_000.0,
        num_experts=16, top_k=1, n_shared=1, moe_d_ff=8192,
        # the JAX package's defaults: no expert padding, the scanned plain
        # prefill (attn_impl "scan")
        max_seq=131072, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, num_experts=4, top_k=1, n_shared=1, moe_d_ff=64,
        max_seq=128, dtype=torch.float32, remat="none",
    )
