"""RWKV6 (Finch) 3B [arXiv:2404.05892] — attention-free, data-dep. decay.

SSM 32L, d_model 2560, d_ff 8960, vocab 65536, head_dim 64 (40 heads).
O(1)-state decode: the long_500k cell is live for this arch."""

import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
        d_ff=8960, vocab=65536, ssm_head_dim=64,
        max_seq=524288, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, ssm_head_dim=16,
        max_seq=128, dtype=torch.float32, remat="none",
    )
