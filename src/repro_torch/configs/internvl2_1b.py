"""InternVL2-1B [arXiv:2404.16821] — InternViT-300M + Qwen2-0.5B LM.

VLM backbone: 24L, d_model 896, 14 heads (GQA kv=2, head_dim 64), d_ff 4864,
vocab 151655.  Vision frontend is a STUB supplying InternViT patch
embeddings (vit_dim 1024); the projector applies **PixelUnshuffle** (the
paper's flagship TM op — InternVL literally uses pixel-unshuffle for visual
token merging) then an MLP to d_model."""

import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab=151655, rope_theta=1_000_000.0,
        frontend="vision_stub", vit_dim=1024, pixel_unshuffle_s=2,
        max_seq=32768, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, frontend="vision_stub", vit_dim=32,
        pixel_unshuffle_s=2, max_seq=128, dtype=torch.float32, remat="none",
    )
