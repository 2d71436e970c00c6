"""MusicGen-Large [arXiv:2306.05284] — decoder-only over EnCodec tokens.

Backbone: 48L, d_model 2048, 32 heads (kv=32, i.e. MHA), d_ff 8192,
vocab 2048 (EnCodec codebook size), 4 codebooks with the delay pattern.
The audio frontend is a STUB: input_specs() supplies precomputed frame
embeddings; ``audio_embed`` demonstrates the delay-pattern Rearrange."""

import torch

from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="dense",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab=2048, rope_theta=10_000.0,
        frontend="audio_stub", n_codebooks=4,
        max_seq=131072, dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=128, frontend="audio_stub", n_codebooks=4,
        max_seq=128, dtype=torch.float32, remat="none",
    )
