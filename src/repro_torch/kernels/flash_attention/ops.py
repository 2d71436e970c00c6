"""Entry points of the flash-attention kernels, with the JAX signatures.

``bq`` and ``bk`` are the Pallas kernels' tile sizes; they are accepted and
not used, because the CUDA kernels tile on their own terms (128-query x
64-key tiles in a bf16 prefill, 64 x 64 in f32, 64-row tiles of cache
splits in decode) and mask the ragged edge themselves.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_decode)


def flash_attention_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, bq: int = 128,
                         bk: int = 128) -> torch.Tensor:
    del bq, bk
    return flash_attention(q, k, v, causal=causal)


def flash_decode_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      length, *, bk: int = 512) -> torch.Tensor:
    del bk
    return flash_decode(q, k, v, length)
