"""Gradient compression with error feedback (cross-pod traffic reduction).

The JAX package's ``optim/compression.py`` with PyTorch tensors.  Each
gradient is quantized to int8 with a per-tensor scale, and the
quantization residual is carried into the next step (error feedback,
Karimireddy et al. 2019), which keeps SGD/Adam converging while a
cross-pod all-reduce would move 4x fewer bytes than bf16.
:func:`compress_decompress` rounds the values to their int8
representation (the bits that would cross the wire) and returns the
dequantized f32; the error feedback is written in place.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def compression_init(grads):
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads)


def quantize(g: torch.Tensor, err: torch.Tensor):
    """``(int8 codes, scale, dequantized f32, new error)`` of ``g`` plus
    the carried ``err``: scale = max|g + err| / 127, codes rounded half to
    even and clamped to +-127."""
    g = g.float() + err
    scale = torch.clamp(torch.amax(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127)
    deq = q * scale
    return q.to(torch.int8), scale, deq, g - deq


@torch.no_grad()
def compress_decompress(grads, ef_state):
    """Returns ``(dequantized_grads, ef_state)``, ``ef_state`` updated in
    place."""
    def one(g, err):
        _, _, deq, new_err = quantize(g, err)
        err.copy_(new_err)
        return deq

    return tree_map(one, grads, ef_state), ef_state
