"""Entry points of the matmul_tm kernel, and the generic ``m(x @ w)``."""

from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch.core.affine import MixedRadixMap
from repro_torch.kernels.matmul_tm.matmul_tm import Epilogue, matmul_tm


def matmul_call(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N), any M, N, K (the kernel masks ragged tiles)."""
    return matmul_tm(x, w)


def matmul_transpose_call(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(x @ w).T``, each tile written transposed at commit."""
    return matmul_tm(x, w, Epilogue("transpose"))


def matmul_pixel_shuffle_call(x: torch.Tensor, w: torch.Tensor, *, H: int,
                              W: int, C: int, s: int) -> torch.Tensor:
    """(H·W, K) @ (K, C·s²) committed directly as the (H·s, W·s, C) image."""
    return matmul_tm(x, w, Epilogue("pixel_shuffle", H, W, C, s))


def matmul_split_call(x: torch.Tensor, w: torch.Tensor, *, n_parts: int,
                      part: int) -> torch.Tensor:
    """``split(x @ w, n_parts)[part]`` along the columns: only the band's
    columns are computed and committed."""
    N = w.shape[1]
    if N % n_parts or not 0 <= part < n_parts:
        raise ValueError(f"matmul_split_call: {N} columns in {n_parts} "
                         f"parts, part {part}")
    band = N // n_parts
    return matmul_tm(x, w, Epilogue(col0=part * band, ncols=band))


@lru_cache(maxsize=128)
def _mm_node(M: int, K: int, N: int, dtype: torch.dtype):
    """A synthesized compute node for the 2D product — what routes
    ``matmul_tm_call`` through the cross-engine chain registry."""
    from repro_torch.compiler.ir import BufRef, TPUNode
    return TPUNode(op=torch.ops.aten.mm.default,
                   args=(BufRef("a"), BufRef("b")), kwargs={},
                   src_names=("a", "b"), dst_names=("y",),
                   in_avals=(((M, K), dtype), ((K, N), dtype)),
                   out_avals=(((M, N), dtype),))


def matmul_tm_call(x: torch.Tensor, w: torch.Tensor,
                   m: MixedRadixMap) -> torch.Tensor:
    """Generic entry: ``m(x @ w)`` as ONE launch via the cross-engine chain
    registry (the product commits through the composed chain map), with the
    bespoke transpose epilogue kept for its exact case, and the product
    followed by the generic tm_affine kernel (two passes) only as the
    decline branch."""
    from repro_torch.core.dispatch import lower_xengine
    from repro_torch.core.instr import TMInstr, TMOpcode
    from repro_torch.kernels.tm_affine.tm_affine import tm_affine
    if m.is_pure_permutation() and m.permutation() == (1, 0):
        return matmul_transpose_call(x, w)
    M, K = x.shape
    N = w.shape[1]
    if x.dtype == w.dtype and tuple(m.in_shape) == (M, N):
        node = _mm_node(M, K, N, x.dtype)
        ins = TMInstr(opcode=TMOpcode.COARSE, srcs=("y",), dst="z", map_=m)
        lowered = lower_xengine("compute_to_tm", node, [x, w], [ins],
                                [[None]])
        if lowered is not None:
            return lowered[0]
    return tm_affine(matmul_call(x, w), m)
