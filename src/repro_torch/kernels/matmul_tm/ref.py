"""Plain PyTorch oracles for matmul + TM epilogues (the JAX package's
``x @ w``, its transpose and its pixel shuffle), in the kernel's
arithmetic: f32 accumulation rounded once, integers exact and wrapped."""

from __future__ import annotations

from repro_torch.kernels.matmul_tm.matmul_tm import Epilogue, matmul_tm_plain


def matmul_ref(x, w):
    return matmul_tm_plain(x, w)


def matmul_transpose_ref(x, w):
    return matmul_tm_plain(x, w, Epilogue("transpose"))


def matmul_pixel_shuffle_ref(x, w, H, W, C, s):
    """x rows are image pixels in raster order: (H·W, K) @ (K, C·s²) then
    PixelShuffle with the paper's c-major channel layout
    (c_i = c·s² + dy·s + dx)."""
    return matmul_tm_plain(x, w, Epilogue("pixel_shuffle", H, W, C, s))
