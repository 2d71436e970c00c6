"""Oracles for img2col + implicit-GEMM conv: the kernels' plain versions
(the reference engine's img2col map, then an f32 product)."""

from repro_torch.kernels.img2col.img2col import (  # noqa: F401
    conv2d_plain as conv2d_ref, img2col_plain as img2col_ref)
