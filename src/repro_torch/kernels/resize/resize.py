"""Bilinear Resize (fine-grained TM, paper Fig. 2b).

The RME view of Resize: each output pixel *assembles* four neighbouring
input elements and *evaluates* their weighted average, half-pixel
convention (``align_corners=False``), taps and weights in f32, cast back to
the input's dtype.  One hand-written CUDA kernel (``csrc/resize.cu``),
:func:`resize_bilinear`, beside its plain PyTorch version
:func:`resize_plain` (the reference engine's ``tm_ops.resize_bilinear``).
The wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor; ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.tm_ops import resize_bilinear as resize_plain
from repro_torch.kernels import build
from repro_torch.kernels.tm_affine.tm_affine import DTYPE_CODES


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W, C) -> (out_h, out_w, C).  CPU tensor: the plain version; CUDA
    tensor: the kernel, or an exception."""
    if x.device.type == "cpu":
        return resize_plain(x, out_h, out_w)
    lib = build.library("resize")  # a kernel that cannot be built raises
    if not x.is_cuda:
        raise ValueError(f"resize_bilinear: x must be a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"resize_bilinear: unsupported dtype {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"resize_bilinear: x must be a contiguous (H, W, C) "
                         f"tensor, got shape {tuple(x.shape)}")
    H, W, C = x.shape
    if out_h < 0 or out_w < 0:
        raise ValueError(f"resize_bilinear: bad output size {out_h}x{out_w}")
    out = torch.empty((out_h, out_w, C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if H == 0 or W == 0 or max(x.numel(), out_w * C) >= 2 ** 31:
        raise ValueError(f"resize_bilinear: cannot resize {tuple(x.shape)} "
                         f"to ({out_h}, {out_w}, {C})")
    # the scale factors are rounded to f32 here, as jnp rounds the Python
    # float H / out_h against an f32 array
    rc = lib.resize_bilinear(x.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype],
                             H, W, C, out_h, out_w, H / out_h, W / out_w,
                             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "resize_bilinear")
    resize_bilinear.launches += 1
    return out


resize_bilinear.launches = 0
