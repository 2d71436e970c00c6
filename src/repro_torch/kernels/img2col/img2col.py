"""Img2col and the implicit-GEMM convolution.

Img2col is the TM operator that lays activations out for a matrix unit: a
``(H, W, C)`` map becomes the ``(OH·OW, kh·kw·C)`` patch matrix, column
``k = (ky·kw + kx)·C + c``.  The implicit-GEMM convolution fuses it into
the product: ``(OH, OW, OC) = patches @ w.reshape(kh·kw·C, OC)``, the patch
matrix never written to device memory (the paper's near-memory form).

Two hand-written CUDA kernels (``csrc/img2col.cu``), each beside its plain
PyTorch version:

* :func:`img2col` / :func:`img2col_plain` — the patch matrix; taps outside
  the input read ``fill`` (the map's fill register; 0 gives ``jnp.pad``'s
  zero padding);
* :func:`conv2d` / :func:`conv2d_plain` — the implicit-GEMM convolution,
  f32 (and bf16) with f32 accumulation, rounded once to x's dtype; padded
  taps read zero.

Each wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor, and its ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.affine import img2col_map
from repro_torch.core.engine import apply_map
from repro_torch.kernels import build
from repro_torch.kernels.tm_affine.tm_affine import (DTYPE_CODES, _fill_bits,
                                                     _magic)

_NARROW = 2 ** 31  # unit indices below this take the kernel's 32-bit path
CONV_DTYPES = (torch.float32, torch.bfloat16)


def out_hw(H: int, W: int, kh: int, kw: int, stride: int,
           pad: int) -> tuple[int, int]:
    """Output rows and columns of a ``kh x kw`` window at ``stride`` over an
    ``(H, W)`` map padded by ``pad`` on every side."""
    if kh < 1 or kw < 1 or stride < 1 or pad < 0:
        raise ValueError(f"img2col: bad window kh={kh} kw={kw} "
                         f"stride={stride} pad={pad}")
    OH = (H + 2 * pad - kh) // stride + 1
    OW = (W + 2 * pad - kw) // stride + 1
    if OH < 0 or OW < 0:
        raise ValueError(f"img2col: a {kh}x{kw} window does not fit "
                         f"({H}, {W}) padded by {pad}")
    return OH, OW


# ---------------------------------------------------------------------------
# img2col
# ---------------------------------------------------------------------------

def img2col_plain(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                  pad: int = 0, fill: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the img2col kernel: the reference engine's
    gather through the img2col map, ``fill`` where the tap leaves x."""
    H, W, C = x.shape
    OH, OW = out_hw(H, W, kh, kw, stride, pad)
    if x.numel() == 0:  # nothing to gather from: every tap is padding
        return torch.full((OH * OW, kh * kw * C), fill, dtype=x.dtype,
                          device=x.device)
    return apply_map(img2col_map((H, W, C), kh, kw, stride, pad, fill=fill),
                     x)


def _unit_bytes(run_bytes: int, ptr: int) -> int:
    """The widest power of two bytes, at most 16, that divides a run of C
    elements and the input's address: every copy unit is then aligned."""
    unit = 16
    while unit > 1 and (run_bytes % unit or ptr % unit):
        unit //= 2
    return unit


def _fill_pattern(fill: float, dtype: torch.dtype, unit: int,
                  ) -> tuple[int, int]:
    """``fill`` in ``dtype`` repeated across one copy unit, as the (low,
    high) 64-bit halves of its bytes."""
    item = torch.empty((), dtype=dtype).element_size()
    raw = _fill_bits(fill, dtype).to_bytes(item, "little") * (unit // item)
    bits = int.from_bytes(raw, "little")
    return bits & (2 ** 64 - 1), bits >> 64


def _check_operand(name: str, x: torch.Tensor, dtypes) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (H, W, C) tensor, "
                         f"got shape {tuple(x.shape)}")


def img2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1, pad: int = 0,
            fill: float = 0.0) -> torch.Tensor:
    """``(H, W, C) -> (OH·OW, kh·kw·C)`` patch matrix, ``fill`` in the taps
    outside x.  CPU tensor: the plain version; CUDA tensor: the kernel, or
    an exception."""
    if x.device.type == "cpu":
        return img2col_plain(x, kh, kw, stride, pad, fill)
    lib = build.library("img2col")  # a kernel that cannot be built raises
    _check_operand("img2col", x, DTYPE_CODES)
    H, W, C = x.shape
    OH, OW = out_hw(H, W, kh, kw, stride, pad)
    out = torch.empty((OH * OW, kh * kw * C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    item = x.element_size()
    unit = _unit_bytes(C * item, x.data_ptr())
    units = out.numel() * item // unit
    narrow = units < _NARROW and x.numel() * item // unit < _NARROW
    R = C * item // unit
    magics = (ctypes.c_int64 * 8)(*[v for d in (R, kh * kw, kw, OW)
                                    for v in _magic(d)])
    lo, hi = _fill_pattern(fill, x.dtype, unit)
    rc = lib.img2col(x.data_ptr(), out.data_ptr(), unit, units, H, W, stride,
                     pad, kw, R, kh * kw, OW, magics, lo, hi, int(narrow),
                     torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "img2col")
    img2col.launches += 1
    return out


img2col.launches = 0


# ---------------------------------------------------------------------------
# implicit-GEMM convolution
# ---------------------------------------------------------------------------

def conv2d_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                 pad: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the conv kernel: the zero-padded patch
    matrix, then one f32 ``torch.matmul``, cast to x's dtype."""
    kh, kw, C, OC = w.shape
    OH, OW = out_hw(x.shape[0], x.shape[1], kh, kw, stride, pad)
    patches = img2col_plain(x, kh, kw, stride, pad).to(torch.float32)
    out = patches @ w.reshape(kh * kw * C, OC).to(torch.float32)
    return out.to(x.dtype).reshape(OH, OW, OC)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           pad: int = 0) -> torch.Tensor:
    """Implicit-GEMM convolution, x ``(H, W, C)``, w ``(kh, kw, C, OC)`` ->
    ``(OH, OW, OC)``.  CPU tensor: the plain version; CUDA tensor: the
    kernel, or an exception."""
    if x.device.type == "cpu":
        return conv2d_plain(x, w, stride, pad)
    lib = build.library("img2col")  # a kernel that cannot be built raises
    _check_operand("conv2d", x, CONV_DTYPES)
    H, W, C = x.shape
    if (w.device != x.device or w.dtype != x.dtype or w.ndim != 4
            or w.shape[2] != C or not w.is_contiguous()):
        raise ValueError(f"conv2d: w must be a contiguous {x.dtype} "
                         f"(kh, kw, {C}, OC) tensor on {x.device}, got "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}")
    kh, kw, _, OC = w.shape
    OH, OW = out_hw(H, W, kh, kw, stride, pad)
    out = torch.empty((OH, OW, OC), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    M, K = OH * OW, kh * kw * C
    if max(M, K, x.numel(), w.numel(), out.numel()) >= _NARROW:
        raise ValueError(f"conv2d: sizes past the kernel's 32-bit indices "
                         f"(M={M}, K={K}, OC={OC})")
    rc = lib.conv2d(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                    DTYPE_CODES[x.dtype], H, W, C, kw, stride, pad, OW, M, OC,
                    K, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "conv2d")
    conv2d.launches += 1
    return out


conv2d.launches = 0
