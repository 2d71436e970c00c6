"""Tiled matmul with TM-epilogue output forwarding (paper Fig. 5c).

The paper's output-forwarding strategy lets the TMU begin the next TM op on
*partial* compute-engine output tiles.  The kernel analogue: apply the TM
op inside the matmul's store — each finished output tile is written
straight to its TM-transformed destination (block placement and the
in-tile transform: transpose, pixel shuffle, a split band), so the
manipulation completes the moment the product does, with no extra round
trip through device memory.

One hand-written CUDA kernel (``csrc/matmul_tm.cu``, ``mm_tm_kernel``: a
streamed tall-skinny product, A through a ring of shared-memory stages fed
by TMA or cp.async, B resident in shared memory, the store staged in the
destination's order) beside its plain PyTorch version
:func:`matmul_tm_plain`; the wrapper :func:`matmul_tm` runs the plain
version for a CPU tensor and the kernel for a CUDA tensor, with the plan
:func:`mm_plan` picks, and ``matmul_tm.launches`` counts kernel launches.
Both accumulate in f32 (integers: the exact sum, wrapped to the element
type) and round once to x's dtype, as the JAX package's ``_mm_kernel``
casts its f32 accumulator at commit.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.tm_affine.tm_affine import DTYPE_CODES

MODES = {"identity": 0, "transpose": 1, "pixel_shuffle": 2}
PATHS = {"tma": 0, "cp.async": 1}  # how the kernel's A stages are filled
MM_BM = 512     # rows of the kernel's output tile (csrc/matmul_tm.cu kMmBM)
MM_MAX_BN = 32  # widest column tile


@dataclasses.dataclass(frozen=True)
class MmPlan:
    """The kernel's launch plan: ``path`` fills the A stages (``tma``, or
    ``cp.async`` where TMA cannot take the rows), output tiles of ``BM``
    rows by ``BN`` columns."""

    path: str
    BM: int
    BN: int


def mm_plan(M: int, K: int, N: int, dtype: torch.dtype,
            x_aligned: bool = True) -> MmPlan:
    """TMA where x's row pitch ``K · itemsize`` is a multiple of 16 bytes
    (and x is 16-byte aligned), as a tensor map requires; ``cp.async``
    otherwise.  ``BN`` is N rounded up to a multiple of 4 when N <= 32, so
    a narrow product spends no FMA on padding; wider products take column
    tiles of 32 (each thread holds 8 rows x BN / 2 columns)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    tma = K >= 1 and (K * itemsize) % 16 == 0 and x_aligned
    BN = -(-N // 4) * 4 if N <= MM_MAX_BN else MM_MAX_BN
    return MmPlan("tma" if tma else "cp.async", MM_BM, BN)


def block_div(n: int, b: int) -> int:
    """Largest block size <= ``b`` that divides ``n`` (>= 1) — the JAX
    wrappers' divisor clamp, so odd dims never hand Pallas a grid whose
    blocks do not tile the array.  The CUDA kernel masks its ragged edge
    tiles instead, so the port's wrappers need no clamp; this stays the
    JAX package's function for the block sizes its grids use."""
    b = max(1, min(int(b), int(n)))
    while n % b:
        b -= 1
    return b


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Where the product's tiles land.

    ``mode``: ``identity`` (out (M, N)), ``transpose`` (out (N, M)), or
    ``pixel_shuffle`` (rows are the H x W pixels in raster order, columns
    the C s^2 channels c-major; out (H s, W s, C)).  ``col0``/``ncols``
    select a band of w's columns (the split epilogue: out (M, ncols))."""

    mode: str = "identity"
    H: int = 0
    W: int = 0
    C: int = 0
    s: int = 0
    col0: int = 0
    ncols: int | None = None

    def out_shape(self, M: int, N: int) -> tuple[int, ...]:
        if self.mode == "transpose":
            return (N, M)
        if self.mode == "pixel_shuffle":
            return (self.H * self.s, self.W * self.s, self.C)
        return (M, N)


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as the kernel computes it: f32 accumulation for floats,
    rounded once to x's dtype; for integers the exact sum (int64) wrapped
    to x's dtype — what an integer mm gives, whatever order it adds in."""
    if x.dtype.is_floating_point:
        return (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)
    if x.device.type == "cpu":
        return (x.to(torch.int64) @ w.to(torch.int64)).to(x.dtype)
    # CUDA has no integer mm: sum the rank-one terms in int64
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64,
                      device=x.device)
    for k in range(x.shape[1]):
        acc += x[:, k, None].to(torch.int64) * w[None, k, :].to(torch.int64)
    return acc.to(x.dtype)


def matmul_tm_plain(x: torch.Tensor, w: torch.Tensor,
                    ep: Epilogue = Epilogue()) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the product, then the
    epilogue's placement."""
    ncols = w.shape[1] - ep.col0 if ep.ncols is None else ep.ncols
    y = _product(x, w[:, ep.col0:ep.col0 + ncols])
    if ep.mode == "transpose":
        return y.T.contiguous()
    if ep.mode == "pixel_shuffle":
        s = ep.s
        return (y.reshape(ep.H, ep.W, ep.C, s, s).permute(0, 3, 1, 4, 2)
                .reshape(ep.H * s, ep.W * s, ep.C))
    return y


def _check(x: torch.Tensor, w: torch.Tensor, ep: Epilogue) -> int:
    if not x.is_cuda:
        raise ValueError(f"matmul_tm: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"matmul_tm: unsupported dtype {x.dtype}")
    if (x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]
            or w.dtype != x.dtype or w.device != x.device
            or not x.is_contiguous() or not w.is_contiguous()):
        raise ValueError(f"matmul_tm: x (M, K) and w (K, N) must be "
                         f"contiguous {x.dtype} tensors on one device, got "
                         f"{tuple(x.shape)} {w.dtype} {tuple(w.shape)}")
    if ep.mode not in MODES:
        raise ValueError(f"matmul_tm: unknown epilogue {ep.mode!r}")
    ncols = w.shape[1] - ep.col0 if ep.ncols is None else ep.ncols
    if ep.col0 < 0 or ncols < 1 or ep.col0 + ncols > w.shape[1]:
        raise ValueError(f"matmul_tm: band [{ep.col0}, {ep.col0 + ncols}) "
                         f"outside w's {w.shape[1]} columns")
    if ep.mode == "pixel_shuffle" and (
            ep.H * ep.W != x.shape[0] or ep.C * ep.s * ep.s != ncols):
        raise ValueError("matmul_tm: pixel shuffle needs M = H W and "
                         "N = C s^2")
    return ncols


def matmul_tm(x: torch.Tensor, w: torch.Tensor,
              ep: Epilogue = Epilogue()) -> torch.Tensor:
    """``TM(x @ w)`` with the TM op folded into the store.  CPU tensor: the
    plain version; CUDA tensor: the kernel, or an exception."""
    if x.device.type == "cpu":
        return matmul_tm_plain(x, w, ep)
    lib = build.library("matmul_tm")  # a kernel that cannot be built raises
    ncols = _check(x, w, ep)
    M, K = x.shape
    out = torch.empty(ep.out_shape(M, ncols), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = mm_plan(M, K, ncols, x.dtype, x.data_ptr() % 16 == 0)
    rc = lib.matmul_tm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                       DTYPE_CODES[x.dtype], M, ncols, K, w.shape[1],
                       ep.col0, MODES[ep.mode], ep.H, ep.W, ep.C, ep.s,
                       PATHS[plan.path], plan.BN,
                       torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "matmul_tm")
    matmul_tm.launches += 1
    return out


matmul_tm.launches = 0
