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
  taps read zero.  Its kernel is the implicit-GEMM core of
  ``csrc/igemm.cuh`` (shared with the xchain commit), launched through the
  host plan :func:`conv_plan`.

Each wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor, and its ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

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
# the implicit-GEMM core's host plan (csrc/igemm.cuh)
# ---------------------------------------------------------------------------

CONV_PATHS = {"tma": 0, "cp.async": 1}  # how the A stages are filled
ROW_BYTES = 128    # bytes of K per row per stage (igemm.cuh kIgRowBytes)
TM = 8             # output rows per thread
MAX_THREADS = 192  # threads of a block (igemm.cuh kIgMaxThreads)
STAGES = (2, 3, 4)
SMS = 132          # SMs of an H100 SXM
# the card's limits per SM (H100): shared memory (of which each block
# reserves 1 KB more), registers, threads and blocks; the most shared
# memory one block may use
SM_SMEM, BLOCK_RESERVED, BLOCK_SMEM = 228 * 1024, 1024, 227 * 1024
SM_REGS, SM_THREADS, SM_BLOCKS = 65536, 2048, 32
STATIC_SMEM = 32   # the kernel's static shared memory (TMA box coordinates)
REGS = 168         # registers a thread may use (two blocks of 192 threads)


def tile_bn(N: int) -> int:
    """The tile width: N rounded up to 4 where N <= 32 (no FMA spent on
    padding past 3 columns), else column tiles of 64."""
    return -(-N // 4) * 4 if N <= 32 else 64


def col_threads(BN: int) -> tuple[int, ...]:
    """The choices of threads across a tile's columns: at BN = 64, 8 of 8
    columns or 16 of 4; else 4 of BN / 4."""
    return (8, 16) if BN == 64 else (4,)


def stage_bytes(BM: int, BN: int, itemsize: int, nct: int) -> int:
    """One ring stage: BM rows x 128 bytes of A, then the 128 / itemsize K
    rows of B widened to 4 bytes, column groups padded to 4 (1024-byte
    aligned, as igemm::prepare lays it out)."""
    bnp = -(-(BN // nct) // 4) * 4 * nct
    return -(-(BM * ROW_BYTES + ROW_BYTES // itemsize * bnp * 4) // 1024) * 1024


def smem_bytes(BM: int, BN: int, itemsize: int, stages: int,
               nct: int) -> int:
    """A block's dynamic shared memory: the stages, 4 full and 4 empty
    mbarriers and 1024 bytes of alignment slack (igemm::prepare)."""
    return stages * stage_bytes(BM, BN, itemsize, nct) + 16 * 4 + 1024


def model_occupancy(threads: int, smem: int, regs: int = REGS) -> int:
    """Blocks an SM holds by the card's limits, where the card cannot be
    asked: registers are allocated per warp in units of 256."""
    warp_regs = -(-regs * 32 // 256) * 256
    by_regs = SM_REGS // (warp_regs * (threads // 32))
    used = -(-(smem + STATIC_SMEM) // 128) * 128 + BLOCK_RESERVED
    return min(by_regs, SM_SMEM // used, SM_THREADS // threads, SM_BLOCKS)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """The core's launch: ``path`` fills the A stages (``tma``: im2col or
    2-d boxes; ``cp.async``), output tiles of ``BM`` x ``BN`` by
    ``threads`` threads, ``nct`` of them across the columns (8 rows by
    ``BN / nct`` columns a thread), ``stages`` ring stages of ``smem``
    bytes in all, ``blocks_per_sm`` blocks on each of ``sms`` SMs, ``grid``
    persistent blocks over ``tiles`` tiles of ``k_steps`` K steps each."""

    path: str
    BM: int
    BN: int
    nct: int
    stages: int
    threads: int
    smem: int
    blocks_per_sm: int
    sms: int
    tiles: int
    grid: int
    k_steps: int

    @property
    def rounds(self) -> int:
        """Rounds of tiles over the card's blocks (blocks an SM x SMs)."""
        return -(-self.tiles // (self.blocks_per_sm * self.sms))

    @property
    def last_fill(self) -> float:
        """The share of the card's blocks that have a tile in the last
        round."""
        slots = self.blocks_per_sm * self.sms
        return (self.tiles - (self.rounds - 1) * slots) / slots

    @property
    def warps(self) -> int:
        """Warps on the busiest SM: its blocks (at most what it holds)
        times each block's warps."""
        return (min(self.blocks_per_sm, -(-self.grid // self.sms))
                * self.threads // 32)

    @property
    def sm_rows(self) -> int:
        """Output rows on the busiest SM: its blocks times each block's
        tiles times BM."""
        return (-(-self.grid // self.sms) * -(-self.tiles // self.grid)
                * self.BM)


def conv_plan(M: int, N: int, K: int, dtype: torch.dtype, *, tma: bool,
              C: int | None = None, taps: int = 1, sms: int = SMS,
              occupancy: Callable[[int, int, int], int] | None = None
              ) -> ConvPlan:
    """The launch of an (M, K) x (K, N) implicit GEMM: a conv of C channels
    over ``taps`` filter taps (K = taps C), or an mm (``C`` None).

    ``tma``: the caller found that TMA can take A (:func:`conv_tma_ok`;
    for the commit's mm, 16-byte rows); then a conv's K steps are the
    filter taps by chunks of 128 bytes of channels, else K runs densely in
    128-byte steps.  Per candidate column threads (:func:`col_threads`), BM
    (threads a multiple of 32, 64 to 192) and stage count, the blocks an SM
    holds come from ``occupancy(nct, threads, smem)`` (the card's own
    answer on the card; :func:`model_occupancy` otherwise).  The plan takes
    the most warps an SM holds up to 12 (3 a scheduler: the FMA loop alone
    reached 0.62 of 67 TFLOP/s with 12, 0.45 with 8, on the H100), then
    the fewest output rows on the busiest SM (``ConvPlan.sm_rows``): the
    last round as full as BM allows (EDSR's body conv, M = 50176: BM 192,
    262 tiles on 2 x 132 blocks, 99% full), then the most warps the
    busiest SM runs (``ConvPlan.warps``).  Ties go to the wider thread
    tile (8 x 8 before 8 x 4: fewer shared loads an FMA), then the larger
    BM, then more stages.  So 8 x 4 tiles run only where 8 x 8 ones would
    leave the SMs short of warps on the same rows (the YOLO neck's 1x1
    conv, M = 6272 by N = 255: 132 tiles of 192 x 64 run 6 warps an SM,
    264 tiles of 96 x 64 run 12)."""
    occupancy = occupancy or (lambda nct, threads, smem:
                              model_occupancy(threads, smem))
    itemsize = torch.empty((), dtype=dtype).element_size()
    BN = tile_bn(N)
    bk = ROW_BYTES // itemsize
    if K == 0:
        k_steps = 0
    elif tma and C is not None:
        k_steps = taps * -(-C // bk)
    else:
        k_steps = -(-K // bk)
    n_tiles = -(-N // BN)
    best = None
    for nct in col_threads(BN):
        for BM in range(64 * 8 // nct, MAX_THREADS * TM // nct + 1,
                        max(32, 256 // nct)):
            threads = BM // TM * nct
            tiles = -(-M // BM) * n_tiles
            for stages in STAGES:
                smem = smem_bytes(BM, BN, itemsize, stages, nct)
                if smem > BLOCK_SMEM:
                    continue
                bps = occupancy(nct, threads, smem)
                if bps < 1:
                    continue
                plan = ConvPlan("tma" if tma else "cp.async", BM, BN, nct,
                                stages, threads, smem, bps, sms, tiles,
                                min(tiles, bps * sms), k_steps)
                # the FMA loop needs 3 warps a scheduler (12 an SM) to run
                # near its best: more warps an SM holds first, then fewer
                # rows on the busiest SM, then more warps on it
                key = (-min(threads * bps // 32, 12), plan.sm_rows,
                       -min(plan.warps, 12), nct, -BM, -stages)
                if best is None or key < best[0]:
                    best = (key, plan)
    if best is None:
        raise ValueError(f"conv_plan: no tile fits ({M}, {K}) x ({K}, {N}) "
                         f"{dtype}")
    return best[1]


def conv_tma_ok(x: torch.Tensor, C: int, H: int, W: int, OH: int, OW: int,
                stride: int, pt: int, pl: int) -> bool:
    """Whether TMA's im2col mode can fetch the conv's patches: a 16-byte
    aligned x whose pixels are a multiple of 16 bytes, a stride of at most 8
    and a bounding box whose corners (the padding; the far sides' slack)
    fit a 4-d tensor map's [-128, 127]."""
    corners = (-pl, -pt, (OW - 1) * stride - pl - (W - 1),
               (OH - 1) * stride - pt - (H - 1))
    return (C >= 1 and (C * x.element_size()) % 16 == 0
            and x.data_ptr() % 16 == 0 and stride <= 8
            and all(-128 <= c <= 127 for c in corners))


_PLANS: dict = {}


def card_plan(lib, name: str, x: torch.Tensor, M: int, N: int, K: int, *,
              tma: bool, C: int | None = None, taps: int = 1) -> ConvPlan:
    """:func:`conv_plan` on the card of ``x``, asking the library's
    ``<name>_blocks(dtype, bn, nct, threads, smem)`` entry point how many
    blocks of the kernel an SM holds; cached per kernel, geometry and
    device."""
    key = (name, x.device, x.dtype, M, N, K, tma, C, taps)
    plan = _PLANS.get(key)
    if plan is None:
        code, bn = DTYPE_CODES[x.dtype], tile_bn(N)

        def occupancy(nct: int, threads: int, smem: int) -> int:
            n = getattr(lib, f"{name}_blocks")(code, bn, nct, threads, smem)
            if n < 0:
                raise RuntimeError(f"occupancy query: CUDA error {-n}")
            return n

        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = _PLANS[key] = conv_plan(M, N, K, x.dtype, tma=tma, C=C,
                                       taps=taps, sms=sms,
                                       occupancy=occupancy)
    return plan


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
    _launch_conv(lib, x, w, out, stride, pad, probe=0)
    conv2d.launches += 1
    return out


def _launch_conv(lib, x, w, out, stride: int, pad: int, *, probe: int
                 ) -> None:
    H, W, C = x.shape
    kh, kw, _, OC = w.shape
    OH, OW, _ = out.shape
    K = kh * kw * C
    if max(OH * OW, K, x.numel(), w.numel(), out.numel()) >= _NARROW:
        raise ValueError(f"conv2d: sizes past the kernel's 32-bit indices "
                         f"(M={OH * OW}, K={K}, OC={OC})")
    plan = conv2d_plan(x, w, stride, pad)
    rc = lib.conv2d(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                    DTYPE_CODES[x.dtype], H, W, C, kh, kw, stride, pad, OH,
                    OW, OC, CONV_PATHS[plan.path], plan.BM, plan.BN,
                    plan.nct, plan.stages, plan.blocks_per_sm, plan.grid,
                    probe,
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "conv2d")


def conv2d_plan(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                pad: int = 0) -> ConvPlan:
    """The plan :func:`conv2d` launches with for these CUDA operands."""
    lib = build.library("img2col")
    H, W, C = x.shape
    kh, kw, _, OC = w.shape
    OH, OW = out_hw(H, W, kh, kw, stride, pad)
    return card_plan(lib, "conv2d", x, OH * OW, OC, kh * kw * C,
                     tma=conv_tma_ok(x, C, H, W, OH, OW, stride, pad, pad),
                     C=C, taps=kh * kw)


def conv2d_fma_probe(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     pad: int = 0) -> torch.Tensor:
    """The conv kernel's FMA loop alone, at :func:`conv2d`'s plan for these
    operands: the same tiles and K steps over operands already in shared
    memory (zeros), no loads and no waits.  For timing only: the output is
    not the conv, and no launch is counted."""
    lib = build.library("img2col")
    _check_operand("conv2d", x, CONV_DTYPES)
    kh, kw, _, OC = w.shape
    OH, OW = out_hw(x.shape[0], x.shape[1], kh, kw, stride, pad)
    out = torch.empty((OH, OW, OC), dtype=x.dtype, device=x.device)
    _launch_conv(lib, x, w, out, stride, pad, probe=1)
    return out


conv2d.launches = 0
