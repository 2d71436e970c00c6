"""Generic coarse-grained TM kernel — the GPU address generator.

Two execution modes, selected by analyzing the :class:`MixedRadixMap` (the
"instruction decode" step of the TMU), exactly as the JAX package decides
them (:func:`analyze_block_mode` is a verbatim copy, so both packages pick
the same mode and report the same ``Lowering.segments``):

* **block mode** (:func:`tm_affine_block`) — the map is a signed axis
  permutation with block-aligned offsets and no out-of-bounds reads:
  ``in[src_axis[d]] = sign[d]·out[d] + offset[d]``.  Transpose, Rot90,
  Split/Route bands, Add.

* **gather mode** (:func:`tm_affine_gather`) — any (A, B) pair: PixelShuffle,
  Rearrange, Upsample, reshape, pad/crop with fill.  Out-of-bounds elements
  always read ``fill`` (like the JAX package's gather kernel, and unlike
  the engine, which applies fill only when ``m.oob_possible``).

Each mode has a hand-written CUDA kernel (``csrc/tm_affine.cu``) and a plain
PyTorch version of the same function beside it.  The wrapper runs the plain
version for a CPU tensor and the kernel for a CUDA tensor; ``launches``
counts kernel launches.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from repro_torch.core.affine import MixedRadixMap
from repro_torch.core.engine import EW_FNS, _row_int_form, gather_indices
from repro_torch.core.schedule import CycleParams
from repro_torch.core.spec import row_major_strides
from repro_torch.kernels import build

# ---------------------------------------------------------------------------
# block-mode analysis
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Lifted block-level form of a signed-permutation affine map.

    For out axis ``i``: input axis ``src_axis[i]`` supplies the data;
    ``sign[i]`` = ±1 (−1 ⇒ reversed); ``offset[i]`` = constant shift in
    elements.  Validity: in_coord[src_axis[i]] = sign[i]·out_coord[i] +
    offset[i], offsets divisible by the chosen block size.
    """

    src_axis: tuple[int, ...]
    sign: tuple[int, ...]
    offset: tuple[int, ...]
    block: tuple[int, ...]          # out-block shape
    grid: tuple[int, ...]           # out grid
    perm: tuple[int, ...]           # in-block axis permutation for the body


def analyze_block_mode(m: MixedRadixMap,
                       block: tuple[int, ...] | None = None,
                       segment_bytes: int | None = None) -> BlockPlan | None:
    """Return a BlockPlan if the map is a signed permutation w/ liftable offsets.

    ``segment_bytes`` bounds the block (one ping-pong buffer) — the same
    constant the cycle model segments with (:class:`CycleParams`), so the
    kernel grid and the schedule's block-iteration count agree."""
    if m.splits or m.digit_bounds or m.oob_possible:
        return None  # block mode has no validity mask: OOB fill needs gather
    n_out, n_in = len(m.out_shape), len(m.in_shape)
    if n_out != n_in:
        return None
    src_of_in: dict[int, tuple[int, int, int]] = {}  # in_axis -> (out_axis, sign, off)
    for i, (row, off) in enumerate(zip(m.affine.A, m.affine.b)):
        nz = [(j, a) for j, a in enumerate(row) if a != 0]
        if len(nz) != 1:
            return None
        j, a = nz[0]
        if a not in (1, -1) or off.denominator != 1:
            return None
        src_of_in[i] = (j, int(a), int(off))
    if len(src_of_in) != n_in:
        return None
    # invert: for each out axis, which in axis it feeds
    src_axis = [0] * n_out
    sign = [1] * n_out
    offset = [0] * n_out
    for in_ax, (out_ax, s, off) in src_of_in.items():
        src_axis[out_ax] = in_ax
        sign[out_ax] = s
        offset[out_ax] = off
    if block is None:
        block = _default_block(m.out_shape, segment_bytes)
    grid = []
    for d, (size, bs) in enumerate(zip(m.out_shape, block)):
        if size % bs:
            return None
        # offsets must be block-aligned on the *input* axis; block size on the
        # input axis equals bs (same axis pairing).  sign=+1: in = out + off,
        # alignment needs off % bs == 0.  sign=-1: in = off - out, the block
        # image is [off-(g+1)bs+1, off-g·bs] — one block iff (off+1) % bs == 0.
        if sign[d] > 0 and offset[d] % bs:
            return None
        if sign[d] < 0 and (offset[d] + 1) % bs:
            return None
        if m.in_shape[src_axis[d]] % bs:
            return None
        grid.append(size // bs)
    # perm for the body: out-block axes gather from in-block axes src_axis
    return BlockPlan(tuple(src_axis), tuple(sign), tuple(offset),
                     tuple(block), tuple(grid), tuple(src_axis))


def _default_block(shape: tuple[int, ...],
                   segment_bytes: int | None = None) -> tuple[int, ...]:
    """(…, 8·k, 128·m)-aligned blocks sized to one ping-pong segment.

    The budget is ``CycleParams.segment_bytes`` — the block IS the schedule
    pass's block iteration, so grid size == the cycle model's segment count.
    Minor/sublane dims first, then leading dims grow greedily (largest
    divisor that still fits), so small tensors collapse to a single block."""
    budget = segment_bytes if segment_bytes is not None \
        else CycleParams().segment_bytes
    itemsize = 4
    blk = list(shape)
    if len(shape) >= 1:
        blk[-1] = min(shape[-1], 128) if shape[-1] % 128 == 0 or shape[-1] < 128 \
            else math.gcd(shape[-1], 128)
    if len(shape) >= 2:
        blk[-2] = math.gcd(shape[-2], 256)
        # gcd with 256 is a power of two: halving keeps it a divisor
        while math.prod(blk[-2:]) * itemsize > budget and blk[-2] > 8:
            blk[-2] //= 2
    for d in range(len(shape) - 3, -1, -1):
        blk[d] = 1
    for d in range(len(shape) - 3, -1, -1):
        cap = budget // max(1, math.prod(blk) * itemsize // max(1, blk[d]))
        blk[d] = _largest_divisor_at_most(shape[d], cap)
    return tuple(blk)


def _largest_divisor_at_most(n: int, cap: int) -> int:
    if cap >= n:
        return n
    best, i = 1, 1
    while i * i <= n:
        if n % i == 0:
            for k in (i, n // i):
                if best < k <= cap:
                    best = k
        i += 1
    return best


# the decode of a map, memoized: MixedRadixMap is frozen and hashable, and
# the dispatch rule and the kernel entry both ask for it on every call
plan_cached = functools.lru_cache(maxsize=512)(analyze_block_mode)


# ---------------------------------------------------------------------------
# shared by both modes
# ---------------------------------------------------------------------------

DTYPE_CODES = {torch.int8: 0, torch.int32: 1, torch.bfloat16: 2,
               torch.float32: 3}
EW_CODES = {None: 0, "add": 1, "sub": 2, "mul": 3, "max": 4}
MAX_AXES = 12  # register-file width of the kernels (csrc/tm_affine.cu)


def _epilogue(out: torch.Tensor, y: torch.Tensor | None,
              ew: str | None) -> torch.Tensor:
    return out if ew is None else EW_FNS[ew](out, y)


def _check_launch(name: str, x: torch.Tensor, m: MixedRadixMap,
                  y: torch.Tensor | None, ew: str | None) -> None:
    """What the kernels take: contiguous CUDA tensors of one of the four
    dtypes, ``x`` shaped ``m.in_shape``, ``y`` (epilogue operand) shaped
    ``m.out_shape`` with the same dtype and device."""
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if tuple(x.shape) != tuple(m.in_shape):
        raise ValueError(f"{name}: x shape {tuple(x.shape)} != map in_shape "
                         f"{m.in_shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if ew not in EW_CODES:
        raise ValueError(f"{name}: unknown element-wise op {ew!r}")
    if (y is None) != (ew is None):
        raise ValueError(f"{name}: y and ew go together")
    if y is not None:
        if (y.device != x.device or y.dtype != x.dtype
                or tuple(y.shape) != tuple(m.out_shape)
                or not y.is_contiguous()):
            raise ValueError(
                f"{name}: epilogue operand must be a contiguous {x.dtype} "
                f"tensor of shape {m.out_shape} on {x.device}")
    if max(len(m.out_shape), len(m.in_shape), len(m.splits),
           len(m.digit_bounds)) > MAX_AXES:
        raise ValueError(f"{name}: map exceeds the kernel's {MAX_AXES} axes, "
                         f"digit splits or digit bounds")


def _launch(wrapper, x: torch.Tensor, m: MixedRadixMap,
            regs: Callable[[], tuple[torch.Tensor, bool]],
            y: torch.Tensor | None, ew: str | None,
            *extra: int) -> torch.Tensor:
    """Launch ``wrapper``'s kernel with the register file ``regs()`` and add
    one to ``wrapper.launches``.  An empty output launches nothing and
    counts nothing."""
    out = torch.empty(m.out_shape, dtype=x.dtype, device=x.device)
    n = out.numel()
    if n == 0:
        return out
    name = wrapper.__name__
    fn = getattr(build.library("tm_affine"), name)
    table, narrow = regs()
    rc = fn(x.data_ptr(), None if y is None else y.data_ptr(), out.data_ptr(),
            table.data_ptr(), DTYPE_CODES[x.dtype], EW_CODES[ew], n,
            int(narrow), *extra,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, name)
    wrapper.launches += 1
    return out


# ---------------------------------------------------------------------------
# block mode
# ---------------------------------------------------------------------------

def block_plain(x: torch.Tensor, m: MixedRadixMap, plan: BlockPlan, *,
                y: torch.Tensor | None = None,
                ew: str | None = None) -> torch.Tensor:
    """Plain PyTorch version of the block kernel: permute the input axes into
    output order, cut each axis's window, flip the reversed ones."""
    v = x.permute(plan.src_axis)
    for d, (n, s, off) in enumerate(zip(m.out_shape, plan.sign, plan.offset)):
        start = off if s > 0 else off - n + 1
        v = v.narrow(d, start, n)
    flips = [d for d, s in enumerate(plan.sign) if s < 0]
    if flips:
        v = v.flip(flips)
    return _epilogue(v.contiguous(), y, ew)


_NARROW = 2 ** 31  # indices below this take the kernels' 32-bit path


def _magic(d: int) -> tuple[int, int]:
    """Multiply-high magic number and shifts (sh1 | sh2 << 8) for unsigned
    32-bit division by ``d`` (Granlund-Montgomery; csrc/tm_affine.cu)."""
    if d >= 2 ** 32:
        return 0, 0  # only 64-bit coordinates divide by it, plainly
    ell = (d - 1).bit_length()  # ceil(log2 d)
    m = (2 ** 32 * (2 ** ell - d)) // d + 1
    return m, min(ell, 1) | (max(ell - 1, 0) << 8)


@functools.lru_cache(maxsize=512)
def _block_regs(m: MixedRadixMap, plan: BlockPlan,
                device: torch.device) -> tuple[torch.Tensor, bool]:
    """The block kernel's register file (layout in csrc/tm_affine.cu):
    source flat index = base + sum_d coef[d]·out[d]; and whether every
    partial sum fits the 32-bit path."""
    in_strides = row_major_strides(m.in_shape)
    regs = [0] * (2 + 4 * MAX_AXES)
    regs[0] = len(m.out_shape)
    regs[1] = sum(off * in_strides[a] for off, a in zip(plan.offset,
                                                        plan.src_axis))
    reach = abs(regs[1])
    for d, (size, s, a) in enumerate(zip(m.out_shape, plan.sign,
                                         plan.src_axis)):
        regs[2 + d] = size
        regs[2 + MAX_AXES + d] = s * in_strides[a]
        regs[2 + 2 * MAX_AXES + d], regs[2 + 3 * MAX_AXES + d] = _magic(size)
        reach += abs(s * in_strides[a]) * (size - 1)
    narrow = math.prod(m.out_shape) < _NARROW and reach < _NARROW
    return torch.tensor(regs, dtype=torch.int64, device=device), narrow


def tm_affine_block(x: torch.Tensor, m: MixedRadixMap, plan: BlockPlan, *,
                    y: torch.Tensor | None = None,
                    ew: str | None = None) -> torch.Tensor:
    """Block-mode map ``m`` (decoded into ``plan``) with an optional fused
    element-wise epilogue ``ew(map(x), y)``.  CPU tensor: the plain
    version; CUDA tensor: the kernel, or an exception."""
    if x.device.type == "cpu":
        return block_plain(x, m, plan, y=y, ew=ew)
    build.library("tm_affine")  # a kernel that cannot be built raises here
    _check_launch("tm_affine_block", x, m, y, ew)
    return _launch(tm_affine_block, x, m,
                   functools.partial(_block_regs, m, plan, x.device), y, ew)


tm_affine_block.launches = 0


# ---------------------------------------------------------------------------
# gather mode
# ---------------------------------------------------------------------------

def gather_plain(x: torch.Tensor, m: MixedRadixMap, *,
                 y: torch.Tensor | None = None,
                 ew: str | None = None) -> torch.Tensor:
    """Plain PyTorch version of the gather kernel: flat source index and
    validity per output element, ``fill`` wherever invalid."""
    flat, valid = gather_indices(m, x.device)
    out = x.reshape(-1)[flat]
    fill = torch.tensor(m.fill, dtype=x.dtype, device=x.device)
    return _epilogue(torch.where(valid, out, fill), y, ew)


@functools.lru_cache(maxsize=256)
def _fill_bits(fill: float, dtype: torch.dtype) -> int:
    """The fill register: ``fill`` in ``dtype``, its bytes as an int."""
    raw = torch.tensor([fill], dtype=dtype).view(torch.uint8).tolist()
    return int.from_bytes(bytes(raw), "little")


def _digit_max(m: MixedRadixMap) -> list[int]:
    """The largest value each digit takes (quotients, then remainders)."""
    q = [s - 1 for s in m.out_shape]
    r = []
    for sp in m.splits:
        r.append(min(sp.radix - 1, q[sp.axis]))
        q[sp.axis] //= sp.radix
    return q + r


def _row_reach(nums, offn, dmax) -> tuple[int, int, int]:
    """(lowest, highest, largest partial magnitude) of one row's numerator
    over digits in [0, dmax]."""
    lo = hi = offn
    mag = abs(offn)
    for v, top in zip(nums, dmax):
        lo += min(0, v * top)
        hi += max(0, v * top)
        mag += abs(v) * top
    return lo, hi, mag


@functools.lru_cache(maxsize=512)
def _gather_regs(m: MixedRadixMap, dtype: torch.dtype,
                 device: torch.device) -> tuple[torch.Tensor, bool]:
    """The gather kernel's register file (layout in csrc/tm_affine.cu) and
    whether the 32-bit path is exact for it.

    Besides the map's own registers (digit splits, integer affine rows as
    non-zero numerators, denominators, in_shape, strides, digit bounds) it
    holds the magic numbers of every divisor and, per row, whether the row
    can leave in_shape — decided from the digits' ranges, where a bounded
    digit counts only below its bound (past it the element reads fill)."""
    n_out, n_in, n_sp = len(m.out_shape), len(m.in_shape), len(m.splits)
    nnz = MAX_AXES * 2 * MAX_AXES
    rows_at, bounds_at = 92, 92 + 7 * MAX_AXES
    nz_at = bounds_at + 2 * MAX_AXES
    regs = [0] * (nz_at + 2 * nnz)
    regs[0:6] = [n_out, n_in, n_sp, _fill_bits(m.fill, dtype),
                 len(m.digit_bounds), max(1, math.prod(m.in_shape))]
    for a, size in enumerate(m.out_shape):
        regs[8 + a] = size
        regs[20 + a], regs[32 + a] = _magic(size)
    for j, sp in enumerate(m.splits):
        regs[44 + j], regs[56 + j] = sp.axis, sp.radix
        regs[68 + j], regs[80 + j] = _magic(sp.radix)
    dmax = _digit_max(m)
    bounded = list(dmax)
    for k, (d, bound) in enumerate(m.digit_bounds):
        regs[bounds_at + k] = d
        regs[bounds_at + MAX_AXES + k] = bound
        bounded[d] = min(bounded[d], bound - 1)
    strides = row_major_strides(m.in_shape)
    narrow = (math.prod(m.out_shape) < _NARROW
              and math.prod(m.in_shape) < _NARROW)
    flat_reach = 0
    k = 0
    for r, (row, off) in enumerate(zip(m.affine.A, m.affine.b)):
        nums, offn, den = _row_int_form(row, off)
        start = k
        for t, v in enumerate(nums):
            if v:
                regs[nz_at + k], regs[nz_at + nnz + k] = t, v
                k += 1
        lo, hi, _ = _row_reach(nums, offn, bounded)
        checked = (min(bounded) < 0 or lo // den < 0
                   or hi // den > m.in_shape[r] - 1)
        ulo, uhi, mag = _row_reach(nums, offn, dmax)
        narrow = narrow and mag < _NARROW
        flat_reach += (m.in_shape[r] - 1 if checked
                       else max(abs(ulo // den), abs(uhi // den))) * strides[r]
        regs[rows_at + 7 * r: rows_at + 7 * r + 7] = [
            offn, den, m.in_shape[r], strides[r], start, k, int(checked)]
    narrow = narrow and flat_reach < _NARROW
    return torch.tensor(regs, dtype=torch.int64, device=device), narrow


def tm_affine_gather(x: torch.Tensor, m: MixedRadixMap, *,
                     y: torch.Tensor | None = None,
                     ew: str | None = None) -> torch.Tensor:
    """Gather-mode map ``m`` with an optional fused element-wise epilogue.
    CPU tensor: the plain version; CUDA tensor: the kernel, which generates
    every source address from the map's registers, or an exception."""
    if x.device.type == "cpu":
        return gather_plain(x, m, y=y, ew=ew)
    build.library("tm_affine")  # a kernel that cannot be built raises here
    _check_launch("tm_affine_gather", x, m, y, ew)
    return _launch(tm_affine_gather, x, m,
                   functools.partial(_gather_regs, m, x.dtype, x.device),
                   y, ew, len(m.out_shape) + len(m.splits))


tm_affine_gather.launches = 0


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def tm_affine(x: torch.Tensor, m: MixedRadixMap, *,
              y: torch.Tensor | None = None, ew: str | None = None,
              segment_bytes: int | None = None) -> torch.Tensor:
    """Execute a MixedRadixMap (decode -> block | gather).

    ``y``/``ew``: optional fused element-wise epilogue ``ew(map(x), y)``
    (``ew`` is an ``EwOp`` value, ``y`` has ``m.out_shape``).
    ``segment_bytes`` is the ping-pong budget the decode sizes its blocks
    with; it decides the mode exactly as in the JAX package."""
    plan = plan_cached(m, None, segment_bytes)
    if plan is not None:
        return tm_affine_block(x, m, plan, y=y, ew=ew)
    return tm_affine_gather(x, m, y=y, ew=ew)
