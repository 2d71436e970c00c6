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

import numpy as np
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
            regs: Callable[[], tuple[torch.Tensor, bool, tuple[int, ...]]],
            y: torch.Tensor | None, ew: str | None) -> torch.Tensor:
    """Launch ``wrapper``'s kernel with the register file, the 32-bit flag
    and the entry point's further arguments that ``regs()`` gives, and add
    one to ``wrapper.launches``.  An empty output launches nothing and
    counts nothing."""
    out = torch.empty(m.out_shape, dtype=x.dtype, device=x.device)
    n = out.numel()
    if n == 0:
        return out
    name = wrapper.__name__
    fn = getattr(build.library("tm_affine"), name)
    table, narrow, extra = regs()
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


BLOCK_PATHS = {"scalar": 0, "vector": 1, "tile": 2}
BLOCK_WORDS = 2 + 4 * MAX_AXES  # the map's words of the block table
TILE_P, TILE_L = 32, 64  # the tile path's tile (csrc/tm_affine.cu kTileP/L)


@dataclasses.dataclass(frozen=True)
class BlockRegs:
    """The block kernel's register table and its launch: ``path`` and
    ``vbytes`` (the bytes each access moves) as the table's words 50-51
    hold them, and ``units`` (elements, vectors or tiles) of work."""

    table: torch.Tensor
    narrow: bool
    path: str
    vbytes: int
    units: int


def _map_words(base: int, shape, coef) -> list[int]:
    """Words 0-49 of the table (layout in csrc/tm_affine.cu): source flat
    index = base + sum_d coef[d]·out[d], and each extent's magic number."""
    regs = [0] * BLOCK_WORDS
    regs[0], regs[1] = len(shape), base
    for d, (size, c) in enumerate(zip(shape, coef)):
        regs[2 + d] = size
        regs[2 + MAX_AXES + d] = c
        regs[2 + 2 * MAX_AXES + d], regs[2 + 3 * MAX_AXES + d] = _magic(size)
    return regs


def block_path(shape: tuple[int, ...], coef: tuple[int, ...], base: int,
               itemsize: int, narrow: bool) -> tuple[str, int]:
    """The block kernel's path and bytes per access for the map
    ``base + sum_d coef[d]·out[d]`` over ``shape`` (32-bit maps only take
    the vector and tile paths):

    * ``vector`` where the innermost output axis reads with coefficient +1
      (each output row one contiguous source run), at the largest power of
      two V <= 16 bytes dividing the run, the base and every other
      coefficient in bytes, when V holds at least two elements;
    * ``tile`` where the innermost output axis reads with a stride other
      than ±1 and another output axis reads with coefficient +1;
    * ``scalar`` otherwise (a reversed innermost axis, 64-bit maps)."""
    if not narrow or not shape:
        return "scalar", itemsize
    if coef[-1] == 1:
        v = 16
        for b in (shape[-1], base, *coef[:-1]):
            while (b * itemsize) % v:
                v //= 2
        return ("vector", v) if v >= 2 * itemsize else ("scalar", itemsize)
    if abs(coef[-1]) != 1 and shape[-1] > 1 and _tile_axis(shape, coef) >= 0:
        return "tile", itemsize
    return "scalar", itemsize


def _tile_axis(shape, coef) -> int:
    """The output axis (not the innermost) that reads the source's
    innermost axis forward, or -1."""
    for d in range(len(shape) - 1):
        if coef[d] == 1 and shape[d] > 1:
            return d
    return -1


@functools.lru_cache(maxsize=512)
def _block_regs(m: MixedRadixMap, plan: BlockPlan, dtype: torch.dtype,
                device: torch.device) -> BlockRegs:
    """The block kernel's register table (layout in csrc/tm_affine.cu):
    the map's words (source flat index = base + sum_d coef[d]·out[d]), the
    path and bytes per access :func:`block_path` picks for ``dtype``, and
    the path's own words; and whether every partial sum fits the 32-bit
    path."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    in_strides = row_major_strides(m.in_shape)
    shape = tuple(m.out_shape)
    coef = tuple(s * in_strides[a] for s, a in zip(plan.sign, plan.src_axis))
    base = sum(off * in_strides[a] for off, a in zip(plan.offset,
                                                     plan.src_axis))
    reach = abs(base) + sum(abs(c) * (n - 1) for c, n in zip(coef, shape))
    numel = math.prod(shape)
    narrow = numel < _NARROW and reach < _NARROW
    path, vbytes = block_path(shape, coef, base, itemsize, narrow)
    extra = [0] * (2 + BLOCK_WORDS)
    extra[0], extra[1] = BLOCK_PATHS[path], vbytes
    units = numel
    if path == "vector":  # the same map over V-byte elements
        ve = vbytes // itemsize
        extra[2:] = _map_words(base // ve, shape[:-1] + (shape[-1] // ve,),
                               tuple(c // ve for c in coef[:-1]) + (1,))
        units = numel // ve
    elif path == "tile":
        p = _tile_axis(shape, coef)
        tp, tl = -(-shape[p] // TILE_P), -(-shape[-1] // TILE_L)
        extra[2:9] = [p, tp, *_magic(tp), tl, *_magic(tl)]
        units = numel // (shape[p] * shape[-1]) * tp * tl
    table = torch.tensor(_map_words(base, shape, coef) + extra,
                         dtype=torch.int64, device=device)
    return BlockRegs(table, narrow, path, vbytes, units)


def _block_launch(m: MixedRadixMap, plan: BlockPlan, x: torch.Tensor,
                  y: torch.Tensor | None):
    """The table and the entry point's (path, vbytes, units); a vector path
    whose x or y is not aligned to V runs the scalar path instead."""
    r = _block_regs(m, plan, x.dtype, x.device)
    path, vbytes, units = r.path, r.vbytes, r.units
    if path == "vector" and any(t is not None and t.data_ptr() % vbytes
                                for t in (x, y)):
        path, vbytes, units = "scalar", x.element_size(), math.prod(m.out_shape)
    return r.table, r.narrow, (BLOCK_PATHS[path], vbytes, units)


def tm_affine_block(x: torch.Tensor, m: MixedRadixMap, plan: BlockPlan, *,
                    y: torch.Tensor | None = None,
                    ew: str | None = None) -> torch.Tensor:
    """Block-mode map ``m`` (decoded into ``plan``) with an optional fused
    element-wise epilogue ``ew(map(x), y)``.  CPU tensor: the plain
    version; CUDA tensor: the kernel (its vector, tile or scalar path), or
    an exception."""
    if x.device.type == "cpu":
        return block_plain(x, m, plan, y=y, ew=ew)
    build.library("tm_affine")  # a kernel that cannot be built raises here
    _check_launch("tm_affine_block", x, m, y, ew)
    return _launch(tm_affine_block, x, m,
                   functools.partial(_block_launch, m, plan, x, y), y, ew)


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


@dataclasses.dataclass(frozen=True)
class GatherRow:
    """Affine row ``r`` of a map in integer form: input coordinate
    ``floor((offn + sum_d nums[d]·digit[d]) / den)`` of extent ``size`` and
    row-major ``stride``; ``checked`` where the host could not prove it
    stays inside ``[0, size)`` (a bounded digit counts only below its
    bound: past it the element reads fill)."""

    nums: tuple[int, ...]
    offn: int
    den: int
    size: int
    stride: int
    checked: bool


@functools.lru_cache(maxsize=512)
def gather_rows(m: MixedRadixMap) -> tuple[tuple[GatherRow, ...], bool]:
    """The map's rows (:class:`GatherRow`) and whether every coordinate,
    row partial sum and flat index fits the kernels' 32-bit arithmetic."""
    dmax = _digit_max(m)
    bounded = list(dmax)
    for d, bound in m.digit_bounds:
        bounded[d] = min(bounded[d], bound - 1)
    strides = row_major_strides(m.in_shape)
    narrow = (math.prod(m.out_shape) < _NARROW
              and math.prod(m.in_shape) < _NARROW)
    flat_reach = 0
    rows = []
    for r, (row, off) in enumerate(zip(m.affine.A, m.affine.b)):
        nums, offn, den = _row_int_form(row, off)
        lo, hi, _ = _row_reach(nums, offn, bounded)
        checked = (min(bounded) < 0 or lo // den < 0
                   or hi // den > m.in_shape[r] - 1)
        ulo, uhi, mag = _row_reach(nums, offn, dmax)
        narrow = narrow and mag < _NARROW
        flat_reach += (m.in_shape[r] - 1 if checked
                       else max(abs(ulo // den), abs(uhi // den))) * strides[r]
        rows.append(GatherRow(nums, offn, den, m.in_shape[r], strides[r],
                              checked))
    return tuple(rows), narrow and flat_reach < _NARROW


@functools.lru_cache(maxsize=512)
def _gather_regs(m: MixedRadixMap, dtype: torch.dtype,
                 device: torch.device) -> tuple[torch.Tensor, bool]:
    """The general gather kernel's register file (layout in
    csrc/tm_affine.cu) and whether the 32-bit path is exact for it.

    Besides the map's own registers (digit splits, integer affine rows as
    non-zero numerators, denominators, in_shape, strides, digit bounds) it
    holds the magic numbers of every divisor and, per row, whether the row
    can leave in_shape (:func:`gather_rows`)."""
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
    for k, (d, bound) in enumerate(m.digit_bounds):
        regs[bounds_at + k] = d
        regs[bounds_at + MAX_AXES + k] = bound
    rows, narrow = gather_rows(m)
    k = 0
    for r, row in enumerate(rows):
        start = k
        for t, v in enumerate(row.nums):
            if v:
                regs[nz_at + k], regs[nz_at + nnz + k] = t, v
                k += 1
        regs[rows_at + 7 * r: rows_at + 7 * r + 7] = [
            row.offn, row.den, row.size, row.stride, start, k,
            int(row.checked)]
    return torch.tensor(regs, dtype=torch.int64, device=device), narrow


# the separable path (csrc/tm_affine.cu: sep_kernel)
GATHER_PATHS = {"general": 0, "separable": 1}
SEP_CAP = 8192            # entries of a run's table (kSepMaxTable)
SEP_INVALID = -2 ** 31    # a table entry that reads fill
SEP_WORDS = 180 + MAX_AXES * 2 * MAX_AXES  # the run decoder's table


@dataclasses.dataclass(frozen=True, eq=False)
class SepPlan:
    """The separable gather path of a map: output axes ``suffix``.. span
    runs of ``R`` consecutive output elements, and element ``p`` of run
    ``q`` reads ``base(q) + off[p]`` where both ``valid(q)`` and
    ``valid[p]`` hold, else ``fill``.  ``base`` and ``valid(q)`` come from
    the outer digits (the axes before the suffix, ``oshape``, split as the
    map splits them) through ``rows``: per row the offset numerator,
    denominator, extent, stride, checked flag and the numerators of the
    outer digits (the outer axes, then the remainders of ``osplits``);
    ``obounds`` are
    the digit bounds on outer digits.  ``vbytes`` is the access the map
    allows: 16 bytes where the runs read contiguous aligned groups of 16
    bytes, else the element size."""

    suffix: int
    R: int
    vbytes: int
    itemsize: int
    off: "np.ndarray"     # int64 (R,)
    valid: "np.ndarray"   # bool (R,)
    oshape: tuple[int, ...]
    osplits: tuple[tuple[int, int], ...]       # (outer axis, radix)
    obounds: tuple[tuple[int, int], ...]       # (outer digit, bound)
    rows: tuple[tuple[int, int, int, int, bool, tuple[int, ...]], ...]


def _outer_reach(row, dmax) -> int:
    """The largest |coordinate| an outer row can give, or its extent less
    one where it is checked (its coordinate is clamped)."""
    offn, den, size, _, checked, nums = row
    if checked:
        return size - 1
    lo, hi, _ = _row_reach(nums, offn, dmax)
    return max(abs(lo // den), abs(hi // den))


def _sep_build(m: MixedRadixMap, rows, s: int, R: int,
               itemsize: int) -> SepPlan | None:
    """The separable plan over the output suffix from axis ``s`` (``R``
    elements a run), or None where a partial sum would leave 32 bits."""
    n_out = len(m.out_shape)
    inner = np.unravel_index(np.arange(R, dtype=np.int64), m.out_shape[s:])
    digits = {a: np.asarray(inner[a - s], dtype=np.int64)
              for a in range(s, n_out)}
    compact = {a: a for a in range(s)}   # original digit -> outer digit
    oshape = tuple(m.out_shape[:s])
    osplits = []
    for j, sp in enumerate(m.splits):
        if sp.axis >= s:
            digits[sp.axis], digits[n_out + j] = np.divmod(digits[sp.axis],
                                                           sp.radix)
        else:
            compact[n_out + j] = s + len(osplits)
            osplits.append((sp.axis, sp.radix))
    n_odig = s + len(osplits)
    off = np.zeros(R, dtype=np.int64)
    valid = np.ones(R, dtype=bool)
    orows = []
    for row in rows:
        part = sum((v * digits[d] for d, v in enumerate(row.nums)
                    if v and d in digits), np.zeros(R, dtype=np.int64))
        outer = [0] * n_odig
        for d, v in enumerate(row.nums):
            if v and d not in digits:
                outer[compact[d]] = v
        if any(outer) or not any(v for d, v in enumerate(row.nums)
                                 if d in digits):
            # linear in the inner digits where it mixes: its offset and
            # outer digits go to the run's base
            off += part * row.stride
            orows.append((row.offn, row.den, row.size, row.stride,
                          row.checked, tuple(outer)))
            continue
        c = np.floor_divide(part + row.offn, row.den)
        if row.checked:
            valid &= (c >= 0) & (c < row.size)
            c = np.clip(c, 0, row.size - 1)
        off += c * row.stride
    obounds = []
    for d, bound in m.digit_bounds:
        if d in digits:
            valid &= digits[d] < bound
        else:
            obounds.append((compact[d], bound))
    # the outer digits' ranges: quotients, then remainders
    dmax = [n - 1 for n in oshape]
    rmax = []
    for a, radix in osplits:
        rmax.append(min(radix - 1, dmax[a]))
        dmax[a] //= radix
    dmax += rmax
    reach = sum(_outer_reach(r, dmax) * r[3] for r in orows)
    if reach >= _NARROW or (R and int(np.abs(off).max()) >= _NARROW):
        return None
    vbytes = itemsize
    if itemsize < 16 and _groups_ok(off, valid, 16 // itemsize, orows):
        vbytes = 16
    return SepPlan(s, R, vbytes, itemsize, off, valid, oshape,
                   tuple(osplits), tuple(obounds), tuple(orows))


def _groups_ok(off, valid, ve: int, orows) -> bool:
    """Whether runs move as aligned groups of ``ve`` elements: every outer
    stride (so every base) a multiple of ``ve``, and each group of the
    table wholly fill or ``ve`` consecutive elements from a multiple of
    ``ve``."""
    if len(off) % ve or any(r[3] % ve for r in orows):
        return False
    g, vg = off.reshape(-1, ve), valid.reshape(-1, ve)
    if not (vg.all(1) | ~vg.any(1)).all():
        return False
    run = ((g - g[:, :1]) == np.arange(ve)).all(1) & (g[:, 0] % ve == 0)
    return bool((run | ~vg[:, 0]).all())


@functools.lru_cache(maxsize=512)
def separable_plan(m: MixedRadixMap, itemsize: int) -> SepPlan | None:
    """The separable plan of ``m`` (:class:`SepPlan`) over the shortest
    suffix of output axes across which the source address separates, or
    None where no suffix of at most :data:`SEP_CAP` elements does, or the
    map needs 64-bit arithmetic (the general kernel then runs).

    The address separates over the suffix from axis ``s`` when every row
    that reads digits of both sides (the suffix's coordinates and their
    splits; the outer ones) is linear (denominator 1) and proved in range:
    its inner part then goes to the table and its offset and outer part to
    the run's base.  A row of one side only, with any denominator and
    checked or not, goes to that side whole, as does a digit bound."""
    if not m.out_shape or math.prod(m.out_shape) == 0:
        return None
    rows, narrow = gather_rows(m)
    if not narrow:
        return None
    n_out = len(m.out_shape)
    axis_of = list(range(n_out)) + [sp.axis for sp in m.splits]
    R = 1
    for s in range(n_out - 1, -1, -1):
        R *= m.out_shape[s]
        if R > SEP_CAP:
            return None
        mixed = False
        for row in rows:
            sides = {axis_of[d] >= s for d, v in enumerate(row.nums) if v}
            mixed |= len(sides) == 2 and (row.den != 1 or row.checked)
        if not mixed:
            return _sep_build(m, rows, s, R, itemsize)
    return None


def sep_words(plan: SepPlan, fill_bits: int, vbytes: int
              ) -> tuple[list[int], np.ndarray]:
    """The separable kernel's table (int64 words, layout in
    csrc/tm_affine.cu) and its run table (int32: per access of a run the
    source offset in units of ``vbytes``, or :data:`SEP_INVALID`) for
    accesses of ``vbytes`` bytes."""
    ve = vbytes // plan.itemsize
    U = plan.R // ve
    w = [0] * SEP_WORDS
    w[0:5] = [plan.suffix, len(plan.osplits), len(plan.rows),
              len(plan.obounds), U]
    w[5], w[6] = _magic(U)
    w[7] = fill_bits
    for a, n in enumerate(plan.oshape):
        w[12 + a] = n
        w[24 + a], w[36 + a] = _magic(n)
    for j, (a, radix) in enumerate(plan.osplits):
        w[48 + j], w[60 + j] = a, radix
        w[72 + j], w[84 + j] = _magic(radix)
    for k, (d, bound) in enumerate(plan.obounds):
        w[96 + k], w[108 + k] = d, bound
    for r, (offn, den, size, stride, checked, nums) in enumerate(plan.rows):
        w[120 + 5 * r: 125 + 5 * r] = [offn, den, size - 1, stride // ve,
                                       int(checked)]
        w[180 + 2 * MAX_AXES * r: 180 + 2 * MAX_AXES * r + len(nums)] = nums
    head = plan.off[::ve] // ve
    table = np.where(plan.valid[::ve], head, SEP_INVALID).astype(np.int32)
    return w, table


@dataclasses.dataclass(frozen=True)
class GatherLaunch:
    """How a gather call runs: ``path`` (``separable`` or ``general``),
    the bytes each access moves, and the device tables."""

    path: str
    vbytes: int
    regs: torch.Tensor
    narrow: bool
    table: torch.Tensor | None


@functools.lru_cache(maxsize=512)
def _gather_launch(m: MixedRadixMap, dtype: torch.dtype,
                   device: torch.device, vector: bool) -> GatherLaunch:
    """The launch of a gather on ``device``: the separable path where the
    map has one (in the plan's 16-byte accesses if ``vector``, else
    element by element), else the general kernel's register file."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = separable_plan(m, itemsize)
    if plan is None:
        regs, narrow = _gather_regs(m, dtype, device)
        return GatherLaunch("general", itemsize, regs, narrow, None)
    vbytes = plan.vbytes if vector else itemsize
    words, table = sep_words(plan, _fill_bits(m.fill, dtype), vbytes)
    return GatherLaunch("separable", vbytes,
                        torch.tensor(words, dtype=torch.int64, device=device),
                        True, torch.tensor(table, device=device))


def gather_launch(m: MixedRadixMap, x: torch.Tensor,
                  y: torch.Tensor | None = None) -> GatherLaunch:
    """The path :func:`tm_affine_gather` takes for ``x`` (and ``y``): the
    map's plan, element by element where x or y is not aligned to its
    access width."""
    launch = _gather_launch(m, x.dtype, x.device, True)
    if launch.vbytes > x.element_size() and any(
            t is not None and t.data_ptr() % launch.vbytes for t in (x, y)):
        launch = _gather_launch(m, x.dtype, x.device, False)
    return launch


def _gather_args(g: GatherLaunch, m: MixedRadixMap):
    """``_launch``'s register file, 32-bit flag and the entry point's
    further arguments for the launch ``g``."""
    table = (None, 0) if g.table is None else (g.table.data_ptr(),
                                               g.table.numel())
    return g.regs, g.narrow, (len(m.out_shape) + len(m.splits),
                              GATHER_PATHS[g.path], g.vbytes, *table)


def tm_affine_gather(x: torch.Tensor, m: MixedRadixMap, *,
                     y: torch.Tensor | None = None,
                     ew: str | None = None) -> torch.Tensor:
    """Gather-mode map ``m`` with an optional fused element-wise epilogue.
    CPU tensor: the plain version; CUDA tensor: the kernel on the path
    :func:`gather_launch` plans (separable runs from a table, or the
    general address generator over the map's registers), or an
    exception."""
    if x.device.type == "cpu":
        return gather_plain(x, m, y=y, ew=ew)
    build.library("tm_affine")  # a kernel that cannot be built raises here
    _check_launch("tm_affine_gather", x, m, y, ew)
    return _launch(tm_affine_gather, x, m,
                   lambda: _gather_args(gather_launch(m, x, y), m), y, ew)


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
