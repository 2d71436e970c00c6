"""Chain megakernel — a producer→consumer run of coarse TM instructions
lowered as ONE kernel launch.

Per-instruction lowering executes a forwarding chain as N kernels with N−1
full intermediates round-tripped through device memory.  This kernel
collapses the chain onto the *final* output's elements
(:func:`repro_torch.core.schedule.plan_segments` gives the same
``(rows, minor)`` view and segment count as the JAX package's grid):

* adjacent links whose maps compose symbolically are pre-coalesced with
  :func:`repro_torch.core.affine.compose_maps` (the fusion pass's
  composition — those intermediates vanish entirely);
* links that do NOT compose (splits/rational interactions, OOB fills,
  element-wise epilogues pinning a boundary) are *pulled back*: at build
  time each link's gather is composed **numerically** onto the final output
  grid (int32 index and bool validity arrays, built with the port's
  :func:`~repro_torch.core.engine.gather_indices`, element for element the
  JAX package's), and the kernel applies each link's mask, fill and
  epilogue to the value in registers before the next link sees it.  The
  intermediate never exists at tensor granularity.

A terminal multi-band Route (``TMInstr.maps``) is supported as the last
link: the chain streams into its band while the remaining bands gather
directly from their own sources, summed per element in band order.

The JAX package's :class:`ChainPlan` also sizes a two-slot VMEM scratch
buffer (``use_scratch``/``scratch_shape``) through which each link's
segment is handed to the next on the TPU.  The CUDA kernel keeps that
handoff in registers, one output element per thread, so the port's plan
has no scratch fields.

The kernel (``csrc/tm_chain.cu``) does not stream those full-size arrays.
:func:`build_run_plan` factors each of them over a run grid (element ``i``
is run ``o = i // R``, position ``p = i % R``, a suffix of the output's
axes): every index as ``base[o] + off[p]`` and every mask as ``outer[o] &
run[p]``, checked exactly in numpy against the full arrays wherever the
kernel reads them.  The kernel stages the ``R``-entry run tables in shared
memory and reads one base per run; ``R = 1`` always factors, so every chain
has a plan.

The kernel sits beside its plain PyTorch version :func:`chain_plain`; the
wrapper :func:`tm_chain` runs the plain version for a CPU tensor and the
kernel for a CUDA tensor, and ``tm_chain.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from repro_torch.core.affine import MixedRadixMap, compose_maps, memoized_hash
from repro_torch.core.engine import EW_FNS, gather_indices
from repro_torch.core.schedule import plan_segments
from repro_torch.kernels import build
from repro_torch.kernels.tm_affine.tm_affine import (DTYPE_CODES, EW_CODES,
                                                     _fill_bits, _magic)

# The JAX package declines chains whose inputs (the chain source + every
# epilogue/band operand slab + the pullback constants) would not stay
# VMEM-resident for the launch.  The card has no such limit; the port keeps
# the same budget and the same decline test so that both packages lower the
# same programs the same way.
CHAIN_VMEM_BUDGET = 1 << 27

# descriptor table sizes of csrc/chain_desc.cuh
MAX_LEVELS = 16
MAX_EXTRAS = 16
_NARROW = 2 ** 31  # the plan's indices are int32
# the run tables of csrc/tm_chain.cu: at most R_CAP positions a run, and at
# most RUN_SMEM bytes of tables staged in a block's shared memory
R_CAP = 8192
RUN_SMEM = 64 * 1024
_ALIGN = 16  # each table starts on a 16-byte boundary


@dataclasses.dataclass(frozen=True)
class ChainSig:
    """Hashable chain signature — the cache key for built chain plans.

    ``links`` are the batch-lifted ``(map, ew)`` pairs in dataflow order
    (before composition coalescing); ``route_maps``/``route_band`` describe
    an optional terminal multi-band Route, with the chain feeding band
    ``route_band``.
    """

    links: tuple[tuple[MixedRadixMap, str | None], ...]
    route_maps: tuple[MixedRadixMap, ...] | None = None
    route_band: int = 0
    dtype: str = "float32"
    segment_bytes: int | None = None

    def __hash__(self):
        # hashed on every executor call (plan-cache lookup) — memoize
        return memoized_hash(self, self.links, self.route_maps,
                             self.route_band, self.dtype, self.segment_bytes)

    @property
    def out_shape(self) -> tuple[int, ...]:
        if self.route_maps is not None:
            return self.route_maps[0].out_shape
        return self.links[-1][0].out_shape


@dataclasses.dataclass(frozen=True)
class _Level:
    """One link after coalescing, pulled back onto the final output grid."""

    mask: object       # np.bool_ (R, M) or None when the link cannot go OOB
    fill: float
    ew: str | None
    p: object          # np.int32 (R, M) flat coords in this link's output
    #                    layout (epilogue operand addressing); None if no ew


@dataclasses.dataclass(frozen=True)
class _Extra:
    """A non-chain Route band: direct gather from its own source slab."""

    idx: object        # np.int32 (R, M)
    mask: object       # np.bool_ (R, M) or None
    fill: float


@dataclasses.dataclass
class ChainPlan:
    """Built constants + segmentation for one chain signature."""

    sig: ChainSig
    j: np.ndarray                 # (R, M) int32 — final pullback into x
    levels: tuple[_Level, ...]
    extras: tuple[_Extra, ...]
    rows: int
    minor: int
    row_block: int
    n_composed: int               # links eliminated by compose_maps

    @property
    def n_segments(self) -> int:
        return self.rows // self.row_block


@lru_cache(maxsize=256)
def _coalesce(links: tuple[tuple[MixedRadixMap, str | None], ...],
              ) -> tuple[tuple[MixedRadixMap, str | None], ...]:
    """Symbolically compose adjacent links (the fusion pass's rule: a link
    carrying an epilogue pins its boundary — the operand is consumed in that
    link's output layout)."""
    ls = list(links)
    changed = True
    while changed:
        changed = False
        for i in range(len(ls) - 1):
            (m1, ew1), (m2, ew2) = ls[i], ls[i + 1]
            if ew1 is not None:
                continue
            m = compose_maps(m2, m1)
            if m is None:
                continue
            ls[i:i + 2] = [(m, ew2)]
            changed = True
            break
    return tuple(ls)


def _np_gather(m: MixedRadixMap) -> tuple[np.ndarray, np.ndarray]:
    flat, valid = gather_indices(m)
    return (flat.numpy().astype(np.int32).ravel(),
            valid.numpy().astype(bool).ravel())


def fold_pullback(maps: tuple[MixedRadixMap, ...],
                  ) -> tuple[np.ndarray, np.ndarray | None, float]:
    """Numerically compose a run of *pure* maps (no epilogues) onto the last
    map's output grid.

    Returns ``(J, OK, fill)``: flat indices into the first map's input, a
    validity mask (None when no element can go out of bounds) and the fill
    the invalid elements take.  An element invalid at several levels takes
    the LAST level's fill (forward-execution semantics); chains whose
    OOB-capable levels disagree on the fill value raise ``ValueError`` —
    callers decline and fall back to per-instruction lowering.
    """
    out_shape = maps[-1].out_shape
    rm = math.prod(out_shape)
    cur = np.arange(rm, dtype=np.int32)
    decided = np.zeros(rm, dtype=bool)
    fill: float | None = None
    for m in reversed(maps):
        flat, valid = _np_gather(m)
        ib = valid[cur]
        newly = (~ib) & (~decided)
        if newly.any():
            if fill is None:
                fill = float(m.fill)
            elif fill != float(m.fill):
                raise ValueError("mixed fill values across chain levels")
            decided |= newly
        cur = flat[cur]
    ok = None if not decided.any() else ~decided
    return cur, ok, (0.0 if fill is None else fill)


@lru_cache(maxsize=256)
def build_chain_plan(sig: ChainSig) -> ChainPlan:
    """Pull every link back onto the final output grid.

    Backward pass over the (coalesced) link maps: maintain ``cur``, the flat
    coordinate each final output element reads in the current link's output;
    each link contributes its validity (pulled back) and, when it carries an
    epilogue, the operand coordinates.  The result is exact: an element
    invalid at link ℓ takes link ℓ's fill and discards everything upstream —
    precisely the semantics of executing the links one by one.
    """
    links = _coalesce(sig.links)
    n_composed = len(sig.links) - len(links)
    out_shape = sig.out_shape
    seg = plan_segments(out_shape, segment_bytes=sig.segment_bytes)
    rm = seg.rows * seg.minor

    maps_seq = [m for m, _ in links]
    ews_seq: list[str | None] = [ew for _, ew in links]
    if sig.route_maps is not None:
        maps_seq.append(sig.route_maps[sig.route_band])
        ews_seq.append(None)

    cur = np.arange(rm, dtype=np.int32)
    rev: list[tuple[np.ndarray | None, float, np.ndarray]] = []
    for m in reversed(maps_seq):
        flat, valid = _np_gather(m)
        ib = valid[cur]
        rev.append((None if bool(ib.all()) else ib.reshape(seg.rows, seg.minor),
                    float(m.fill), cur.reshape(seg.rows, seg.minor)))
        cur = flat[cur]
    rev.reverse()

    levels = tuple(
        _Level(mask=mask, fill=fill, ew=ew,
               p=p if ew is not None else None)
        for (mask, fill, p), ew in zip(rev, ews_seq))

    extras = []
    if sig.route_maps is not None:
        for b, m in enumerate(sig.route_maps):
            if b == sig.route_band:
                continue
            flat, valid = _np_gather(m)   # bands share the final out grid
            extras.append(_Extra(
                idx=flat.reshape(seg.rows, seg.minor),
                mask=None if bool(valid.all())
                else valid.reshape(seg.rows, seg.minor),
                fill=float(m.fill)))

    return ChainPlan(sig=sig, j=cur.reshape(seg.rows, seg.minor),
                     levels=levels, extras=tuple(extras), rows=seg.rows,
                     minor=seg.minor, row_block=seg.row_block,
                     n_composed=n_composed)


def chain_plan_of(sig: ChainSig) -> ChainPlan:
    """Expose the built plan (segments, levels, composed count) for
    reports/tests without building or executing a kernel."""
    return build_chain_plan(sig)


def chain_slab_bytes(sig: ChainSig, x, slabs) -> int:
    n = x.numel() * x.element_size()
    for s in slabs:
        n += s.numel() * s.element_size()
    # the pullback constants, counted as the JAX package counts them
    plan_elems = math.prod(sig.out_shape)
    n += 4 * plan_elems * (1 + len(sig.links))
    return n


# ---------------------------------------------------------------------------
# the run plan: the pullback factored over a run grid
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RunIndex:
    """An int32 plan array over the run grid: ``base[o] + off[p]`` at
    element ``o * R + p`` wherever the kernel reads it."""

    base: np.ndarray   # (n_runs,) int32
    off: np.ndarray    # (R,) int32


@dataclasses.dataclass(frozen=True)
class RunMask:
    """A plan mask over the run grid: ``outer[o] & run[p]``; a part that is
    None is true everywhere."""

    outer: np.ndarray | None  # (n_runs,) bool
    run: np.ndarray | None    # (R,) bool


@dataclasses.dataclass(frozen=True)
class RunPlan:
    """A chain plan factored over runs of ``run`` consecutive output
    elements (a suffix of the output's axes).  ``levels`` holds each
    level's (mask, p), p None without an epilogue; ``extras`` each extra
    band's (idx, mask).  ``vec``: the elements one access may move (1, or
    16 bytes' worth where every table allows it)."""

    sig: ChainSig
    run: int
    n_runs: int
    vec: int
    j: RunIndex
    levels: tuple[tuple[RunMask, RunIndex | None], ...]
    extras: tuple[tuple[RunIndex, RunMask], ...]

    def run_tables(self) -> list[np.ndarray]:
        """What a block stages in shared memory, in the kernel's order:
        off_j; per level its run mask and off_p; per extra off, run mask."""
        out = [self.j.off]
        for mask, p in self.levels:
            out += [a for a in (mask.run, None if p is None else p.off)
                    if a is not None]
        for idx, mask in self.extras:
            out += [a for a in (idx.off, mask.run) if a is not None]
        return out

    def outer_tables(self) -> list[np.ndarray]:
        """The per-run tables, read from device memory: base_j; per level
        its outer mask and base_p; per extra base, outer mask."""
        out = [self.j.base]
        for mask, p in self.levels:
            out += [a for a in (mask.outer, None if p is None else p.base)
                    if a is not None]
        for idx, mask in self.extras:
            out += [a for a in (idx.base, mask.outer) if a is not None]
        return out

    @property
    def table_bytes(self) -> int:
        return sum(_padded(a.nbytes) for a in self.run_tables())

    @property
    def outer_bytes(self) -> int:
        return sum(_padded(a.nbytes) for a in self.outer_tables())


def _padded(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _factor_mask(mask: np.ndarray | None, care, n: int, r: int,
                 ) -> RunMask | None:
    """``mask`` as ``outer[o] & run[p]`` on the rectangle ``care`` (rows,
    cols) where it decides the result; None if it does not factor."""
    if mask is None:
        return RunMask(None, None)
    rows, cols = care
    sub = mask.reshape(n, r)[rows][:, cols]
    outer, run = np.ones(n, bool), np.ones(r, bool)
    outer[rows], run[cols] = sub.any(1), sub.any(0)
    if not np.array_equal(sub, outer[rows][:, None] & run[cols][None, :]):
        return None
    return RunMask(None if outer.all() else outer, None if run.all() else run)


def _factor_index(a: np.ndarray, read, n: int, r: int) -> RunIndex | None:
    """``a`` as ``base[o] + off[p]`` on the rectangle ``read`` (rows, cols)
    where the kernel reads it (elsewhere both are 0); None if it does not
    factor."""
    rows, cols = read
    a = a.reshape(n, r)
    base, off = np.zeros(n, np.int64), np.zeros(r, np.int64)
    if rows.any() and cols.any():
        o0, p0 = int(np.argmax(rows)), int(np.argmax(cols))
        off[cols] = a[o0, cols].astype(np.int64) - int(a[o0, p0])
        base[rows] = a[rows, p0]
        sub = a[rows][:, cols].astype(np.int64)
        if not np.array_equal(sub, base[rows][:, None] + off[cols][None, :]):
            return None
    return RunIndex(base.astype(np.int32), off.astype(np.int32))


def _rect(mask: RunMask, care):
    """The rectangle where ``care`` holds and ``mask`` passes."""
    rows, cols = care
    return (rows if mask.outer is None else rows & mask.outer,
            cols if mask.run is None else cols & mask.run)


def _vector_ok(idx: RunIndex, read, v: int) -> bool:
    """Whether ``idx`` reads runs of ``v`` consecutive elements, ``v``-
    aligned, in every ``v``-chunk of a run that it reads at all."""
    rows, cols = read
    chunks = cols.reshape(-1, v)
    if not (chunks.all(1) | ~chunks.any(1)).all():
        return False
    off = idx.off.astype(np.int64).reshape(-1, v)[chunks[:, 0]]
    return bool((off == off[:, :1] + np.arange(v)).all()
                and (off[:, 0] % v == 0).all()
                and (idx.base[rows].astype(np.int64) % v == 0).all())


def _factor_plan(plan: ChainPlan, r: int, itemsize: int) -> RunPlan | None:
    """Factor every array of ``plan`` over runs of ``r``, or None.  The
    kernel reads a level's mask and its p only where no later level masks
    the element (a later fill overwrites the value), j only where no level
    masks it, an extra's idx only where its mask passes."""
    numel = plan.rows * plan.minor
    n = numel // r
    every = (np.ones(n, bool), np.ones(r, bool))
    care = every
    levels, reads = [], []
    for lv in reversed(plan.levels):
        mask = _factor_mask(lv.mask, care, n, r)
        if mask is None:
            return None
        p = None
        if lv.ew is not None:
            p = _factor_index(lv.p, care, n, r)
            if p is None:
                return None
            reads.append((p, care))
        levels.append((mask, p))
        care = _rect(mask, care)
    levels.reverse()
    j = _factor_index(plan.j, care, n, r)
    if j is None:
        return None
    reads.append((j, care))
    masks = [mask for mask, _ in levels]
    extras = []
    for ex in plan.extras:
        mask = _factor_mask(ex.mask, every, n, r)
        if mask is None:
            return None
        idx = _factor_index(ex.idx, _rect(mask, every), n, r)
        if idx is None:
            return None
        extras.append((idx, mask))
        masks.append(mask)
        reads.append((idx, _rect(mask, every)))
    v = 16 // itemsize
    vec = v if (r % v == 0 and all(
        (m.run is None or (m.run.reshape(-1, v) == m.run.reshape(-1, v)[:, :1])
         .all()) for m in masks)
        and all(_vector_ok(idx, read, v) for idx, read in reads)) else 1
    return RunPlan(sig=plan.sig, run=r, n_runs=n, vec=vec, j=j,
                   levels=tuple(levels), extras=tuple(extras))


def _table_bytes_at_most(plan: ChainPlan, r: int) -> int:
    per = [4] + [4 for lv in plan.levels if lv.ew is not None] \
        + [1 for lv in plan.levels if lv.mask is not None] \
        + [4 for _ in plan.extras] + [1 for ex in plan.extras
                                      if ex.mask is not None]
    return sum(_padded(b * r) for b in per)


@lru_cache(maxsize=256)
def build_run_plan(sig: ChainSig) -> RunPlan:
    """The longest suffix of the output's axes, of at most ``R_CAP``
    elements and ``RUN_SMEM`` bytes of run tables, over which every array
    of :func:`build_chain_plan` factors.  ``R = 1`` always factors."""
    plan = build_chain_plan(sig)
    shape = sig.out_shape
    itemsize = torch.empty((), dtype=getattr(torch, sig.dtype)).element_size()
    for s in range(len(shape) + 1):
        r = math.prod(shape[s:])
        if r < 1 or r > R_CAP or _table_bytes_at_most(plan, r) > RUN_SMEM:
            continue
        got = _factor_plan(plan, r, itemsize)
        if got is not None:
            return got
    raise AssertionError("a chain plan must factor at R = 1")


# ---------------------------------------------------------------------------
# the plan's constants on a device, and the plain version
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _DeviceConsts:
    """A plan's arrays on one device (flat), and the kernel's descriptor
    table with a hole for every runtime slab pointer."""

    j: torch.Tensor
    levels: tuple[tuple[torch.Tensor | None, torch.Tensor | None], ...]
    extras: tuple[tuple[torch.Tensor, torch.Tensor | None], ...]
    desc: tuple[int, ...]
    slab_at: tuple[int, ...]  # desc positions of the slab pointers, in order


def _flat(a: np.ndarray | None, device: torch.device) -> torch.Tensor | None:
    return None if a is None else torch.from_numpy(a.ravel()).to(device)


@lru_cache(maxsize=64)
def _device_consts(sig: ChainSig, device: torch.device) -> _DeviceConsts:
    """Upload a plan once per (signature, device).  Descriptor layout (int64
    words, csrc/tm_chain.cu): j; per level mask, fill bits, ew code, p, y;
    per extra idx, mask, fill bits, z (a pointer of 0 means none)."""
    plan = build_chain_plan(sig)
    dtype = getattr(torch, sig.dtype)
    j = _flat(plan.j, device)
    levels, extras = [], []
    desc, slab_at = [j.data_ptr()], []
    for lv in plan.levels:
        mask, p = _flat(lv.mask, device), _flat(lv.p, device)
        levels.append((mask, p))
        desc += [0 if mask is None else mask.data_ptr(),
                 _fill_bits(lv.fill, dtype), EW_CODES[lv.ew],
                 0 if p is None else p.data_ptr(), 0]
        if lv.ew is not None:
            slab_at.append(len(desc) - 1)
    for ex in plan.extras:
        idx, mask = _flat(ex.idx, device), _flat(ex.mask, device)
        extras.append((idx, mask))
        desc += [idx.data_ptr(), 0 if mask is None else mask.data_ptr(),
                 _fill_bits(ex.fill, dtype), 0]
        slab_at.append(len(desc) - 1)
    return _DeviceConsts(j=j, levels=tuple(levels), extras=tuple(extras),
                         desc=tuple(desc), slab_at=tuple(slab_at))


def chain_plain(x: torch.Tensor, plan: ChainPlan,
                slabs: tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    """Plain PyTorch version of the chain kernel: ``x`` through the final
    pullback, then per level its mask/fill and its epilogue, then each extra
    Route band (masked fill) added in band order.  Every step rounds to the
    working dtype, as the JAX package's kernel body does."""
    consts = _device_consts(plan.sig, x.device)
    v = x.reshape(-1)[consts.j]
    it = iter(slabs)
    for lv, (mask, p) in zip(plan.levels, consts.levels):
        if mask is not None:
            v = torch.where(mask, v, torch.tensor(lv.fill, dtype=v.dtype,
                                                  device=v.device))
        if lv.ew is not None:
            v = EW_FNS[lv.ew](v, next(it).reshape(-1)[p])
    for ex, (idx, mask) in zip(plan.extras, consts.extras):
        u = next(it).reshape(-1)[idx]
        if mask is not None:
            u = torch.where(mask, u, torch.tensor(ex.fill, dtype=v.dtype,
                                                  device=v.device))
        v = v + u
    return v.reshape(plan.sig.out_shape)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _slab_shapes(sig: ChainSig) -> list[tuple[int, ...]]:
    """The shape each runtime slab must have: an epilogue operand is in its
    (coalesced) link's output layout, a Route band source is the band map's
    input."""
    shapes = [m.out_shape for m, ew in _coalesce(sig.links) if ew is not None]
    if sig.route_maps is not None:
        shapes += [m.in_shape for b, m in enumerate(sig.route_maps)
                   if b != sig.route_band]
    return shapes


def _pack(arrays: list[np.ndarray], device: torch.device,
          ) -> tuple[torch.Tensor, list[int]]:
    """The arrays in one device buffer, each at a 16-byte aligned offset
    (the offsets returned in order)."""
    offsets, at = [], 0
    for a in arrays:
        offsets.append(at)
        at += _padded(a.nbytes)
    buf = np.zeros(max(at, _ALIGN), np.uint8)
    for a, o in zip(arrays, offsets):
        buf[o:o + a.nbytes] = np.ascontiguousarray(a).view(np.uint8).ravel()
    return torch.from_numpy(buf).to(device), offsets


class _Launch:
    """Everything of a ``tm_chain`` launch that does not depend on the
    tensors: the checks' expected tuples, the run tables on the device
    (uploaded once per signature and device) and, per access width, the
    descriptor's words, packed, with a hole for every slab pointer (each
    call copies them into a ctypes array of its own and fills the holes).

    Descriptor (int64 words, csrc/chain_desc.cuh ``parse_runs``): R, run
    table bytes, run table pointer, base_j pointer, off_j offset, elements
    per access, its magic and shifts; per level outer mask pointer, run
    mask offset, fill bits, ew code, base_p pointer, off_p offset, y; per
    extra base pointer, off offset, outer mask pointer, run mask offset,
    fill bits, z.  A pointer of 0 or an offset of -1 means none."""

    def __init__(self, sig: ChainSig, device: torch.device):
        self.dtype = getattr(torch, sig.dtype)
        if self.dtype not in DTYPE_CODES:
            raise TypeError(f"tm_chain: unsupported dtype {self.dtype}")
        self.device = device
        self.in_shape = tuple(sig.links[0][0].in_shape)
        self.out_shape = tuple(sig.out_shape)
        self.slab_shapes = [tuple(t) for t in _slab_shapes(sig)]
        self.numel = math.prod(self.out_shape)
        if self.numel == 0:  # nothing to launch, nothing to plan
            return
        if max([math.prod(self.in_shape), self.numel]
               + [math.prod(t) for t in self.slab_shapes]) >= _NARROW:
            raise ValueError("tm_chain: the chain's indices are int32; a "
                             "chain input, operand or output of 2^31 "
                             "elements or more cannot be addressed")
        plan = build_chain_plan(sig)
        if len(plan.levels) > MAX_LEVELS or len(plan.extras) > MAX_EXTRAS:
            raise ValueError(f"tm_chain: the kernel takes at most "
                             f"{MAX_LEVELS} levels and {MAX_EXTRAS} extra "
                             f"Route bands")
        rp = build_run_plan(sig)
        self.n_levels, self.n_extras = len(rp.levels), len(rp.extras)
        self.code = DTYPE_CODES[self.dtype]
        self.plan = rp
        self.table, toff = _pack(rp.run_tables(), device)
        self.outer, ooff = _pack(rp.outer_tables(), device)
        tnext = iter(toff)
        onext = (o + self.outer.data_ptr() for o in ooff)

        def ptr(a):  # a per-run table's pointer, 0 for none
            return 0 if a is None else next(onext)

        def off(a):  # a run table's offset in shared memory, -1 for none
            return -1 if a is None else next(tnext)

        words = [rp.run, rp.table_bytes, self.table.data_ptr(),
                 ptr(rp.j.base), off(rp.j.off), 0, 0, 0]
        slab_at = []
        for (mask, pidx), lv in zip(rp.levels, plan.levels):
            words += [ptr(mask.outer), off(mask.run),
                      _fill_bits(lv.fill, self.dtype), EW_CODES[lv.ew],
                      ptr(None if pidx is None else pidx.base),
                      off(None if pidx is None else pidx.off), 0]
            if lv.ew is not None:
                slab_at.append(len(words) - 1)
        for (idx, mask), ex in zip(rp.extras, plan.extras):
            words += [ptr(idx.base), off(idx.off), ptr(mask.outer),
                      off(mask.run), _fill_bits(ex.fill, self.dtype), 0]
            slab_at.append(len(words) - 1)
        self.slab_at = tuple(slab_at)
        self.table_type = ctypes.c_int64 * len(words)
        self.words = {}
        for vec in {1, rp.vec}:
            w = list(words)
            w[5] = vec
            w[6], w[7] = _magic(rp.run // vec)
            self.words[vec] = bytes(self.table_type(*w))

    def check(self, x: torch.Tensor, slabs) -> None:
        if x.dtype != self.dtype:
            raise TypeError(f"tm_chain: dtype {x.dtype} does not match the "
                            f"chain's {self.dtype}")
        if x.shape != self.in_shape or not x.is_contiguous():
            raise ValueError(f"tm_chain: x must be a contiguous tensor of "
                             f"shape {self.in_shape}")
        if len(slabs) != len(self.slab_shapes):
            raise ValueError(f"tm_chain: {len(self.slab_shapes)} operand "
                             f"slabs expected, got {len(slabs)}")
        for s, shape in zip(slabs, self.slab_shapes):
            if (s.dtype != self.dtype or s.shape != shape
                    or s.get_device() != self.device.index
                    or not s.is_contiguous()):
                raise ValueError(f"tm_chain: operand slabs must be "
                                 f"contiguous {self.dtype} tensors of shapes "
                                 f"{self.slab_shapes} on {self.device}")


@lru_cache(maxsize=64)
def _launch_of(sig: ChainSig, index: int) -> _Launch:
    return _Launch(sig, torch.device("cuda", index))


def tm_chain(sig: ChainSig, x: torch.Tensor,
             slabs: tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    """Execute a chain signature: ``x`` is the chain source, ``slabs`` the
    epilogue operands then non-chain Route band sources, in link order.
    CPU tensor: the plain version; CUDA tensor: the kernel, or an
    exception.  An empty output launches nothing."""
    if x.is_cpu:
        return chain_plain(x, build_chain_plan(sig), slabs)
    lib = build.library("tm_chain")  # a kernel that cannot be built raises
    if not x.is_cuda:
        raise ValueError(f"tm_chain: x must be a CUDA tensor, got {x.device}")
    index = x.get_device()
    lc = _launch_of(sig, index)
    lc.check(x, slabs)
    out = x.new_empty(lc.out_shape)
    if lc.numel == 0:
        return out
    vec = lc.plan.vec
    if vec > 1 and any(t.data_ptr() % 16 for t in (x, out, *slabs)):
        vec = 1
    table = lc.table_type.from_buffer_copy(lc.words[vec])
    for at, s in zip(lc.slab_at, slabs):
        table[at] = s.data_ptr()
    rc = lib.tm_chain(x.data_ptr(), out.data_ptr(), table, lc.code,
                      lc.numel, lc.n_levels, lc.n_extras,
                      build.current_stream(index))
    build.check(rc, "tm_chain")
    tm_chain.launches += 1
    return out


tm_chain.launches = 0
