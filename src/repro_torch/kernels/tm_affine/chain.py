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

The kernel (``csrc/tm_chain.cu``) sits beside its plain PyTorch version
:func:`chain_plain`; the wrapper :func:`tm_chain` runs the plain version for
a CPU tensor and the kernel for a CUDA tensor, and ``tm_chain.launches``
counts kernel launches.
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
                                                     _fill_bits)

# The JAX package declines chains whose inputs (the chain source + every
# epilogue/band operand slab + the pullback constants) would not stay
# VMEM-resident for the launch.  The card has no such limit; the port keeps
# the same budget and the same decline test so that both packages lower the
# same programs the same way.
CHAIN_VMEM_BUDGET = 1 << 27

# descriptor table sizes of csrc/tm_chain.cu
MAX_LEVELS = 16
MAX_EXTRAS = 16
_NARROW = 2 ** 31  # the plan's indices are int32


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


def _check_launch(sig: ChainSig, x: torch.Tensor,
                  slabs: tuple[torch.Tensor, ...]) -> None:
    if not x.is_cuda:
        raise ValueError(f"tm_chain: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES or str(x.dtype) != f"torch.{sig.dtype}":
        raise TypeError(f"tm_chain: dtype {x.dtype} does not match the "
                        f"chain's {sig.dtype}")
    if tuple(x.shape) != tuple(sig.links[0][0].in_shape) \
            or not x.is_contiguous():
        raise ValueError(f"tm_chain: x must be a contiguous tensor of shape "
                         f"{sig.links[0][0].in_shape}")
    shapes = _slab_shapes(sig)
    if len(slabs) != len(shapes):
        raise ValueError(f"tm_chain: {len(shapes)} operand slabs expected, "
                         f"got {len(slabs)}")
    for s, shape in zip(slabs, shapes):
        if (s.device != x.device or s.dtype != x.dtype
                or tuple(s.shape) != tuple(shape) or not s.is_contiguous()):
            raise ValueError(f"tm_chain: operand slabs must be contiguous "
                             f"{x.dtype} tensors of shapes {shapes} on "
                             f"{x.device}")
    if max([x.numel(), math.prod(sig.out_shape)]
           + [s.numel() for s in slabs]) >= _NARROW:
        raise ValueError("tm_chain: the chain's indices are int32; a chain "
                         "input, operand or output of 2^31 elements or more "
                         "cannot be addressed")


def tm_chain(sig: ChainSig, x: torch.Tensor,
             slabs: tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    """Execute a chain signature: ``x`` is the chain source, ``slabs`` the
    epilogue operands then non-chain Route band sources, in link order.
    CPU tensor: the plain version; CUDA tensor: the kernel, or an
    exception.  An empty output launches nothing."""
    if x.device.type == "cpu":
        return chain_plain(x, build_chain_plan(sig), slabs)
    lib = build.library("tm_chain")  # a kernel that cannot be built raises
    _check_launch(sig, x, slabs)
    out = torch.empty(sig.out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = build_chain_plan(sig)
    if len(plan.levels) > MAX_LEVELS or len(plan.extras) > MAX_EXTRAS:
        raise ValueError(f"tm_chain: the kernel takes at most {MAX_LEVELS} "
                         f"levels and {MAX_EXTRAS} extra Route bands")
    consts = _device_consts(sig, x.device)
    desc = list(consts.desc)
    for at, s in zip(consts.slab_at, slabs):
        desc[at] = s.data_ptr()
    table = (ctypes.c_int64 * len(desc))(*desc)
    rc = lib.tm_chain(x.data_ptr(), out.data_ptr(), table,
                      DTYPE_CODES[x.dtype], out.numel(), len(plan.levels),
                      len(plan.extras),
                      torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "tm_chain")
    tm_chain.launches += 1
    return out


tm_chain.launches = 0
