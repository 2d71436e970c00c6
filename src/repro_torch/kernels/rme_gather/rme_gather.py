"""RME compaction — threshold filter or runtime mask, stable compaction of
record streams.

Bboxcal (paper Fig. 2c) end to end: score -> predicate -> compaction ->
gather, producing a statically shaped packed block (the commit buffer), the
survivors' source indices (``N`` in empty slots) and a survivor count
clamped to the capacity.  Three hand-written CUDA kernels
(``csrc/rme_gather.cu``) run one block row per record stream, each beside
its plain PyTorch version:

* :func:`rme_evaluate` / :func:`evaluate_plain` — the threshold test on
  ``(B, N, D)`` records; :func:`evaluate` (one stream) and
  :func:`evaluate_batched` launch it;
* :func:`rme_evaluate_chained` / :func:`evaluate_chained_plain` — the same
  on records gathered from a chain input through a coarse pullback
  (:func:`evaluate_chained`);
* :func:`rme_assemble` / :func:`assemble_plain` — compaction under a
  runtime mask, no indices (:func:`assemble`, :func:`assemble_batched`).

Each wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor, and its ``launches`` counts kernel launches.  What a launch
needs beyond the tensors' pointers (the checked shapes, the C arguments
after the pointers) is computed once per shape, dtype and configuration.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.rme import predicate, promoted_threshold
from repro_torch.kernels import build
from repro_torch.kernels.build import through_op
from repro_torch.kernels.tm_affine.tm_affine import _fill_bits

DTYPE_CODES = {torch.int8: 0, torch.int32: 1, torch.bfloat16: 2,
               torch.float32: 3}
ROUND_ROWS = 2048  # rows of a stream one scan round tests (kRound)
CMP_CODES = {"ge": 0, "gt": 1, "le": 2, "lt": 3}
_NARROW = 2 ** 31  # source indices are int32


def _compact_plain(x: torch.Tensor, mask: torch.Tensor, capacity: int,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable compaction of ``(B, N, D)`` rows under a ``(B, N)`` bool mask:
    ``(rows (B, capacity, D), src_idx (B, capacity) int32, count (B,)
    int32)``.  The packed slot of a survivor is its exclusive prefix sum
    over the mask, the order of a stable argsort."""
    B, n, _ = x.shape
    pos = torch.cumsum(mask.to(torch.int64), 1) - 1
    keep = mask & (pos < capacity)
    dest = torch.where(keep, pos, capacity)  # dropped rows land in slot cap
    src = torch.arange(n, dtype=torch.int64, device=x.device).expand(B, n)
    idx = torch.full((B, capacity + 1), n, dtype=torch.int64, device=x.device)
    idx.scatter_(1, dest, torch.where(keep, src, n))
    idx = idx[:, :capacity]
    live = idx < n
    rows = torch.gather(x, 1, idx.clamp(max=max(n - 1, 0))[..., None]
                        .expand(B, capacity, x.shape[2]))
    rows = torch.where(live[..., None], rows, torch.zeros_like(rows))
    count = torch.clamp(mask.sum(1), max=capacity)
    return rows, idx.to(torch.int32), count.to(torch.int32)


def _check_records(name: str, x: torch.Tensor, capacity: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if not 0 <= capacity < _NARROW:
        raise ValueError(f"{name}: capacity must be >= 0 and below 2^31 "
                         f"(the count is int32), got {capacity}")


def _ctyped(entry: str, first: int, values) -> tuple:
    """``values`` as the ctypes objects of ``entry``'s arguments from
    position ``first`` on (converted once, not at every call)."""
    types = build.SIGNATURES["rme_gather"][entry][first:]
    return tuple(t(v) for t, v in zip(types, values))


def _threshold_config(name: str, dtype: torch.dtype, d: int, threshold,
                      cmp: str, score_index: int) -> tuple:
    """(score_index, cmp code, int_mode, f32 threshold, integer threshold):
    the compare runs at the promoted dtype, rounded on the host (see
    core.rme)."""
    if not 0 <= score_index < d or cmp not in CMP_CODES:
        raise ValueError(f"{name}: bad config score_index={score_index} "
                         f"cmp={cmp!r}")
    thr_dtype, thr = promoted_threshold(torch.empty((), dtype=dtype),
                                        threshold)
    int_mode = not thr_dtype.is_floating_point
    return (score_index, CMP_CODES[cmp], int(int_mode),
            0.0 if int_mode else float(thr), int(thr) if int_mode else 0)


@functools.lru_cache(maxsize=256)
def _evaluate_args(shape: tuple, dtype: torch.dtype, capacity: int,
                   threshold, cmp: str, score_index: int) -> tuple:
    """The C arguments of ``rme_evaluate`` after its four pointers."""
    if len(shape) != 3:
        raise ValueError(f"rme_evaluate: x must be a contiguous (B, N, D) "
                         f"tensor, got shape {shape}")
    B, n, d = shape
    if n >= _NARROW:
        raise ValueError("rme_evaluate: source indices are int32")
    return _ctyped("rme_evaluate", 4, (
        DTYPE_CODES[dtype], B, n, d, capacity,
        *_threshold_config("rme_evaluate", dtype, d, threshold, cmp,
                           score_index)))


@functools.lru_cache(maxsize=256)
def _chained_args(slab_numel: int, shape: tuple, dtype: torch.dtype,
                  fill: float, capacity: int, threshold, cmp: str,
                  score_index: int) -> tuple:
    """The C arguments of ``rme_evaluate_chained`` after its seven
    pointers and its fill bits, and the fill bits."""
    if len(shape) != 3:
        raise ValueError("rme_evaluate_chained: idx must be a contiguous "
                         "int32 (B, N, D) tensor beside a contiguous slab")
    B, n, d = shape
    if max(slab_numel, B * n * d) >= _NARROW:
        raise ValueError("rme_evaluate_chained: the pullback's indices are "
                         "int32; a chain input or stream of 2^31 elements "
                         "or more cannot be addressed")
    return ctypes.c_int64(_fill_bits(fill, dtype)), _ctyped(
        "rme_evaluate_chained", 7, (
            DTYPE_CODES[dtype], B, n, d, capacity,
            *_threshold_config("rme_evaluate_chained", dtype, d, threshold,
                               cmp, score_index)))


def _outputs(x: torch.Tensor, B: int, capacity: int, d: int):
    return (x.new_empty((B, capacity, d)),
            x.new_empty((B, capacity), dtype=torch.int32),
            x.new_empty((B,), dtype=torch.int32))


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------

def evaluate_plain(x: torch.Tensor, threshold, capacity: int, *,
                   cmp: str = "ge", score_index: int = 0,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the evaluate kernel on ``(B, N, D)``
    streams: ``(rows (B, capacity, D), src_idx (B, capacity) int32, count
    (B,) int32)``."""
    mask = predicate(x[..., score_index], threshold, cmp)
    return _compact_plain(x, mask, capacity)


def rme_evaluate(x: torch.Tensor, threshold, capacity: int, *,
                 cmp: str = "ge", score_index: int = 0,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Evaluate ``(B, N, D)`` record streams (see :func:`evaluate_plain`).
    CPU tensor: the plain version; CUDA tensor: the kernel, or an
    exception."""
    if x.is_cpu:
        return evaluate_plain(x, threshold, capacity, cmp=cmp,
                              score_index=score_index)
    lib = build.library("rme_gather")
    _check_records("rme_evaluate", x, capacity)
    args = _evaluate_args(tuple(x.shape), x.dtype, capacity, threshold, cmp,
                          score_index)
    if not x.is_contiguous():
        raise ValueError("rme_evaluate: x must be a contiguous (B, N, D) "
                         f"tensor, got shape {tuple(x.shape)}")
    B, _, d = x.shape
    rows, idx, cnt = _outputs(x, B, capacity, d)
    if B == 0:
        return rows, idx, cnt
    rc = lib.rme_evaluate(x.data_ptr(), rows.data_ptr(), idx.data_ptr(),
                          cnt.data_ptr(), *args,
                          build.current_stream(x.get_device()))
    build.check(rc, "rme_evaluate")
    rme_evaluate.launches += 1
    return rows, idx, cnt


rme_evaluate.launches = 0


def evaluate(x: torch.Tensor, threshold, capacity: int, *, cmp: str = "ge",
             score_index: int = 0):
    """Threshold-filter rows of (N, D) -> packed (capacity, D) + idx
    (capacity,) + count (1,)."""
    rows, idx, cnt = rme_evaluate(x[None], threshold, capacity, cmp=cmp,
                                  score_index=score_index)
    return rows[0], idx[0], cnt


def evaluate_batched(x: torch.Tensor, threshold, capacity: int, *,
                     cmp: str = "ge", score_index: int = 0):
    """Batched evaluate: (B, N, D) -> (B, capacity, D) + idx (B, capacity)
    + counts (B, 1) — one kernel launch, one block row per record stream."""
    rows, idx, cnt = rme_evaluate(x, threshold, capacity, cmp=cmp,
                                  score_index=score_index)
    return rows, idx, cnt[:, None]


# ---------------------------------------------------------------------------
# chained evaluate
# ---------------------------------------------------------------------------

def evaluate_chained_plain(x_slab: torch.Tensor, idx: torch.Tensor,
                           ok: torch.Tensor | None, fill: float, threshold,
                           capacity: int, *, cmp: str = "ge",
                           score_index: int = 0,
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain PyTorch version of the chained evaluate kernel: the ``(B, N,
    D)`` records are ``x_slab.flatten()[idx]``, ``fill`` where ``ok`` is
    false, then evaluated as :func:`evaluate_plain` (the threshold test sees
    the filled value)."""
    recs = x_slab.reshape(-1)[idx]
    if ok is not None:
        recs = torch.where(ok, recs, torch.tensor(fill, dtype=recs.dtype,
                                                  device=recs.device))
    return evaluate_plain(recs, threshold, capacity, cmp=cmp,
                          score_index=score_index)


def rme_evaluate_chained(x_slab: torch.Tensor, idx: torch.Tensor,
                         ok: torch.Tensor | None, fill: float, threshold,
                         capacity: int, *, cmp: str = "ge",
                         score_index: int = 0,
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Evaluate record streams pulled back into the chain input ``x_slab``
    through ``idx`` (int32 ``(B, N, D)``) and ``ok`` (bool, or None: never
    out of bounds).  Returns ``(rows (B, capacity, D), src_idx (B,
    capacity), count (B,))``.  CPU tensor: the plain version; CUDA tensor:
    the kernel, or an exception."""
    if x_slab.is_cpu:
        return evaluate_chained_plain(x_slab, idx, ok, fill, threshold,
                                      capacity, cmp=cmp,
                                      score_index=score_index)
    lib = build.library("rme_gather")
    _check_records("rme_evaluate_chained", x_slab, capacity)
    fill_bits, args = _chained_args(x_slab.numel(), tuple(idx.shape),
                                    x_slab.dtype, fill, capacity, threshold,
                                    cmp, score_index)
    index = x_slab.get_device()
    if (idx.dtype != torch.int32 or idx.get_device() != index
            or not idx.is_contiguous() or not x_slab.is_contiguous()):
        raise ValueError("rme_evaluate_chained: idx must be a contiguous "
                         "int32 (B, N, D) tensor beside a contiguous slab")
    if ok is not None and (ok.dtype != torch.bool or ok.shape != idx.shape
                           or ok.get_device() != index
                           or not ok.is_contiguous()):
        raise ValueError("rme_evaluate_chained: ok must be a contiguous "
                         "bool tensor shaped like idx")
    B, _, d = idx.shape
    rows, src, cnt = _outputs(x_slab, B, capacity, d)
    if B == 0:
        return rows, src, cnt
    rc = lib.rme_evaluate_chained(
        x_slab.data_ptr(), idx.data_ptr(),
        None if ok is None else ok.data_ptr(), fill_bits, rows.data_ptr(),
        src.data_ptr(), cnt.data_ptr(), *args, build.current_stream(index))
    build.check(rc, "rme_evaluate_chained")
    rme_evaluate_chained.launches += 1
    return rows, src, cnt


rme_evaluate_chained.launches = 0


def evaluate_chained(x_slab: torch.Tensor, idx: torch.Tensor,
                     ok: torch.Tensor | None, fill: float, threshold,
                     capacity: int, *, cmp: str = "ge", score_index: int = 0):
    """Batched evaluate fed through a coarse pullback: ``idx``/``ok`` are
    (B, N, D) constants mapping each stream element into the flat chain
    input ``x_slab`` -> (B, capacity, D) + idx (B, capacity) + counts
    (B, 1), one kernel launch."""
    rows, src, cnt = rme_evaluate_chained(x_slab, idx, ok, fill, threshold,
                                          capacity, cmp=cmp,
                                          score_index=score_index)
    return rows, src, cnt[:, None]


# ---------------------------------------------------------------------------
# assemble
# ---------------------------------------------------------------------------

def assemble_plain(x: torch.Tensor, mask: torch.Tensor, capacity: int,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the assemble kernel: ``(B, N, D)`` rows
    under a ``(B, N)`` runtime mask (any dtype, taken as int32 ``!= 0``) ->
    ``(rows (B, capacity, D), count (B,) int32)``."""
    rows, _, cnt = _compact_plain(x, mask.to(torch.int32) != 0, capacity)
    return rows, cnt


@functools.lru_cache(maxsize=256)
def _assemble_args(shape: tuple, dtype: torch.dtype, capacity: int) -> tuple:
    """The C arguments of ``rme_assemble`` after its five pointers and
    the mask's width."""
    if len(shape) != 3:
        raise ValueError(f"rme_assemble: x must be a contiguous (B, N, D) "
                         f"tensor, got shape {shape}")
    return _ctyped("rme_assemble", 5, (DTYPE_CODES[dtype], *shape, capacity))


def _assemble_launch(x: torch.Tensor, mask: torch.Tensor, capacity: int,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the assemble kernel, or an exception."""
    lib = build.library("rme_gather")
    _check_records("rme_assemble", x, capacity)
    args = _assemble_args(tuple(x.shape), x.dtype, capacity)
    if not x.is_contiguous():
        raise ValueError("rme_assemble: x must be a contiguous (B, N, D) "
                         f"tensor, got shape {tuple(x.shape)}")
    B, n, d = x.shape
    if mask.shape != (B, n) or mask.get_device() != x.get_device():
        raise ValueError(f"rme_assemble: mask must be ({B}, {n}) on "
                         f"{x.device}, got {tuple(mask.shape)} on "
                         f"{mask.device}")
    if mask.dtype not in (torch.bool, torch.int32):
        mask = mask.to(torch.int32)
    mask = mask.contiguous()
    rows = x.new_empty((B, capacity, d))
    cnt = x.new_empty((B,), dtype=torch.int32)
    if B == 0:
        return rows, cnt
    rc = lib.rme_assemble(x.data_ptr(), mask.data_ptr(), mask.element_size(),
                          rows.data_ptr(), cnt.data_ptr(), *args,
                          build.current_stream(x.get_device()))
    build.check(rc, "rme_assemble")
    rme_assemble.launches += 1
    return rows, cnt


# The custom op ``repro_torch::rme_assemble``: the plain version on the CPU,
# the kernel on the card, shapes alone on the meta device (fake tensors, the
# dry-run's trace), and a DTensor sharding rule, so that a model under a
# mesh dispatches through it.  Plain tensors skip the dispatcher
# (:func:`rme_assemble`).
@torch.library.custom_op("repro_torch::rme_assemble", mutates_args=(),
                         device_types="cpu")
def assemble_op(x: torch.Tensor, mask: torch.Tensor, capacity: int,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    return assemble_plain(x, mask, capacity)


assemble_op.register_kernel("cuda")(_assemble_launch)


@assemble_op.register_fake
def _(x, mask, capacity):
    B, _, d = x.shape
    return x.new_empty((B, capacity, d)), x.new_empty((B,), dtype=torch.int32)


@register_flop_formula(torch.ops.repro_torch.rme_assemble)
def _(*args, **kwargs) -> int:
    # a compaction does no multiply-add; FlopCounterMode counts those only
    return 0


@register_sharding(torch.ops.repro_torch.rme_assemble.default)
def _(x, mask, capacity):
    """Streams are compacted one by one: local to each rank's streams (dim
    0), or replicated."""
    return [([Replicate(), Replicate()], [Replicate(), Replicate(), None]),
            ([Shard(0), Shard(0)], [Shard(0), Shard(0), None])]


def rme_assemble(x: torch.Tensor, mask: torch.Tensor, capacity: int,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Assemble ``(B, N, D)`` record streams under a ``(B, N)`` runtime mask
    (see :func:`assemble_plain`).  The kernel reads a bool or int32 mask; a
    mask of another dtype is cast to int32 first, as the JAX package casts
    it.  CPU tensor: the plain version; CUDA tensor: the kernel, or an
    exception; a DTensor or a fake tensor: :func:`assemble_op` (its
    sharding rule, its fake)."""
    if through_op(x, mask):
        return assemble_op(x, mask, capacity)
    if x.is_cpu:
        return assemble_plain(x, mask, capacity)
    return _assemble_launch(x, mask, capacity)


rme_assemble.launches = 0


def assemble_batched(x: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Batched assemble: (B, N, D) + (B, N) mask -> (B, capacity, D) +
    counts (B, 1) — one kernel launch."""
    rows, cnt = rme_assemble(x, mask, capacity)
    return rows, cnt[:, None]


def assemble(x: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Pack rows of (N, D) selected by a runtime mask -> (capacity, D) +
    count (1,)."""
    rows, cnt = rme_assemble(x[None], mask[None], capacity)
    return rows[0], cnt
