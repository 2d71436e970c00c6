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
CUDA tensor, and its ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.rme import predicate, promoted_threshold
from repro_torch.kernels import build
from repro_torch.kernels.tm_affine.tm_affine import _fill_bits

DTYPE_CODES = {torch.int8: 0, torch.int32: 1, torch.bfloat16: 2,
               torch.float32: 3}
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
    if capacity < 0:
        raise ValueError(f"{name}: capacity must be >= 0, got {capacity}")


def _threshold_args(x: torch.Tensor, threshold) -> tuple[int, float, int]:
    """(int_mode, f32 threshold, integer threshold): the compare runs at the
    promoted dtype, rounded on the host (see core.rme)."""
    thr_dtype, thr = promoted_threshold(x, threshold)
    int_mode = not thr_dtype.is_floating_point
    return (int(int_mode), 0.0 if int_mode else float(thr),
            int(thr) if int_mode else 0)


def _outputs(x: torch.Tensor, B: int, capacity: int, d: int):
    return (torch.empty((B, capacity, d), dtype=x.dtype, device=x.device),
            torch.empty((B, capacity), dtype=torch.int32, device=x.device),
            torch.empty((B,), dtype=torch.int32, device=x.device))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


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
    if x.device.type == "cpu":
        return evaluate_plain(x, threshold, capacity, cmp=cmp,
                              score_index=score_index)
    lib = build.library("rme_gather")
    _check_records("rme_evaluate", x, capacity)
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("rme_evaluate: x must be a contiguous (B, N, D) "
                         f"tensor, got shape {tuple(x.shape)}")
    B, n, d = x.shape
    if not 0 <= score_index < d or cmp not in CMP_CODES:
        raise ValueError(f"rme_evaluate: bad config score_index="
                         f"{score_index} cmp={cmp!r}")
    if n >= _NARROW:
        raise ValueError("rme_evaluate: source indices are int32")
    rows, idx, cnt = _outputs(x, B, capacity, d)
    if B == 0:
        return rows, idx, cnt
    rc = lib.rme_evaluate(
        x.data_ptr(), rows.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
        DTYPE_CODES[x.dtype], B, n, d, capacity, score_index, CMP_CODES[cmp],
        *_threshold_args(x, threshold), _stream(x))
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
    if x_slab.device.type == "cpu":
        return evaluate_chained_plain(x_slab, idx, ok, fill, threshold,
                                      capacity, cmp=cmp,
                                      score_index=score_index)
    lib = build.library("rme_gather")
    _check_records("rme_evaluate_chained", x_slab, capacity)
    if (idx.ndim != 3 or idx.dtype != torch.int32
            or idx.device != x_slab.device or not idx.is_contiguous()
            or not x_slab.is_contiguous()):
        raise ValueError("rme_evaluate_chained: idx must be a contiguous "
                         "int32 (B, N, D) tensor beside a contiguous slab")
    if ok is not None and (ok.dtype != torch.bool or ok.shape != idx.shape
                           or ok.device != idx.device
                           or not ok.is_contiguous()):
        raise ValueError("rme_evaluate_chained: ok must be a contiguous "
                         "bool tensor shaped like idx")
    B, n, d = idx.shape
    if not 0 <= score_index < d or cmp not in CMP_CODES:
        raise ValueError(f"rme_evaluate_chained: bad config score_index="
                         f"{score_index} cmp={cmp!r}")
    if max(x_slab.numel(), idx.numel()) >= _NARROW:
        raise ValueError("rme_evaluate_chained: the pullback's indices are "
                         "int32; a chain input or stream of 2^31 elements "
                         "or more cannot be addressed")
    rows, src, cnt = _outputs(x_slab, B, capacity, d)
    if B == 0:
        return rows, src, cnt
    rc = lib.rme_evaluate_chained(
        x_slab.data_ptr(), idx.data_ptr(),
        None if ok is None else ok.data_ptr(),
        _fill_bits(fill, x_slab.dtype), rows.data_ptr(), src.data_ptr(),
        cnt.data_ptr(), DTYPE_CODES[x_slab.dtype], B, n, d, capacity,
        score_index, CMP_CODES[cmp], *_threshold_args(x_slab, threshold),
        _stream(x_slab))
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


def rme_assemble(x: torch.Tensor, mask: torch.Tensor, capacity: int,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Assemble ``(B, N, D)`` record streams under a ``(B, N)`` runtime mask
    (see :func:`assemble_plain`).  The kernel reads a bool or int32 mask; a
    mask of another dtype is cast to int32 first, as the JAX package casts
    it.  CPU tensor: the plain version; CUDA tensor: the kernel, or an
    exception."""
    if x.device.type == "cpu":
        return assemble_plain(x, mask, capacity)
    lib = build.library("rme_gather")
    _check_records("rme_assemble", x, capacity)
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("rme_assemble: x must be a contiguous (B, N, D) "
                         f"tensor, got shape {tuple(x.shape)}")
    B, n, d = x.shape
    if tuple(mask.shape) != (B, n) or mask.device != x.device:
        raise ValueError(f"rme_assemble: mask must be ({B}, {n}) on "
                         f"{x.device}, got {tuple(mask.shape)} on "
                         f"{mask.device}")
    if mask.dtype not in (torch.bool, torch.int32):
        mask = mask.to(torch.int32)
    mask = mask.contiguous()
    rows = torch.empty((B, capacity, d), dtype=x.dtype, device=x.device)
    cnt = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B == 0:
        return rows, cnt
    rc = lib.rme_assemble(x.data_ptr(), mask.data_ptr(), mask.element_size(),
                          rows.data_ptr(), cnt.data_ptr(),
                          DTYPE_CODES[x.dtype], B, n, d, capacity, _stream(x))
    build.check(rc, "rme_assemble")
    rme_assemble.launches += 1
    return rows, cnt


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
