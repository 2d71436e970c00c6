"""RME evaluate — threshold filter + stable compaction of record streams.

Bboxcal (paper Fig. 2c) end to end: score -> predicate -> compaction ->
gather, producing a statically shaped packed block (the commit buffer), the
survivors' source indices (``N`` in empty slots) and a survivor count
clamped to the capacity.  The hand-written CUDA kernel
(``csrc/rme_gather.cu``) runs one block per record stream; :func:`evaluate`
(one stream) and :func:`evaluate_batched` (a batch of streams) both launch
it.  The plain PyTorch version :func:`evaluate_plain` sits beside it; the
wrapper :func:`rme_evaluate` runs it for a CPU tensor and the kernel for a
CUDA tensor, and ``rme_evaluate.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.rme import predicate, promoted_threshold
from repro_torch.kernels import build

DTYPE_CODES = {torch.int8: 0, torch.int32: 1, torch.bfloat16: 2,
               torch.float32: 3}
CMP_CODES = {"ge": 0, "gt": 1, "le": 2, "lt": 3}


def evaluate_plain(x: torch.Tensor, threshold, capacity: int, *,
                   cmp: str = "ge", score_index: int = 0,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel on ``(B, N, D)`` streams:
    ``(rows (B, capacity, D), src_idx (B, capacity) int32, count (B,)
    int32)``.  The packed slot of a survivor is its exclusive prefix sum
    over the mask, the order of a stable argsort."""
    B, n, _ = x.shape
    mask = predicate(x[..., score_index], threshold, cmp)
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
    if not x.is_cuda:
        raise ValueError(f"rme_evaluate: x must be a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"rme_evaluate: unsupported dtype {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("rme_evaluate: x must be a contiguous (B, N, D) "
                         f"tensor, got shape {tuple(x.shape)}")
    B, n, d = x.shape
    if not 0 <= score_index < d or capacity < 0 or cmp not in CMP_CODES:
        raise ValueError(f"rme_evaluate: bad config score_index="
                         f"{score_index} capacity={capacity} cmp={cmp!r}")
    if n >= 2 ** 31:
        raise ValueError("rme_evaluate: source indices are int32")
    rows = torch.empty((B, capacity, d), dtype=x.dtype, device=x.device)
    idx = torch.empty((B, capacity), dtype=torch.int32, device=x.device)
    cnt = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B == 0:
        return rows, idx, cnt
    thr_dtype, thr = promoted_threshold(x, threshold)
    int_mode = not thr_dtype.is_floating_point
    rc = lib.rme_evaluate(
        x.data_ptr(), rows.data_ptr(), idx.data_ptr(), cnt.data_ptr(),
        DTYPE_CODES[x.dtype], B, n, d, capacity, score_index, CMP_CODES[cmp],
        int(int_mode), 0.0 if int_mode else float(thr),
        int(thr) if int_mode else 0,
        torch.cuda.current_stream(x.device).cuda_stream)
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
    + counts (B, 1) — one kernel launch, one block per record stream."""
    rows, idx, cnt = rme_evaluate(x, threshold, capacity, cmp=cmp,
                                  score_index=score_index)
    return rows, idx, cnt[:, None]
