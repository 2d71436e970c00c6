"""Reconfigurable Masking Engine — fine-grained TM (paper Section V-B.2).

The RME's two schemes, at lane granularity:

* **assemble** — gather lanes selected by a mask and pack them contiguously
  into the output stream: a prefix-sum compaction, ``dest = cumsum(mask) -
  1`` gives each surviving lane its packed position in one vector pass.

* **evaluate** — filter a stream by a runtime predicate (compare/threshold)
  and emit only the surviving records (plus indices).  This realizes Bboxcal
  (confidence thresholding of YOLO output rows) and doubles as MoE token
  dispatch (top-k routing -> expert-local packed batches).

Both return *statically shaped* outputs: results are packed to a
``capacity`` with a validity count, like the TMU's commit buffer.  This is
the reference engine; the CUDA kernel in
:mod:`repro_torch.kernels.rme_gather` is held against it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.distributed.tensor import DTensor


# --------------------------------------------------------------------------
# assemble
# --------------------------------------------------------------------------

def assemble_static(x: torch.Tensor, lane_mask) -> torch.Tensor:
    """Pack lanes of the minor axis selected by a *static* boolean mask.

    ``x``: (..., L); ``lane_mask``: (L,) python/numpy bool (the
    byte-masking-register case: a plain gather)."""
    idx = np.nonzero(np.asarray(lane_mask, dtype=bool))[0]
    return x.index_select(-1, torch.as_tensor(idx, dtype=torch.int64,
                                              device=x.device))


def assemble(x: torch.Tensor, mask: torch.Tensor, capacity: int,
             fill: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Runtime compaction along the leading axis (records = rows).

    ``x``: (N, ...); ``mask``: (N,) bool.  Returns ``(packed, count)`` where
    ``packed`` is (capacity, ...) holding the selected rows in order, padded
    with ``fill``, and ``count`` is the number of valid rows (<= capacity;
    overflow rows are dropped, as a fixed-size commit buffer would).
    """
    mask = mask.to(torch.int64)
    pos = torch.cumsum(mask, 0) - 1  # packed position of each surviving row
    count = torch.clamp(mask.sum(), max=capacity).to(torch.int32)
    valid = (mask == 1) & (pos < capacity)
    out = torch.full((capacity,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    out[pos[valid]] = x[valid]
    return out, count


def assemble_indices(mask: torch.Tensor, capacity: int,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`assemble` but returns the *source indices* of survivors.

    ``indices[j] = i`` of the j-th surviving row, padded with ``n``
    (one-past-end sentinel).  Returns ``(indices, count)`` (int32)."""
    n = mask.shape[0]
    mask_i = mask.to(torch.int64)
    pos = torch.cumsum(mask_i, 0) - 1
    count = torch.clamp(mask_i.sum(), max=capacity).to(torch.int32)
    valid = (mask_i == 1) & (pos < capacity)
    idx = torch.full((capacity,), n, dtype=torch.int32, device=mask.device)
    idx[pos[valid]] = torch.arange(n, dtype=torch.int32,
                                   device=mask.device)[valid]
    return idx, count


# --------------------------------------------------------------------------
# evaluate
# --------------------------------------------------------------------------

_CMPS = {
    "ge": lambda a, b: a >= b,
    "gt": lambda a, b: a > b,
    "le": lambda a, b: a <= b,
    "lt": lambda a, b: a < b,
}


def promoted_threshold(x: torch.Tensor, threshold,
                       ) -> tuple[torch.dtype, float | int]:
    """The compare dtype and the threshold rounded to it, as a Python number.

    The compare runs at the promoted dtype of the records and the python
    threshold (a float threshold against int records compares in float32,
    never truncated; against bf16 records it rounds to bf16), the same rule
    as the reference's weakly typed python scalar.  The rounding happens on
    the host, so no device scalar (and no device synchronisation) is made."""
    return _promoted(x.dtype, threshold)


@functools.lru_cache(maxsize=256)
def _promoted(dtype: torch.dtype,
              threshold) -> tuple[torch.dtype, float | int]:
    promoted = torch.result_type(torch.empty((), dtype=dtype), threshold)
    return promoted, torch.tensor(threshold, dtype=promoted).item()


def predicate(scores: torch.Tensor, threshold, cmp: str) -> torch.Tensor:
    """``scores <cmp> threshold`` at the promoted dtype (see above); the
    rounded threshold is exactly representable there, so the compare is
    exact whatever precision the compare kernel uses inside."""
    dtype, thr = promoted_threshold(scores, threshold)
    return _CMPS[cmp](scores.to(dtype), thr)


def evaluate(x: torch.Tensor, threshold, capacity: int, *, cmp: str = "ge",
             score_index: int = 0,
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Threshold-filter records (rows of ``x``) on a score column.

    ``x``: (N, D).  Keeps rows where ``x[:, score_index] <cmp> threshold``,
    packed to ``capacity``.  Returns ``(packed_rows, src_indices, count)``.
    This is Bboxcal's confidence filter (paper Fig. 2c) in one fused pass.
    """
    n = x.shape[0]
    mask = predicate(x[:, score_index], threshold, cmp)
    idx, count = assemble_indices(mask, capacity)
    live = idx < n
    rows = torch.zeros((capacity,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    rows[live] = x[idx[live].to(torch.int64)]
    return rows, idx, count


def evaluate_topk(x: torch.Tensor, k: int, capacity: int | None = None,
                  score_index: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate scheme, top-k variant: keep the k highest-scoring rows.

    Returns ``(rows, src_indices)``; rows are score-sorted, ties broken by
    the lower index first (``torch.topk`` promises no tie order, so the
    order is made explicit with a stable sort).  ``capacity`` defaults to
    k."""
    cap = capacity or k
    scores = x[:, score_index]
    order = torch.sort(scores, descending=True, stable=True).indices
    idx = order[:k][:cap].to(torch.int32)
    return x[idx.to(torch.int64)], idx


# --------------------------------------------------------------------------
# MoE dispatch built on assemble/evaluate
# --------------------------------------------------------------------------

def dispatch_tokens_plain(expert_of: torch.Tensor, num_experts: int,
                          capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`dispatch_tokens` on (B, T) expert
    ids, on any device: the JAX package's one-hot / cumsum pass, over every
    batch row at once."""
    B, T = expert_of.shape
    experts = torch.arange(num_experts, device=expert_of.device)
    onehot = (expert_of[..., None] == experts).to(torch.int64)  # (B, T, E)
    pos = torch.cumsum(onehot, dim=1) - 1   # packed slot per (token, expert)
    counts = torch.clamp(onehot.sum(1), max=capacity).to(torch.int32)
    valid = (onehot == 1) & (pos < capacity)
    dest = torch.where(valid, pos, capacity).transpose(1, 2)  # (B, E, T)
    token_ids = torch.arange(T, device=expert_of.device).expand(
        B, num_experts, T)
    idx = torch.full((B, num_experts, capacity + 1), T, dtype=torch.int64,
                     device=expert_of.device)
    # every live slot is written once; the dropped ones all land in the
    # spare column ``capacity``, which is cut off
    idx.scatter_(2, dest, torch.where(valid.transpose(1, 2), token_ids, T))
    return idx[..., :capacity].to(torch.int32), counts


def dispatch_tokens_assembled(expert_of: torch.Tensor, num_experts: int,
                              capacity: int,
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`dispatch_tokens` on (B, T) expert ids as one ``rme_assemble``
    over the B·E record streams ``arange(T)`` (int32, one lane a record),
    stream (b, e) under the mask ``expert_of[b] == e``; a slot past its
    stream's count takes the sentinel T (the kernel writes 0 there).  On a
    CPU tensor ``rme_assemble`` runs its plain version."""
    # imported here: the kernel module imports this one
    from repro_torch.kernels.rme_gather.rme_gather import rme_assemble

    B, T = expert_of.shape
    dev = expert_of.device
    experts = torch.arange(num_experts, device=dev)
    mask = (expert_of[:, None, :] == experts[None, :, None]).reshape(
        B * num_experts, T)
    records = torch.arange(T, dtype=torch.int32, device=dev).expand(
        B * num_experts, T)[..., None].contiguous()
    rows, counts = rme_assemble(records, mask, capacity)
    live = torch.arange(capacity, device=dev) < counts[:, None]
    idx = torch.where(live, rows[..., 0], T).view(B, num_experts, capacity)
    return idx, counts.view(B, num_experts)


def dispatch_tokens(expert_of: torch.Tensor, num_experts: int,
                    capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-expert assemble: pack token indices by expert assignment.

    ``expert_of``: (T,) or (B, T) expert id per token-slot.  Returns
    ``(indices, counts)`` (int32): ``indices[..., e, :]`` is (capacity,) of
    the token ids routed to expert ``e`` in token order (padded with T),
    ``counts[..., e]`` the live count (overflow past ``capacity`` is
    dropped) — exactly :func:`assemble_indices` over each expert's mask,
    the JAX package's ``vmap(dispatch_tokens)`` over the batch.

    CPU tensor: :func:`dispatch_tokens_plain`.  CUDA tensor:
    :func:`dispatch_tokens_assembled`, one launch of the RME assemble
    kernel (or an exception).  A DTensor (a model under a mesh) takes the
    assembled form on either device: the assemble op's sharding rule keeps
    the dispatch local to each rank's sequences, and on the CPU the op runs
    its plain version, whose tables equal the plain dispatch's."""
    batched = expert_of[None] if expert_of.ndim == 1 else expert_of
    form = dispatch_tokens_plain \
        if expert_of.is_cpu and not isinstance(expert_of, DTensor) \
        else dispatch_tokens_assembled
    idx, counts = form(batched, num_experts, capacity)
    return (idx[0], counts[0]) if expert_of.ndim == 1 else (idx, counts)
