"""Shape-bucketed micro-batching: pad, coalesce, split.

Requests are grouped by :class:`BucketKey` — same function, same per-request
argument shapes/dtypes — and coalesced into one batched execution by
stacking every argument leaf along a new leading axis.  The batch height is
rounded up to a power of two (``bucket_size``), padding with copies of the
last real request, so the compile cache sees at most ``log2(max_batch)+1``
shape classes per bucket instead of one per arrival count.

The stacked call site is ``torch.func.vmap(fn)``: inside ``tm_compile`` the
vmap reaches the tagged TM ops (whose vmap rules grow their ``batch_dims``)
and the aten ops, so the compiled program is the same batch-lifted form the
executor's ``batch_dims`` path exercises — one kernel launch over the whole
micro-batch, not a per-request loop.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """The shape class one request belongs to."""

    fn_key: Any
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[str, ...]


@dataclasses.dataclass
class Request:
    """One queued call: ``fn(*args)`` with a future for the result.

    ``priority`` is a :class:`repro_torch.sched.Priority` class rank (0 =
    deadline, 1 = interactive, 2 = batch); ``deadline`` is an *absolute*
    ``time.monotonic()`` second or None.  The FIFO batcher ignores both —
    they drive ordering and preemption in the continuous scheduler
    (:mod:`repro_torch.sched`)."""

    fn: Callable
    fn_key: Any
    args: tuple
    future: Any                      # concurrent.futures.Future
    priority: int = 1                # Priority.INTERACTIVE
    deadline: float | None = None    # absolute monotonic second
    t_submit: float = dataclasses.field(default_factory=time.monotonic)
    _bucket: BucketKey | None = dataclasses.field(default=None, repr=False)

    def bucket(self) -> BucketKey:
        # computed once (the batcher polls this on every queue scan)
        if self._bucket is None:
            flat, _ = pytree.tree_flatten(self.args)
            self._bucket = BucketKey(
                self.fn_key,
                tuple(tuple(int(d) for d in getattr(a, "shape", ()))
                      for a in flat),
                tuple(leaf_dtype(a) for a in flat))
        return self._bucket


def leaf_dtype(a) -> str:
    """The dtype part of a shape class: a tensor's dtype, else the Python
    type of a scalar leaf."""
    return str(a.dtype) if isinstance(a, torch.Tensor) else type(a).__name__


def bucket_size(n: int, max_batch: int) -> int:
    """Round ``n`` up to the next power of two, capped at the largest power
    of two ``<= max_batch``.

    The cap itself must stay on the power-of-two ladder: returning a
    non-power-of-two ``max_batch`` verbatim would mint a bucket size that
    coexists with the pow2 ladder and fragments the compile cache (one extra
    shape class that only full batches ever hit)."""
    cap = 1
    while cap * 2 <= max_batch:
        cap *= 2
    if n >= cap:
        return cap
    b = 1
    while b < n:
        b *= 2
    return b


def coalesce(requests: list[Request], size: int) -> tuple[Any, int]:
    """Stack ``len(requests)`` argument trees to batch height ``size``.

    Returns ``(stacked_args, pad)`` where the last real request's arguments
    fill the ``pad = size - len(requests)`` synthetic rows (their results
    are discarded by :func:`split`)."""
    n = len(requests)
    if not 0 < n <= size:
        raise ValueError(f"cannot coalesce {n} request(s) to height {size}")
    trees = [r.args for r in requests] + [requests[-1].args] * (size - n)
    stacked = pytree.tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)
    return stacked, size - n


def split(result: Any, n: int) -> list[Any]:
    """Un-batch: slice row ``i`` of every output leaf for each real request."""
    return [pytree.tree_map(lambda x: x[i], result) for i in range(n)]


class BucketQueue:
    """Pending requests per bucket, with the condition-variable handshake the
    batcher thread blocks on.  FIFO across buckets by oldest head request."""

    def __init__(self):
        self._pending: dict[BucketKey, list[Request]] = {}
        self.lock = threading.Lock()
        self.nonempty = threading.Condition(self.lock)

    def push(self, req: Request, allow=None) -> bool:
        """Enqueue ``req``; ``allow()`` (if given) is evaluated under the
        queue lock and a False result refuses the push — the server uses it
        to close the submit/stop race atomically."""
        with self.nonempty:
            if allow is not None and not allow():
                return False
            self._pending.setdefault(req.bucket(), []).append(req)
            self.nonempty.notify_all()
            return True

    def depth(self) -> int:
        with self.lock:
            return sum(len(v) for v in self._pending.values())

    def oldest_head(self) -> Request | None:
        """Caller must hold ``lock``."""
        heads = [v[0] for v in self._pending.values() if v]
        return min(heads, key=lambda r: r.t_submit) if heads else None

    def head_info(self) -> tuple[Request | None, int]:
        """Caller must hold ``lock``.  The longest-waiting head request and
        how many requests share its bucket."""
        head = self.oldest_head()
        if head is None:
            return None, 0
        return head, len(self._pending[head.bucket()])

    def pop_bucket(self, max_batch: int) -> list[Request]:
        """Caller must hold ``lock``.  Dequeue up to ``max_batch`` requests
        from the bucket whose head request has waited longest."""
        head = self.oldest_head()
        if head is None:
            return []
        return self._pop(head.bucket(), max_batch)

    def pop_full(self, max_batch: int) -> list[Request]:
        """Caller must hold ``lock``.  Dequeue from a bucket that already
        holds a full batch — such batches dispatch immediately instead of
        waiting out an older partial head's straggler window."""
        for key, queue in self._pending.items():
            if len(queue) >= max_batch:
                return self._pop(key, max_batch)
        return []

    def _pop(self, key: BucketKey, max_batch: int) -> list[Request]:
        queue = self._pending[key]
        take, rest = queue[:max_batch], queue[max_batch:]
        if rest:
            self._pending[key] = rest
        else:
            del self._pending[key]
        return take
