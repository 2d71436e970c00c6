"""Liveness-based scratch-buffer assignment for compiled TM programs.

The TMU's working memory is a small set of ping-pong scratch buffers, not a
heap: every intermediate of a compiled program must be assigned a slot, and
slots are reused as soon as their previous tenant dies.  Two sizing regimes:

* an intermediate on a **forwarding edge** never materializes in full — the
  consumer streams committed segments, so its slot holds exactly two
  segments (the ping-pong pair of the double-buffering model);
* every other intermediate must be buffered whole.

Assignment is a linear scan over the node order: a buffer's live range is
``[def_index, last_use_index]``; a free slot is reused when its size fits
(slots grow to their largest tenant).  The report compares allocated bytes
against the naive sum — the quantity near-memory execution saves.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.schedule import CycleParams, ping_pong_shape
from repro_torch.compiler.ir import TMGraph
from repro_torch.compiler.partition import PartitionReport


@dataclasses.dataclass
class ScratchPlan:
    slot_of: dict[str, int]          # intermediate buffer -> slot id
    slot_bytes: list[int]            # size of each slot
    streamed: set[str]               # buffers held at 2-segment granularity
    naive_bytes: int                 # sum of full intermediate sizes
    itemsize: int = 4
    # streamed buffer -> its (2, row_block, minor) ping-pong pair via the
    # shared schedule.ping_pong_shape — the JAX package's chain megakernel
    # sizes its on-chip handoff the same way, so both packages account the
    # same slot bytes
    kernel_scratch_shapes: dict[str, tuple[int, int, int]] = \
        dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.slot_bytes)

    @property
    def reduction(self) -> float:
        if self.naive_bytes == 0:
            return 0.0
        return 1.0 - self.total_bytes / self.naive_bytes

    def summary(self) -> str:
        return (f"scratch: {len(self.slot_bytes)} slot(s), "
                f"{self.total_bytes} B allocated vs {self.naive_bytes} B "
                f"naive ({self.reduction:.1%} saved, "
                f"{len(self.streamed)} streamed buffer(s))")


def allocate(graph: TMGraph, part: PartitionReport | None = None,
             params: CycleParams | None = None,
             itemsize: int = 4) -> ScratchPlan:
    p = params or CycleParams()
    # buffers streamed over a forwarding edge only ever hold two segments
    streamed: set[str] = set()
    if part is not None:
        for ph in part.tmu_phases:
            if ph.schedule is not None:
                streamed.update(e.buffer for e in ph.schedule.forwards)

    ext = set(graph.inputs) | set(graph.outputs) | set(graph.consts)
    live: dict[str, tuple[int, int]] = {}  # name -> (def, last_use)
    for i, node in enumerate(graph.nodes):
        for s in node.srcs:
            if s in live:
                live[s] = (live[s][0], i)
        for d in node.dsts:
            if d not in ext:
                live[d] = (i, i)

    scratch_shapes = {name: ping_pong_shape(graph.shape(name), itemsize,
                                            p.segment_bytes)
                      for name in streamed}

    def need_bytes(name: str) -> int:
        full = math.prod(graph.shape(name)) * itemsize
        if name in streamed:
            # two segments of this buffer's plan — the same sizing rule the
            # chain kernel applies to its handoff scratch pair
            return min(full, math.prod(scratch_shapes[name]) * itemsize)
        return full

    naive = sum(math.prod(graph.shape(n)) * itemsize for n in live)
    # linear scan in def order
    slot_of: dict[str, int] = {}
    slot_bytes: list[int] = []
    slot_free_at: list[int] = []  # node index after which the slot is free
    for name, (d, u) in sorted(live.items(), key=lambda kv: kv[1][0]):
        nb = need_bytes(name)
        best = None
        for s in range(len(slot_bytes)):
            if slot_free_at[s] < d:
                # prefer the tightest-fitting free slot
                if best is None or abs(slot_bytes[s] - nb) < abs(
                        slot_bytes[best] - nb):
                    best = s
        if best is None:
            slot_of[name] = len(slot_bytes)
            slot_bytes.append(nb)
            slot_free_at.append(u)
        else:
            slot_of[name] = best
            slot_bytes[best] = max(slot_bytes[best], nb)
            slot_free_at[best] = u
    return ScratchPlan(slot_of=slot_of, slot_bytes=slot_bytes,
                       streamed=streamed, naive_bytes=naive,
                       itemsize=itemsize, kernel_scratch_shapes=scratch_shapes)
