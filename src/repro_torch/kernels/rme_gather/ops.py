"""Dispatch-registry rule for the RME evaluate kernel.

FINE_EVALUATE instructions with a runtime threshold and a static capacity
lower onto the kernel, with any number of leading batch axes flattened onto
its grid of record streams.  Top-k falls back to the engine.  FINE_ASSEMBLE
(the assemble kernel) is not ported yet and runs on the reference engine;
the executor's lowering report says so.
"""

from __future__ import annotations

import math

from repro_torch.core.dispatch import register_rule
from repro_torch.core.instr import TMOpcode
from repro_torch.kernels.rme_gather.rme_gather import (evaluate,
                                                       evaluate_batched)


def _evaluate_matches(ins, srcs, batch_dims, segment_bytes=None):
    if ins.opcode != TMOpcode.FINE_EVALUATE:
        return None
    cfg = ins.rme
    if cfg.top_k is not None or cfg.capacity is None or cfg.threshold is None:
        return None
    if len(srcs) != 1 or srcs[0].ndim != batch_dims + 2:
        return None
    return "cuda.rme.evaluate"


def _evaluate_run(ins, srcs, batch_dims, segment_bytes=None):
    cfg = ins.rme
    x = srcs[0].contiguous()
    if batch_dims == 0:
        rows, _, _ = evaluate(x, cfg.threshold, cfg.capacity, cmp=cfg.cmp,
                              score_index=cfg.score_index)
        return rows
    batch = tuple(x.shape[:batch_dims])
    rows, _, _ = evaluate_batched(
        x.reshape((-1,) + tuple(x.shape[batch_dims:])), cfg.threshold,
        cfg.capacity, cmp=cfg.cmp, score_index=cfg.score_index)
    return rows.reshape(batch + tuple(rows.shape[1:]))


def _rme_segments(ins, srcs, batch_dims, segment_bytes=None):
    # one compaction pass per record stream
    return max(1, math.prod(srcs[0].shape[:batch_dims]))


register_rule("rme_gather.evaluate", _evaluate_matches, _evaluate_run,
              priority=10, segments=_rme_segments)
