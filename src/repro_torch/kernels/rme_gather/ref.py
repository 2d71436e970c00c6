"""Oracle for the RME kernel: the reference engine's RME."""

from __future__ import annotations

from repro_torch.core import rme


def evaluate_ref(x, threshold, capacity, *, cmp="ge", score_index=0):
    rows, idx, cnt = rme.evaluate(x, threshold, capacity, cmp=cmp,
                                  score_index=score_index)
    return rows, idx, cnt.reshape(1)
