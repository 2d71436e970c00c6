"""The numbers that decide ``correct``, each worked out from the program's
outputs and the reference's."""

from __future__ import annotations

import statistics


def loss_gap(program: list[float], reference: list[float]) -> float:
    """The widest gap of a step's loss, over the reference's loss."""
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def leaf_gaps(program: dict, reference: dict, names) -> dict:
    """Each leaf's gap between its norm in the program and in the
    reference, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    names = list(names)
    median = statistics.median(reference[n] for n in names)
    return {n: abs(program[n] - reference[n]) / max(reference[n], median)
            for n in names}


def moved(reference_grad: dict) -> list[str]:
    """The leaves whose change is compared: those whose first gradient in
    the reference is at least a thousandth of the median leaf's (a leaf
    below it moves under AdamW by round-off alone)."""
    median = statistics.median(reference_grad.values())
    return [n for n, g in reference_grad.items() if g >= 1e-3 * median]


def logit_gap(ref_logits, tokens):
    """The widest gap by which a token's logit lies below the reference's
    best at its position.  ``ref_logits`` (..., V) float32 reference
    logits; ``tokens`` (...) the tokens judged (the served ones, or the
    ones the control puts first)."""
    import torch
    best = ref_logits.amax(dim=-1)
    got = ref_logits.gather(-1, tokens.long()[..., None])[..., 0]
    return float(torch.max(best - got))
