"""Faults planted under a cell's timed path, for the tests and for the
readings that set a limit: each wraps one of the port's step builders so
that a run drives the broken step exactly as it drives the sound one.

- ``state_unchanged``: the step computes its outputs but leaves its state
  as it was (training: no update; decode: the new cache row not kept).
- ``half_batch``: the step sees only the first half of the batch
  (training: the loss is the mean over those rows; decode: the other
  rows' tokens repeat their input).
- ``token_altered``: the token (decode) or the answer's logits (prefill)
  shifted by one place where the step produces them.

:func:`planted` installs one for the length of a ``with`` block.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "half_batch", "token_altered")


def _train(make, fault):
    def builder(cfg, **kw):
        step = make(cfg, **kw)
        if fault == "half_batch":
            def half(state, batch):
                n = next(iter(batch.values())).shape[0] // 2
                return step(state, {k: v[:n] for k, v in batch.items()})
            return half
        if fault == "state_unchanged":
            from repro_torch.models.transformer import lm_loss

            def frozen(state, batch):
                with torch.no_grad():
                    loss, _ = lm_loss(cfg, state["params"],
                                      batch.get("tokens"), batch["labels"])
                return state, {"loss": loss}
            return frozen
        raise ValueError(f"training has no fault {fault!r}")
    return builder


def _decode(make, fault):
    def builder(cfg, **kw):
        step = make(cfg, **kw)

        def broken(params, token, caches, states, index, gen=None):
            if fault == "half_batch":
                n = token.shape[0] // 2
                half = {k: c[:, :n] for k, c in caches.items()}
                nxt, lg, _, states = step(params, token[:n], half, states,
                                          index, gen)
                return torch.cat([nxt, token[n:]]), lg, caches, states
            if fault == "state_unchanged":
                kept = {k: c[:, :, index].clone() for k, c in caches.items()}
                out = step(params, token, caches, states, index, gen)
                for k, c in caches.items():
                    c[:, :, index] = kept[k]
                return out
            nxt, lg, caches, states = step(params, token, caches, states,
                                           index, gen)
            return (nxt + 1) % cfg.vocab, lg, caches, states
        return broken
    return builder


def _prefill(make, fault):
    if fault != "token_altered":
        raise ValueError(f"prefill has no fault {fault!r}")

    def builder(cfg, **kw):
        step = make(cfg, **kw)

        def broken(params, tokens, caches, states):
            lg, caches, states = step(params, tokens, caches, states)
            return torch.roll(lg, 1, dims=-1), caches, states
        return broken
    return builder


@contextlib.contextmanager
def planted(fault: str):
    """The port's train, decode and prefill step builders replaced by
    broken ones for the block."""
    from repro_torch.runtime import step as step_mod
    saved = {n: getattr(step_mod, n) for n in
             ("make_train_step", "make_decode_step", "make_prefill_step")}
    step_mod.make_train_step = _train(saved["make_train_step"], fault)
    step_mod.make_decode_step = _decode(saved["make_decode_step"], fault)
    step_mod.make_prefill_step = _prefill(saved["make_prefill_step"], fault) \
        if fault == "token_altered" else saved["make_prefill_step"]
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(step_mod, n, f)
