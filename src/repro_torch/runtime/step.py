"""Prefill and decode step builders (the JAX package's ``runtime/step.py``,
serving half; the train step arrives with the training slice).

Each builder returns a plain function of ``(params, tokens, caches,
states, ...)``.  PyTorch runs eagerly, so nothing is jitted; the caches are
written in place (the JAX package donates them).  ``attention`` is passed
to the model's forward: ``"flash"`` (the kernels) or ``"plain"`` (the JAX
package's jnp attention, ported).
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import ModelConfig, forward, logits


def make_prefill_step(cfg: ModelConfig, *, attention: str = "flash"):
    def prefill_step(params, tokens, caches, states):
        hidden, caches, states, _ = forward(cfg, params, tokens=tokens,
                                            caches=caches, cache_index=0,
                                            states=states,
                                            attention=attention)
        lg = logits(cfg, params, hidden[:, -1:])
        return lg, caches, states

    return prefill_step


def make_prefill_embeds_step(cfg: ModelConfig, *, attention: str = "flash"):
    """Prefill from precomputed embeddings (the audio / vision stub
    frontends): ``prefill_step(params, embeds, caches, states)``."""
    def prefill_step(params, embeds, caches, states):
        hidden, caches, states, _ = forward(cfg, params, embeds=embeds,
                                            caches=caches, cache_index=0,
                                            states=states,
                                            attention=attention)
        lg = logits(cfg, params, hidden[:, -1:])
        return lg, caches, states

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, sample: bool = False,
                     temperature: float = 1.0, attention: str = "flash"):
    """``decode_step(params, token, caches, states, index, gen=None)`` ->
    ``(next_token (B, 1) int32, logits, caches, states)``: greedy, or with
    ``sample=True`` a draw from softmax(logits / temperature) using the
    explicit ``torch.Generator`` ``gen``."""
    def decode_step(params, token, caches, states, index: int, gen=None):
        hidden, caches, states, _ = forward(cfg, params, tokens=token,
                                            caches=caches, cache_index=index,
                                            states=states,
                                            attention=attention)
        lg = logits(cfg, params, hidden)
        if sample:
            if gen is None:
                raise ValueError("decode_step: sample=True needs a "
                                 "torch.Generator (gen=...)")
            probs = torch.softmax(lg[:, -1].float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(lg[:, -1], dim=-1)
        return nxt[:, None].to(torch.int32), lg, caches, states

    return decode_step
