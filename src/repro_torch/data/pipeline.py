"""Data pipeline: deterministic synthetic LM stream + host prefetch.

The JAX package's ``data/pipeline.py`` with PyTorch tensors.  A background
thread makes batch N+1 while step N runs, so the card does not wait on the
host (the host-side analogue of the paper's tensor prefetch and double
buffering, Fig. 5b).  The stream is deterministic in (seed, step), so a
restore at step k reproduces the rest of the stream exactly.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.core.executor import resolve_device


class SyntheticLM:
    """Zipf-distributed token stream with a learnable structure (each token
    weakly predicts the next) so training losses visibly decrease.  The
    JAX package's numpy generator, verbatim: the same batches bit for
    bit."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) + step)
        ranks = np.arange(1, self.vocab + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        base = rng.choice(self.vocab, size=(self.batch, self.seq + 1), p=probs)
        # inject structure: with p=0.5, token t+1 = (token t * 31 + 7) % vocab
        det = (base * 31 + 7) % self.vocab
        coin = rng.random((self.batch, self.seq + 1)) < 0.5
        toks = np.where(coin, np.roll(det, 1, axis=1), base)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def to_device(batch: dict[str, np.ndarray], device) -> dict:
    """A numpy batch as tensors on ``device``: through pinned memory and
    ``non_blocking`` to the card."""
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class PrefetchPipeline:
    """Double-buffered host prefetch (depth-2 queue, one producer thread).
    ``next()`` returns ``(step, batch)``, the batch passed through
    ``put_fn``, by default :func:`to_device` on ``device`` (None means the
    card)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2,
                 put_fn=None, device=None):
        self.source = source
        if put_fn is None:
            dev = resolve_device(device)
            put_fn = lambda b: to_device(b, dev)  # noqa: E731
        self.put_fn = put_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step, batch = self._step, None
        while not self._stop.is_set():
            if batch is None:
                batch = self.source.batch_at(step)
            try:
                self._q.put((step, batch), timeout=0.2)
            except queue.Full:
                continue  # the same batch again, once there is room
            step, batch = step + 1, None

    def __next__(self):
        step, batch = self._q.get()
        return step, self.put_fn(batch)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


def make_batch_specs(batch: int, seq: int) -> dict:
    """Stand-ins for a training batch (dry-run inputs): tensors on the
    ``meta`` device, which carry a shape and a dtype and are never
    allocated."""
    return {name: torch.empty((batch, seq), dtype=torch.int32, device="meta")
            for name in ("tokens", "labels")}
