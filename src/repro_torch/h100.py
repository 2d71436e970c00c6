"""The card the port is measured on, one NVIDIA H100 SXM: its published
peaks, the bound they set on a piece of work, the two device timers of the
port's card tooling, and the card's name and power limit.

The peaks are NVIDIA's H100 Tensor Core GPU data sheet's for the SXM part:
dense rates without sparsity, at its full power limit of 700 W.  A card
set below it runs slower under load, so every time measured against them
is kept beside :func:`card_line`.
"""

from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12  # HBM3
F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12   # bf16 on the tensor cores


def bound_ms(nbytes: float, f32_ops: float = 0,
             bf16_ops: float = 0) -> tuple[float, str]:
    """The least time the card could take for work that moves ``nbytes``
    to or from HBM and computes ``f32_ops`` f32 and ``bf16_ops`` bf16
    operations: the largest of the three times at the peaks, in ms, and
    what sets it (``"bytes"``, or ``"operations"`` where an operation
    count's time is the larger)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(f32_ops / F32_FLOP_PER_S, bf16_ops / BF16_FLOP_PER_S)
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn()`` per call: ``iters`` calls captured in one CUDA
    graph and replayed, so no host work sits between the launches."""
    fn()  # builds, caches and first allocations happen outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls
    between two CUDA events: with the host work of each call wherever the
    host is slower than the device, and for functions a CUDA graph cannot
    capture (a plain version that builds a host tensor)."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
