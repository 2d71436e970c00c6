"""Device times of the flash kernels at the LM's shapes and around them.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_flash

Prints the card's name and power limit, then one line per case: the
kernel's device ms (a CUDA graph of back-to-back calls, timed with CUDA
events) and its rate beside one SDPA call of the same attention:

* ``flash_attention`` causal, bf16 at (8, 1024, 24/8, 128) (the prefill of
  Phi-4-mini at batch 8), (1, 8192, 24/8, 128) (the same work in longer
  rows: how much of the time is per tile rather than per row) and
  (8, 1024, 24/8, 64), and f32 at the first shape;
* ``flash_decode`` bf16 at length 1025 of a (8, 1088, 8, 128) cache (a
  decode step of the same model), with the row split the wrapper picks and
  with splits of 64, 128, 256 and 1088 rows.

Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention as fa


def graph_ms(fn, iters: int = 10) -> float:
    """Device ms per call of ``fn``: ``iters`` calls in one CUDA graph."""
    fn()
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
    return start.elapsed_time(end) / iters


def prefill(gen, dev, B, S, H, KV, D, dtype) -> None:
    q, k, v = (torch.randn((B, S, n, D), generator=gen).to(dev, dtype)
               for n in (H, KV, KV))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flops = 4 * B * H * D * (S * S + S) // 2
    iters = 10 if dtype == torch.bfloat16 else 3
    ms = graph_ms(lambda: fa.flash_attention(q, k, v), iters)
    sdpa = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters)
    print(f"flash_attention {str(dtype)[6:]} ({B}, {S}, {H}/{KV}, {D}): "
          f"{ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s; SDPA "
          f"{sdpa:.4f} ms; kernel / SDPA {ms / sdpa:.2f}", flush=True)


def decode(gen, dev) -> None:
    B, T, H, KV, D, L = 8, 1088, 24, 8, 128, 1025
    q = torch.randn((B, 1, H, D), generator=gen).to(dev, torch.bfloat16)
    k, v = (torch.randn((B, T, KV, D), generator=gen).to(dev, torch.bfloat16)
            for _ in range(2))
    n = torch.tensor([L], dtype=torch.int32, device=dev)
    qt, kt, vt = q.transpose(1, 2), k[:, :L].transpose(1, 2), \
        v[:, :L].transpose(1, 2)
    nbytes = (2 * B * L * KV * D + 2 * q.numel()) * 2
    sdpa = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True), 20)
    plan = fa.decode_plan
    try:
        for rows in (None, 64, 128, 256, T):
            if rows is not None:  # the same kernels over another split
                fa.decode_plan = lambda *_, r=rows: (r, -(-T // r))
            r, splits = fa.decode_plan(B, T, H, KV, dev, q.dtype)
            ms = graph_ms(lambda: fa.flash_decode(q, k, v, n), 20)
            which = " (the wrapper's)" if rows is None else ""
            print(f"flash_decode bf16 length {L} of ({B}, {T}, {KV}, {D}), "
                  f"{splits} splits of {r} rows{which}: {ms:.4f} ms = "
                  f"{nbytes / ms / 1e9:.3f} TB/s; SDPA {sdpa:.4f} ms; "
                  f"kernel / SDPA {ms / sdpa:.2f}", flush=True)
    finally:
        fa.decode_plan = plan


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_flash: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        for B, S, D, dtype in ((8, 1024, 128, torch.bfloat16),
                               (1, 8192, 128, torch.bfloat16),
                               (8, 1024, 64, torch.bfloat16),
                               (8, 1024, 128, torch.float32)):
            prefill(gen, dev, B, S, 24, 8, D, dtype)
        decode(gen, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
