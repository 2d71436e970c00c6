"""Device times of the flash kernels at the LM's shapes and around them.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_flash

Prints the card's name and power limit, then the kernel table's flash rows
(:mod:`repro_torch.tools.kernel_table`: ``flash_attention`` causal at
(8, 1024, 24/8, 128), the prefill of Phi-4-mini at batch 8, in bf16 and
f32; ``flash_decode`` bf16 at length 1025 of a (8, 1088, 8, 128) cache, a
decode step of the same model, with the row split the wrapper picks),
and around them, each checked and timed by the table's function beside
one SDPA call of the same attention:

* ``flash_attention`` bf16 at (8, 1024, 24/8, 64), and at
  (1, 8192, 24/8, 128) (the same work in longer rows: how much of the time
  is per tile rather than per row), timed only: its plain version and
  tolerance at that length would not fit in the card's memory;
* ``flash_decode`` at the decode step with splits of 64, 128, 256 and 1088
  rows (device ms, a CUDA graph of back-to-back calls).

Needs a CUDA device.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.h100 import card_line, graph_ms
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.tools import kernel_table as kt


def long_prefill(dev) -> None:
    S = 8192
    q, k, v = (torch.randn((1, S, n, 128), generator=torch.Generator().manual_seed(kt.SEED)).to(
        dev, torch.bfloat16) for n in (24, 8, 8))
    flops = 4 * 24 * 128 * (S * S + S) // 2
    ms = graph_ms(lambda: fa.flash_attention(q, k, v), 10)
    sdpa = graph_ms(kt.sdpa_call(q, k, v, is_causal=True), 10)
    kt.log(f"flash_attention bf16 (1, {S}, 24/8, 128): {ms:.4f} ms = "
           f"{flops / ms / 1e9:.1f} TFLOP/s; SDPA {sdpa:.4f} ms; kernel / "
           f"SDPA {ms / sdpa:.2f}")


def decode_splits(dev) -> None:
    q, k, v, length, n = kt.decode_inputs(dev)
    (B, T, KV, D), L = k.shape, length
    nbytes = (2 * B * L * KV * D + 2 * q.numel()) * 2
    sdpa = graph_ms(kt.sdpa_call(q, k[:, :L], v[:, :L]))
    plan = fa.decode_plan
    try:
        for rows in (64, 128, 256, T):  # the same kernels over another split
            fa.decode_plan = lambda *_, r=rows: (r, -(-T // r))
            ms = graph_ms(lambda: fa.flash_decode(q, k, v, n))
            kt.log(f"flash_decode bf16 length {L} of ({B}, {T}, {KV}, {D}), "
                   f"{-(-T // rows)} splits of {rows} rows: {ms:.4f} ms = "
                   f"{nbytes / ms / 1e9:.3f} TB/s; SDPA {sdpa:.4f} ms; "
                   f"kernel / SDPA {ms / sdpa:.2f}")
    finally:
        fa.decode_plan = plan


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_flash: no CUDA device", file=sys.stderr)
        return 1
    kt.log(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    with torch.inference_mode():
        for r in (kt.flash_attention_row(dev),
                  kt.prefill_case(dev, torch.bfloat16, D=64),
                  kt.flash_attention_f32_row(dev), kt.flash_decode_row(dev)):
            kt.log(kt.summary(r))
        long_prefill(dev)
        decode_splits(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
