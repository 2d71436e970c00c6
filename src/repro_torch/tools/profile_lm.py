"""Where the time of the LM serving loop goes: prefill and one decode step.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_lm

Phi-4-mini 3.8B at its full published config (random bf16 weights from
seed 0, as ``launch/serve.py`` draws them), batch 8, a 1024-token prompt,
a 1088-row KV cache.  For the prefill and for one decode step at position
1024, each warm: the wall ms (host clock around the call and a device
synchronize, the least of three), then ``torch.profiler``'s CUDA kernel
events of one more call: the device ms of all kernels, the busy share
(kernel ms over wall ms; the rest is the device waiting for the host) and
the kernels that take the most time.  Prints the card's name and power
limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from repro_torch.tools.profile_edsr import kernel_times

ARCH, BATCH, PROMPT, GEN = "phi4-mini-3.8b", 8, 1024, 64


def wall_ms(fn, runs: int = 3) -> float:
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def report(name: str, fn) -> None:
    wall = wall_ms(fn)
    by_kernel = kernel_times(fn)
    total = sum(ms for ms, _ in by_kernel.values())
    if total == 0:
        raise RuntimeError(f"profile {name}: the profiler recorded no "
                           f"device time")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"profile {name}: wall {wall:.3f} ms, kernels {total:.3f} ms in "
          f"{sum(n for _, n in by_kernel.values())} launches, busy share "
          f"{total / wall:.3f}; "
          + "; ".join(f"{k[:60]} x{n} {ms:.3f} ms ({ms / total:.3f})"
                      for k, (ms, n) in top), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_lm: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import lm_inputs
    from repro_torch.models.transformer import init_caches
    from repro_torch.runtime.step import make_decode_step, make_prefill_step

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    build.build(["flash_attention"])
    dev = torch.device("cuda", 0)
    cfg = get_config(ARCH)
    with torch.inference_mode():
        params, prompts = lm_inputs(cfg, batch=BATCH, prompt_len=PROMPT,
                                    device=dev)
        caches = init_caches(cfg, BATCH, PROMPT + GEN, device=dev)
        prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
        lg, _, _ = prefill(params, prompts, caches, None)
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
        report(f"{ARCH} prefill {BATCH}x{PROMPT}",
               lambda: prefill(params, prompts, caches, None))
        report(f"{ARCH} decode step at {PROMPT} (batch {BATCH})",
               lambda: decode(params, tok, caches, None, PROMPT))
    return 0


if __name__ == "__main__":
    sys.exit(main())
