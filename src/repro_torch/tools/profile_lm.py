"""Where the time of the LM serving loop goes: prefill and one decode step.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_lm [ARCH]

``ARCH`` (default ``phi4-mini-3.8b``) at its full published config (random
bf16 weights from seed 0, as ``launch/serve.py`` draws them), batch 8, a
1024-token prompt, a 1088-row KV cache (and the recurrent state where the
family has one).  For the prefill and for one decode step at position
1024, each warm: the wall ms (host clock around the call and a device
synchronize, the least of three), then ``torch.profiler``'s CUDA kernel
events of one more call: the device ms of all kernels, the busy share
(kernel ms over wall ms; the rest is the device waiting for the host) and
the kernels that take the most time.  Prints the card's name and power
limit first.  For an MoE arch, also the wall ms of each piece of layer
0's MoE block at the decode and the prefill shape (routing, dispatch,
the expert products, the combine), each the least of three synced calls.
Needs a CUDA device.
"""

from __future__ import annotations

import sys
import time

import torch

from repro_torch.h100 import card_line

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


def kernel_times(fn) -> dict[str, list]:
    """{kernel name: [device ms, launches]} over one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            row = by_kernel.setdefault(ev.name, [0.0, 0])
            row[0] += ev.time_range.elapsed_us() / 1e3
            row[1] += 1
    return by_kernel


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


def moe_split(cfg, params, x) -> None:
    """Wall ms of each piece of layer 0's MoE block on ``x``."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import _layer
    p = _layer(params["blocks"], 0)["moe"]
    B, S, _ = x.shape
    k, E = cfg.top_k, p["wi"].shape[0]
    cap = moe.capacity_of(S, k, cfg.num_experts, cfg.capacity_factor)
    _, gates, experts = moe.route(p, x, top_k=k)
    idx, valid, xe = moe._dispatch(x, experts, E, cap)
    ye = moe._experts(p, xe)
    pieces = {
        "route": lambda: moe.route(p, x, top_k=k),
        "dispatch": lambda: moe._dispatch(x, experts, E, cap),
        "experts": lambda: moe._experts(p, xe),
        "combine": lambda: moe._combine(ye, gates, experts, idx, valid, S),
        "whole block": lambda: moe.moe_block(
            p, x, num_experts=cfg.num_experts, top_k=k,
            n_shared=cfg.n_shared, capacity_factor=cfg.capacity_factor)}
    print(f"profile {cfg.name} MoE layer 0 at ({B}, {S}), capacity {cap}: "
          + "; ".join(f"{name} {wall_ms(fn):.3f} ms"
                      for name, fn in pieces.items()), flush=True)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("profile_lm: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import lm_inputs
    from repro_torch.models.layers import embed
    from repro_torch.models.transformer import init_caches, init_states
    from repro_torch.runtime.step import make_decode_step, make_prefill_step

    argv = sys.argv[1:] if argv is None else argv
    arch = argv[0] if argv else ARCH
    print(card_line())
    build.build(["flash_attention", "rme_gather"])
    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    with torch.inference_mode():
        params, prompts = lm_inputs(cfg, batch=BATCH, prompt_len=PROMPT,
                                    device=dev)
        caches = init_caches(cfg, BATCH, PROMPT + GEN, device=dev)
        states = init_states(cfg, BATCH, device=dev)
        prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
        lg, _, _ = prefill(params, prompts, caches, states)
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
        report(f"{arch} prefill {BATCH}x{PROMPT}",
               lambda: prefill(params, prompts, caches, states))
        report(f"{arch} decode step at {PROMPT} (batch {BATCH})",
               lambda: decode(params, tok, caches, states, PROMPT))
        if cfg.family == "moe":
            x = embed(params["embed"], prompts)
            moe_split(cfg, params, x[:, :1])
            moe_split(cfg, params, x)
    return 0


if __name__ == "__main__":
    sys.exit(main())
