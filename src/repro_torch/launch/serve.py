"""LM serving loop: batched prefill, then greedy decode with KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
        --batch 8 --prompt-len 1024 --gen 64

runs on the card (``--device cpu`` runs the kernels' plain versions, at a
``--smoke`` size).  The JAX package's ``--cnn`` (the CNN demo through
``TMServer``) and ``--trace`` (the span tracer) arrive with the serving and
observability slices; the CLI refuses them until then.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_config, get_smoke, list_archs
from repro_torch.core.executor import resolve_device
from repro_torch.models.transformer import init_caches, init_lm, init_states
from repro_torch.runtime.step import make_decode_step, make_prefill_step


def lm_inputs(cfg, *, batch: int, prompt_len: int, seed: int = 0,
              device=None):
    """The parameters and prompts :func:`serve` draws: weights from a
    generator seeded with ``seed``, prompts from one seeded with
    ``seed + 1``, both on ``device`` (None means the card)."""
    dev = resolve_device(device)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed),
                     device=dev)
    prompts = torch.randint(
        0, cfg.vocab, (batch, prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed + 1))
    return params, prompts


def serve(cfg, *, batch=4, prompt_len=32, gen=32, seed=0, device=None,
          log=print):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode greedily to ``gen`` tokens each.  Returns ``(tokens (batch,
    gen) int32, stats)`` with the JAX package's keys; on the card the
    clocks stop after ``torch.cuda.synchronize()``, where the JAX package
    blocks until ready."""
    dev = resolve_device(device)
    params, prompts = lm_inputs(cfg, batch=batch, prompt_len=prompt_len,
                                seed=seed, device=dev)
    caches = init_caches(cfg, batch, prompt_len + gen,
                         dtype=torch.float32 if cfg.dtype == torch.float32
                         else torch.bfloat16, device=dev)
    states = init_states(cfg, batch)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.monotonic()
    lg, caches, states = prefill(params, prompts, caches, states)
    tok = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
    sync()
    t_prefill = time.monotonic() - t0

    if gen <= 0:
        # prefill-only run: report prefill throughput, no decode rate
        tps = batch * prompt_len / max(t_prefill, 1e-9)
        log(f"prefill {batch}x{prompt_len}: {t_prefill*1e3:.1f} ms "
            f"({tps:.1f} prompt tok/s, prefill-only)")
        return torch.zeros((batch, 0), dtype=torch.int32, device=dev), {
            "prefill_s": t_prefill, "decode_s": 0.0,
            "tokens_per_s": tps, "prefill_only": True}

    out = [tok]
    t0 = time.monotonic()
    for t in range(prompt_len, prompt_len + gen - 1):
        tok, lg, caches, states = decode(params, tok, caches, states, t)
        out.append(tok)
    sync()
    t_decode = time.monotonic() - t0
    toks = torch.cat(out, dim=1)
    tps = batch * (gen - 1) / max(t_decode, 1e-9)
    log(f"prefill {batch}x{prompt_len}: {t_prefill*1e3:.1f} ms; "
        f"decode {gen-1} steps: {t_decode*1e3:.1f} ms ({tps:.1f} tok/s)")
    return toks, {"prefill_s": t_prefill, "decode_s": t_decode,
                  "tokens_per_s": tps}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--cnn", action="store_true",
                    help="not ported yet: arrives with the serving slice")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="not ported yet: arrives with the obs slice")
    args = ap.parse_args(argv)
    if args.cnn:
        ap.error("--cnn (the CNN demo through TMServer) is not ported yet: "
                 "it arrives with the serving slice")
    if args.trace:
        ap.error("--trace (the span tracer) is not ported yet: it arrives "
                 "with the obs slice")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    toks, _ = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    gen=args.gen, device=args.device)
    print("generated token ids (first row):", toks[0][:16].tolist())


if __name__ == "__main__":
    main()
