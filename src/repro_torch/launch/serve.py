"""Serving drivers.

LM loop — batched prefill, then greedy decode with KV caches and SSM
states, for any of the ten archs of :mod:`repro_torch.configs.registry`:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
        --batch 8 --prompt-len 1024 --gen 64

CNN demo blocks through the TMU serving runtime (``repro_torch.serving``):

    PYTHONPATH=src python -m repro_torch.launch.serve --cnn --requests 24 \\
        --max-batch 4 --backend cuda

Both run on the card (``--device cpu`` runs the kernels' plain versions, the
LM at a ``--smoke`` size); ``--trace OUT.json`` exports the span timeline as
Chrome-trace JSON.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, get_smoke, list_archs
from repro_torch.core.executor import BACKENDS, resolve_device
from repro_torch.models.transformer import init_caches, init_lm, init_states
from repro_torch import obs
from repro_torch.obs.tracer import as_tracer
from repro_torch.runtime.step import make_decode_step, make_prefill_step

# ESPCN's served responses against its direct calls: the batched convs sum
# in another order than the per-request ones, so the two differ by float32
# rounding; the parity tests hold ESPCN to the same 1e-4
# (tests/test_torch_models.py ESPCN_ATOL), which TF32 convs do not meet
ESPCN_SERVED_ATOL = 1e-4


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
          log=print, tracer=None):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode greedily to ``gen`` tokens each (KV caches for the attention
    families, recurrent states for ssm and hybrid).  Returns ``(tokens (batch,
    gen) int32, stats)`` with the JAX package's keys; on the card the
    clocks stop after ``torch.cuda.synchronize()``, where the JAX package
    blocks until ready.  ``tracer`` (None: the process's current one,
    :func:`repro_torch.obs.current`) records the prefill and each decode
    step as spans on the ``lm`` track, each timed on the device, with the
    model's spans inside them; the decode steps do not wait for the
    device, as untraced ones do not."""
    tracer = obs.current() if tracer is None else as_tracer(tracer)
    dev = resolve_device(device)
    params, prompts = lm_inputs(cfg, batch=batch, prompt_len=prompt_len,
                                seed=seed, device=dev)
    caches = init_caches(cfg, batch, prompt_len + gen,
                         dtype=torch.float32 if cfg.dtype == torch.float32
                         else torch.bfloat16, device=dev)
    states = init_states(cfg, batch, device=dev)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with obs.use(tracer):
        sync()
        t0 = time.monotonic()
        with tracer.span(f"prefill@{batch}x{prompt_len}", track="lm",
                         device=dev, batch=batch, prompt_len=prompt_len):
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
            with tracer.span(f"decode/step@p{t}", track="lm", device=dev):
                tok, lg, caches, states = decode(params, tok, caches,
                                                 states, t)
            out.append(tok)
        sync()
        t_decode = time.monotonic() - t0
    toks = torch.cat(out, dim=1)
    tps = batch * (gen - 1) / max(t_decode, 1e-9)
    log(f"prefill {batch}x{prompt_len}: {t_prefill*1e3:.1f} ms; "
        f"decode {gen-1} steps: {t_decode*1e3:.1f} ms ({tps:.1f} tok/s)")
    return toks, {"prefill_s": t_prefill, "decode_s": t_decode,
                  "tokens_per_s": tps}


def cnn_demo_workload(*, n_requests=24, seed=0, device=None, espcn=None):
    """The JAX package's CNN demo mix (``repro/launch/serve.py``
    ``serve_cnn``) at its sizes: ``superres_tail`` / ``yolo_neck`` /
    ``detect_tail`` / a whole ESPCN x2, in turn, each in two shape classes.
    The inputs are the same numpy draws (``RandomState(seed).rand``, in the
    same order), so the two packages serve the same arrays.  ``espcn`` is
    the model to serve (its weights carried across from the JAX package,
    say); None draws one from a generator seeded with ``seed``.  Returns
    ``[(fn_key, fn, args)]`` with the tensors on ``device``."""
    from repro_torch.models import cnn

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)

    def arr(*shape):
        return torch.tensor(rng.rand(*shape).astype(np.float32), device=dev)

    def detect(pred):
        return cnn.detect_tail(pred, 0.5, 16)

    if espcn is None:
        espcn = cnn.init_espcn(torch.Generator().manual_seed(seed), s=2,
                               device=dev)
    workload = []
    for i in range(n_requests):
        kind = i % 4
        odd = (i // 4) % 2  # alternate shape classes inside each fn bucket
        if kind == 0:
            x = arr(1, 6 + 2 * odd, 10, 8)
            skip = arr(1, (6 + 2 * odd) * 2, 20, 2)
            workload.append(("superres", cnn.superres_tail, (x, skip)))
        elif kind == 1:
            u = arr(1, 4, 6 + 2 * odd, 6)
            skip = arr(1, 8, (6 + 2 * odd) * 2, 3)
            workload.append(("yolo_neck", cnn.yolo_neck, (u, skip)))
        elif kind == 2:
            workload.append(("detect_tail", detect, (arr(2, 33 + odd, 7),)))
        else:
            workload.append(("espcn", espcn, (arr(1, 8 + 2 * odd, 10, 3),)))
    return workload


def serve_cnn(*, n_requests=24, max_batch=4, backend="cuda", seed=0,
              device=None, log=print, tracer=None):
    """Drive the paper's CNN demo blocks through :class:`TMServer`.

    Mixed traffic over the tm_compile demo fragments (:func:`cnn_demo_workload`)
    — the shape-bucketed batcher coalesces per class, the compile cache
    de-duplicates, and the two-engine pipeline overlaps TM phases of one
    micro-batch with the conv compute of the next.  Every data-movement
    response is checked bit-exact against the direct call, ESPCN's within
    :data:`ESPCN_SERVED_ATOL`."""
    from repro_torch.serving import ServerConfig, TMServer

    dev = resolve_device(device)
    workload = cnn_demo_workload(n_requests=n_requests, seed=seed,
                                 device=dev)
    # the demo serves in float32: cuDNN's TF32 convs (its default on the
    # card) would round ESPCN's operands past ESPCN_SERVED_ATOL
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    try:
        with TMServer(ServerConfig(max_batch=max_batch, backend=backend,
                                   batch_timeout_s=0.01, trace=tracer,
                                   device=dev)) as srv:
            futs = [(key, fn, args, srv.submit(fn, *args, fn_key=key))
                    for key, fn, args in workload]
            for key, fn, args, fut in futs:
                got = fut.result(timeout=600)
                want = fn(*args)
                same = (torch.allclose(got, want, rtol=0,
                                       atol=ESPCN_SERVED_ATOL)
                        if key == "espcn" else torch.equal(got, want))
                if not same:
                    raise AssertionError(
                        f"served {key} result diverged from the direct "
                        f"call (max |err| "
                        f"{float((got - want).abs().max())})")
            stats = srv.snapshot_stats()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    wall = time.monotonic() - t0
    stats["wall_s"] = wall
    stats["requests_per_s"] = n_requests / max(wall, 1e-9)
    stats["device"] = str(dev)
    log(f"served {n_requests} CNN-block requests on {dev} in {wall:.2f}s "
        f"({stats['requests_per_s']:.1f} req/s); "
        f"cache {stats['cache']['hits']}/"
        f"{stats['cache']['hits'] + stats['cache']['misses']} hit, "
        f"mean batch {stats['mean_batch_size']:.2f}, "
        f"overlap {stats['overlap_ratio']:.1%} measured / "
        f"{stats['predicted_overlap']:.1%} predicted")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--cnn", action="store_true",
                    help="serve the CNN demo blocks through TMServer")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--backend", default="cuda", choices=BACKENDS)
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record a span timeline and export Chrome-trace "
                         "JSON (open at https://ui.perfetto.dev)")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)   # no card: a usage error, not a trace
    except RuntimeError as e:
        ap.error(str(e))
    tracer = as_tracer(bool(args.trace))
    if args.cnn:
        serve_cnn(n_requests=args.requests, max_batch=args.max_batch,
                  backend=args.backend, device=args.device, tracer=tracer)
    else:
        if args.arch is None:
            ap.error("--arch is required unless --cnn is given")
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
        toks, _ = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                        gen=args.gen, device=args.device, tracer=tracer)
        print("generated token ids (first row):", toks[0][:16].tolist())
    if args.trace:
        trace = tracer.export_chrome_trace(args.trace)
        print(f"trace: {len(trace['traceEvents'])} events -> {args.trace}")


if __name__ == "__main__":
    main()
