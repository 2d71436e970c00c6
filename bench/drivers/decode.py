"""Batch decode over long contexts: the port's decode step
(``runtime.step.make_decode_step``, greedy) as ``launch/serve.serve``
calls it, without a synchronisation a step.

``batch`` sequences whose caches hold ``context`` positions, drawn from the
seed in set-up; a round decodes ``gen`` tokens of every sequence from a
first token drawn from the seed, writing cache rows ``context`` on, and the
next round starts again at ``context``, so no prefill is needed.  Rounds
repeat through the window.  A request is one sequence's round.

Once the window has closed, a sample of the finished requests (rounds
drawn from the seed, rows spread evenly over the batch) is run through
the reference, which draws the weights and those rows' cache again and
feeds the served tokens: the widest gap by which a served token's logit
lies below the reference's best decides ``correct``.  The control reads
the gap of the token its fp8 products put first.
"""

from __future__ import annotations

import time

import torch

from bench.harness import compare, lmcfg, weights
from bench.reference import lm as ref


def fill_cache(r, d, layer: int, name: str, B: int, T: int, device):
    """Layer ``layer``'s ``name`` ("k" or "v") cache rows [0, T) of the B
    sequences: (B, T, KV, hd) in bf16."""
    return torch.empty((B, T, d.KV, d.hd), dtype=torch.bfloat16,
                       device=device).normal_(
        generator=r.generator("cache", name, layer))


def first_tokens(r, d, rnd: int, B: int):
    return torch.randint(0, d.V, (B, 1), generator=r.generator("first", rnd),
                         device=r.device, dtype=torch.int32)


def run(r):
    from repro_torch.models.transformer import init_caches
    from repro_torch.runtime.step import make_decode_step

    ref.exact_float32()
    p = r.params
    d = lmcfg.dims(r.config)
    cfg = lmcfg.port_config(r.config)
    B, ctx, gen = p["batch"], p["context"], p["gen"]

    params = weights.make_params(r.seed, d, r.device)
    caches = init_caches(cfg, B, ctx + gen, device=r.device)
    for i in range(d.L):
        for name in ("k", "v"):
            caches[name][i, :, :ctx] = fill_cache(r, d, i, name, B, ctx,
                                                  r.device)
    decode = make_decode_step(cfg)
    # warm-up at the window's shapes; its rows are written again by round 0
    tok = first_tokens(r, d, -1, B)
    for pos in range(ctx, ctx + p["warm_steps"]):
        tok, _, caches, _ = decode(params, tok, caches, None, pos)

    rounds = []
    rnd, pos = 0, ctx
    tok = first_tokens(r, d, rnd, B)
    served = [tok]
    r.begin_window()
    while r.running():
        t0 = time.perf_counter()
        tok, _, caches, _ = decode(params, tok, caches, None, pos)
        host = time.perf_counter() - t0
        served.append(tok)
        pos += 1
        r.step_done(tokens=B, length=pos, host_s=host)
        if pos == ctx + gen:
            rounds.append(served)
            rnd, pos = rnd + 1, ctx
            tok = first_tokens(r, d, rnd, B)
            served = [tok]
    r.end_window()
    steps = r.all_steps()
    r.attempted = B * (len(rounds) + (pos > ctx))
    r.failed = 0
    r.e2e["decode_tokens_per_s"] = sum(s["tokens"] for s in steps) / \
        r.window_seconds()
    r.counters["rounds"] = len(rounds)
    finished = [torch.cat(t, dim=1).cpu() for t in rounds]   # (B, gen + 1)
    del params, caches, tok, served, rounds
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    judge(r, d, finished)


def sample(r, n_rounds: int, B: int, n: int) -> list[tuple[int, int]]:
    """``n`` finished requests: rounds drawn from the seed, rows spread
    evenly over the batch from an offset drawn from the seed."""
    g = torch.Generator().manual_seed(r.seed)
    offset = int(torch.randint(0, B, (1,), generator=g))
    rows = [(offset + j * B // n) % B for j in range(n)]
    rnds = torch.randint(0, n_rounds, (n,), generator=g).tolist()
    return list(zip(rnds, rows))


def judge(r, d, finished: list):
    p = r.params
    if not finished:
        r.failed = r.attempted or 1
        r.check("logit_gap", float("nan"), r.limit("logit_gap"))
        return
    picks = sample(r, len(finished), p["batch"], p["check_requests"])
    rows = torch.tensor([b for _, b in picks], device=r.device)
    served = torch.stack([finished[k][b] for k, b in picks]).to(r.device)
    inputs, outputs = served[:, :-1], served[:, 1:]
    ctx, gen = p["context"], p["gen"]
    pos = torch.arange(ctx, ctx + gen, device=r.device)

    def past(i):
        return tuple(fill_cache(r, d, i, name, p["batch"], ctx,
                                r.device)[rows].float()
                     for name in ("k", "v"))

    table, final_g, layer_weights = weights.reference_weights(r.seed, d,
                                                           r.device)
    mms = [ref.EXACT, ref.FP8] if r.control else [ref.EXACT]
    with torch.no_grad():
        logits = ref.serve_logits(d, layer_weights, table, final_g,
                                  [(inputs, pos, past)], mms,
                                  last_only=False)
    exact = logits[0][0]
    r.check("logit_gap", compare.logit_gap(exact, outputs),
            r.limit("logit_gap"))
    if r.control:
        r.control_readings = {"logit_gap": compare.logit_gap(
            exact, logits[1][0].argmax(dim=-1))}
