"""Training driver: data pipeline + step loop + fault tolerance +
checkpointing (the JAX package's ``launch/train.py``).

Runs on the card; a smoke config trains on the CPU through the Python
entry point (``train(get_smoke(arch), device="cpu")``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch mistral-nemo-12b \\
        --smoke --steps 50 --batch 8 --seq 64 --ckpt /tmp/ckpt

``--trace OUT.json`` records every step's ``train/*`` spans (and the MoE
block's ``moe/*`` spans and counters), each timed on the card, and exports
them as Chrome-trace JSON (open at https://ui.perfetto.dev).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config, get_smoke, list_archs
from repro_torch.core.executor import resolve_device
from repro_torch.data.pipeline import PrefetchPipeline, SyntheticLM
from repro_torch.launch.mesh import rules_for_cell
from repro_torch.models.transformer import init_lm, lm_specs
from repro_torch.obs import as_tracer
from repro_torch.runtime import sharding as shard_lib
from repro_torch.runtime.elastic import reshard_state
from repro_torch.runtime.fault_tolerance import Heartbeat, StragglerDetector
from repro_torch.runtime.step import (init_train_state, make_train_step,
                                      state_specs, train_state_of)


def train(cfg, *, steps=50, batch=8, seq=64, ckpt_dir=None, ckpt_every=25,
          peak_lr=1e-2, compress=False, mesh=None, log_every=10, seed=0,
          log=print, device=None, tracer=None):
    """Train ``cfg`` from weights drawn with ``seed`` (or from the latest
    checkpoint in ``ckpt_dir``) up to ``steps`` on ``SyntheticLM``
    batches, on ``device`` (None means the card).  With ``mesh`` (a
    DeviceMesh over the process group the caller set up) the state is
    placed onto it by the train rules (``rules_for_cell("train")``), each
    batch is split over its batch axes and the step runs under those
    rules.  ``tracer`` records each step's spans
    (:func:`make_train_step`).  Returns ``(state, losses)``, one loss for
    each step this call ran."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    step_fn = make_train_step(cfg, peak_lr=peak_lr, warmup=max(steps // 10, 1),
                              total=steps, compress=compress, tracer=tracer)
    place = {}
    if mesh is None:
        state = init_train_state(cfg, gen, compress=compress, device=dev)
    else:
        rules = rules_for_cell("train")
        place = dict(mesh=mesh, spec_tree=state_specs(
            lm_specs(cfg), compress=compress), rules=rules)
        # the weights onto the mesh first, the optimizer state made from
        # them: no rank ever holds the whole state
        state = train_state_of(reshard_state(
            init_lm(cfg, gen, device=dev), lm_specs(cfg), mesh, rules),
            compress=compress)
        step_fn = _on_mesh(step_fn, mesh, rules)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        state, start = mgr.restore(device=dev, **place)
        log(f"[restore] resumed from step {start}")

    src = SyntheticLM(vocab=cfg.vocab, batch=batch, seq=seq, seed=seed)
    pipe = PrefetchPipeline(src, start_step=start, device=dev)
    hb = Heartbeat(deadline_s=600)
    sd = StragglerDetector()
    losses = []
    try:
        for i in range(start, steps):
            t0 = time.monotonic()
            _, b = next(pipe)
            state, met = step_fn(state, b)
            loss = float(met["loss"])
            losses.append(loss)
            hb.beat()
            slow = sd.record(time.monotonic() - t0)
            if i % log_every == 0 or i == steps - 1:
                log(f"step {i:5d} loss {loss:8.4f} "
                    f"gnorm {float(met['grad_norm']):8.3f} "
                    f"lr {float(met['lr']):.2e}"
                    f"{'  [straggler]' if slow else ''}")
            if mgr and (i + 1) % ckpt_every == 0:
                mgr.save(i + 1, state)
        if mgr:
            mgr.save(steps, state, blocking=True)
    finally:
        pipe.close()
    return state, losses


def _on_mesh(step_fn, mesh, rules):
    """``step_fn`` under ``use_rules(mesh, rules)``, its batch split over
    the batch axes first (the JAX package's batch in-shardings)."""
    def step(state, batch):
        with shard_lib.use_rules(mesh, rules):
            batch = {k: shard_lib.distribute(v, mesh, shard_lib.placements_of(
                shard_lib.spec_of(("batch",) + (None,) * (v.ndim - 1)),
                mesh)) for k, v in batch.items()}
            return step_fn(state, batch)

    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record each step's spans and counters and export "
                         "Chrome-trace JSON (open at https://ui.perfetto.dev)")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    tracer = as_tracer(bool(args.trace))
    _, losses = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      ckpt_dir=args.ckpt, compress=args.compress,
                      peak_lr=args.lr, device=args.device, tracer=tracer)
    print(f"final loss: {losses[-1]:.4f} (from {losses[0]:.4f})")
    if args.trace:
        trace = tracer.export_chrome_trace(args.trace)
        print(f"trace: {len(trace['traceEvents'])} events -> {args.trace}")


if __name__ == "__main__":
    main()
