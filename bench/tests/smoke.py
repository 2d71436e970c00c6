"""Smoke-size cells for the CPU tests: the benchmark's own cells with
small configurations and short windows, run through the same harness and
drivers on the CPU (the port's plain versions of its kernels)."""

from __future__ import annotations

import contextlib
import copy
import time

import torch

from bench.harness import core, faults

# Qwen1.5-MoE's block at a small size: 8 experts top-4, a shared expert
MOE = {"name": "moe-smoke", "hidden_size": 64, "num_attention_heads": 4,
       "num_key_value_heads": 4, "intermediate_size": 96,
       "shared_expert_intermediate_size": 96, "moe_intermediate_size": 32,
       "num_experts": 8, "num_experts_per_tok": 4, "vocab_size": 512,
       "num_hidden_layers": 2, "rope_theta": 1e6,
       "initializer_range": 0.02,
       "run_as": {"dtype": "bfloat16", "norm_eps": 1e-6, "n_shared": 1,
                  "capacity_factor": 1.25, "aux_coef": 0.01,
                  "moe_pad_experts": 8, "attn_impl": "triangular",
                  "remat": "full", "max_seq": 4096}}
# Phi-4-mini's block at a small size: GQA 4 query heads over 2; weights
# drawn wider so that its logits spread as the full model's do
DENSE = {"name": "dense-smoke", "hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 128,
         "vocab_size": 1024, "num_hidden_layers": 2, "rope_theta": 1e4,
         "initializer_range": 0.2,
         "run_as": {"dtype": "bfloat16", "norm_eps": 1e-6, "remat": "full",
                    "max_seq": 4096}}

TRAIN_CELL = "qwen2-moe.train-b4x1024"
DECODE_CELL = "phi4-mini.decode-b64-c4096"
# limits at this size, set as the cells' are, from this size's readings
# (sound runs below them, the control above them: test_bench_control)
LIMITS = {TRAIN_CELL: {"grad_norm_gap": 0.01, "grad_norm_gap_median": 8e-4,
                       "change_gap": 0.004},
          DECODE_CELL: {"logit_gap": 0.3}}


def cell(name: str) -> tuple[dict, dict]:
    """(cell, configuration) of ``name`` cut to smoke size."""
    c = copy.deepcopy(core.load_cell(name))
    c["limits"] = dict(LIMITS[name])
    if c["driver"] == "train":
        c["params"].update(batch=2, seq=32, trace_seconds=0.5)
        return c, copy.deepcopy(MOE)
    c["params"].update(batch=4, context=32, gen=16, warm_steps=2,
                       check_requests=4, trace_seconds=0.5)
    return c, copy.deepcopy(DENSE)


def run(name: str, seed: int, *, fault: str | None = None,
        control: bool = False, trace: bool = False, seconds: float = 2.0):
    """One run of the smoke cell on the CPU, with ``fault`` planted."""
    c, cfg = cell(name)
    with (faults.planted(fault) if fault else contextlib.nullcontext()):
        return core.run_cell(c, cfg, seed=seed, seconds=seconds, trace=trace,
                             device=torch.device("cpu"),
                             t_start=time.monotonic(), control=control)
