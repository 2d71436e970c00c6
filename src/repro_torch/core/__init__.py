"""The paper's contribution: unified address abstraction + TM execution model.

Public surface:
  affine    — AffineMap / MixedRadixMap / Table II operator library
  engine    — apply_map: the reconfigurable address-generation datapath
  instr     — TMOpcode / TMInstr / TMProgram (RISC-inspired encoding)
  executor  — 8-stage execution model (reference / fused / cuda backends)
  dispatch  — kernel-dispatch registry (TMInstr -> CUDA kernel lowering)
  schedule  — pipeline scheduler (double buffering + output forwarding model)
  rme       — reconfigurable masking engine (assemble / evaluate)
  tm_ops    — functional per-operator API
  fusion    — near-memory copy elision by map composition + forwarding edges
"""

from repro_torch.core import (affine, dispatch, engine, fusion, instr,  # noqa: F401
                              rme, schedule, tm_ops)
from repro_torch.core.executor import TMExecutor  # noqa: F401
