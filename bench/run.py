#!/usr/bin/env python3
"""Run one benchmark cell once, on this machine's card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints the checks on standard error and, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and ``checks``.  The program under test is
the PyTorch port in ``src/repro_torch`` beside this folder; its CUDA
builds land in ``build/`` inside the checkout.
"""

import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)

from bench.harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T_START))
