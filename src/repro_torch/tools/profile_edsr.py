"""Device time by kernel of one EDSR x2 forward, eager and partitioned.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_edsr

EDSR x2 at ``init_edsr``'s defaults (feats 64, 8 residual blocks) with
random weights from seed 0, input (8, 224, 224, 3) f32: the eager model
(cuDNN convs, TF32 off, algorithm chosen by cuDNN's heuristics) and the
hand-partitioned forward (every conv through ``conv2d_call``).  For each,
the wall ms (the least of three synced calls) and ``torch.profiler``'s
CUDA kernel events of one more: the total, the busy share and the six
kernels that take the most time (``profile_lm.report``).  Prints the
card's name and power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.h100 import card_line
from repro_torch.tools.profile_lm import report


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_edsr: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.executor import TMExecutor
    from repro_torch.kernels import build
    from repro_torch.models import cnn
    from repro_torch.models.partitioned import edsr_partitioned_forward

    print(card_line())
    build.build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        model = cnn.init_edsr(gen, device=dev)
        img = torch.rand((8, 224, 224, 3), generator=gen).to(dev)
        ex = TMExecutor(backend="cuda", device=dev)
        runs = {"eager": lambda: model(img),
                "partitioned": lambda: edsr_partitioned_forward(model, img,
                                                                ex)}
        for name, fn in runs.items():
            report(f"EDSR {name}", fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
