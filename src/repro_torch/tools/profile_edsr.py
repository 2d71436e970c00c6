"""Device time by kernel of one EDSR x2 forward, eager and partitioned.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_edsr

EDSR x2 at ``init_edsr``'s defaults (feats 64, 8 residual blocks) with
random weights from seed 0, input (8, 224, 224, 3) f32: the eager model
(cuDNN convs, TF32 off, algorithm chosen by cuDNN's heuristics) and the
hand-partitioned forward (every conv through ``conv2d_call``).  For each,
``torch.profiler``'s CUDA kernel events of one forward after a warm-up: the
total and the six kernels that take the most time.  Prints the card's name
and power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

import torch


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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_edsr: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.executor import TMExecutor
    from repro_torch.kernels import build
    from repro_torch.models import cnn
    from repro_torch.models.partitioned import edsr_partitioned_forward

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
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
            by_kernel = kernel_times(fn)
            total = sum(ms for ms, _ in by_kernel.values())
            if total == 0:
                print(f"profile EDSR {name}: the profiler recorded no device "
                      f"time")
                return 1
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
            print(f"profile EDSR {name}: {total:.3f} ms of kernels in "
                  f"{sum(n for _, n in by_kernel.values())} launches; "
                  + "; ".join(f"{k[:70]} x{n} {ms:.3f} ms ({ms / total:.3f})"
                              for k, (ms, n) in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
