"""repro_torch.sched — continuous batching, priority classes, and phase-boundary
preemption over the TMU/TPU stream runtime.

:class:`ContinuousScheduler` is the default admission path of
:class:`~repro_torch.serving.server.TMServer` (``ServerConfig(scheduler=
"continuous")``); :mod:`repro_torch.sched.loadgen` drives the open-loop
tail-latency benchmark.
"""

from repro_torch.sched.loadgen import (GenRequest, LoadSpec, arrival_times,
                                 generate, run_load)
from repro_torch.sched.scheduler import (ContinuousScheduler, Priority, SchedConfig,
                                   SchedStats)

__all__ = [
    "ContinuousScheduler",
    "GenRequest",
    "LoadSpec",
    "Priority",
    "SchedConfig",
    "SchedStats",
    "arrival_times",
    "generate",
    "run_load",
]
