"""Open-loop load generation: Poisson arrivals over a mixed request mix.

The tail-latency benchmark needs *open-loop* load — arrivals keep coming at
the offered rate whether or not the server has fallen behind, which is what
exposes queueing tails (a closed loop self-throttles and hides them).  The
schedule is generated up front from a seeded RNG, so the exact same arrival
process replays against every scheduler under comparison; the driver only
sleeps to each arrival timestamp and calls ``submit``.

Inter-arrival gaps are exponential (rate ``rate_rps``), i.e. a Poisson
process; request size and priority class are sampled per-arrival from
weighted mixes.  A ``deadline_frac`` slice of requests carries a relative
deadline (``deadline_s``), which the server escalates to the deadline class.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Sequence


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One reproducible open-loop run."""

    rate_rps: float                 # offered arrival rate (Poisson)
    duration_s: float               # arrival window (not completion window)
    seed: int = 0
    # (value, weight) mixes — weights need not sum to 1
    sizes: Sequence[tuple[int, float]] = ((8, 0.6), (16, 0.3), (32, 0.1))
    priorities: Sequence[tuple[str, float]] = (("interactive", 0.7),
                                               ("batch", 0.3))
    deadline_s: float | None = None  # relative deadline for the slice below
    deadline_frac: float = 0.0       # fraction of arrivals carrying it

    def __post_init__(self):
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.duration_s < 0:
            raise ValueError(f"duration_s must be >= 0, "
                             f"got {self.duration_s}")
        if not self.sizes:
            raise ValueError("sizes mix must be non-empty")
        if not self.priorities:
            raise ValueError("priorities mix must be non-empty")
        if not 0.0 <= self.deadline_frac <= 1.0:
            raise ValueError(f"deadline_frac must be in [0, 1], "
                             f"got {self.deadline_frac}")
        if self.deadline_frac > 0 and self.deadline_s is None:
            raise ValueError("deadline_frac > 0 requires deadline_s")


@dataclasses.dataclass(frozen=True)
class GenRequest:
    """One scheduled arrival (relative to the run's t0)."""

    t_arrival: float
    size: int
    priority: str
    deadline_s: float | None


def _weighted(rng: random.Random, pairs: Sequence[tuple[Any, float]]) -> Any:
    total = sum(w for _, w in pairs)
    x = rng.uniform(0.0, total)
    acc = 0.0
    for value, w in pairs:
        acc += w
        if x <= acc:
            return value
    return pairs[-1][0]


def arrival_times(spec: LoadSpec) -> list[float]:
    """Poisson arrival timestamps in ``[0, duration_s)`` (seeded)."""
    rng = random.Random(spec.seed)
    t, out = 0.0, []
    while True:
        t += rng.expovariate(spec.rate_rps)
        if t >= spec.duration_s:
            return out
        out.append(t)


def generate(spec: LoadSpec) -> list[GenRequest]:
    """The full request schedule: arrivals + per-request mix samples.

    Mix sampling uses an independent RNG stream (``seed + 1``) so changing
    the size/priority mix never perturbs the arrival process itself."""
    mix = random.Random(spec.seed + 1)
    out = []
    for t in arrival_times(spec):
        deadline = (spec.deadline_s
                    if spec.deadline_frac > 0
                    and mix.random() < spec.deadline_frac else None)
        out.append(GenRequest(
            t_arrival=t,
            size=_weighted(mix, tuple(spec.sizes)),
            priority=("deadline" if deadline is not None
                      else _weighted(mix, tuple(spec.priorities))),
            deadline_s=deadline))
    return out


def run_load(submit: Callable[[GenRequest], Any], spec: LoadSpec, *,
             now: Callable[[], float] = time.monotonic,
             sleep: Callable[[float], None] = time.sleep) -> list[Any]:
    """Replay ``spec`` open-loop: sleep to each arrival and call
    ``submit(gen_request)``; returns the per-request submit results (the
    driver's futures).  Late arrivals (the driver fell behind) are submitted
    immediately — open-loop means the backlog lands on the server, not on
    the generator."""
    schedule = generate(spec)
    t0 = now()
    out = []
    for gr in schedule:
        delay = t0 + gr.t_arrival - now()
        if delay > 0:
            sleep(delay)
        out.append(submit(gr))
    return out
