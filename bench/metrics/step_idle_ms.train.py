"""The median traced step's device idle inside its own `train/step` span
(each idle gap placed by its middle on the profiler's clock), in ms, over
the traced steps after the first, whose idle is the profiler's own start:
idle that the step's own dispatch caused, robust to a step that the
shared host held back."""

from bench.harness import spans


def read(r):
    return spans.step_idle_ms(r)
