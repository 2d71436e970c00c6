"""Device time of the training step's backward (the `train/backward`
span: the gradient, each layer's recompute included) a traced step, in
ms."""

from bench.harness import spans


def read(r):
    return spans.device_ms_per_step(r, "train/backward")
