"""Device time of the training step's optimizer (the `train/optimizer`
span: the schedule and AdamW) a traced step, in ms."""

from bench.harness import spans


def read(r):
    return spans.device_ms_per_step(r, "train/optimizer")
