"""Device time of the training step's forward (the `train/forward` span:
`lm_loss`) a traced step, in ms."""

from bench.harness import spans


def read(r):
    return spans.device_ms_per_step(r, "train/forward")
