from repro_torch.kernels.rme_gather.ref import evaluate_ref  # noqa: F401
from repro_torch.kernels.rme_gather.rme_gather import (  # noqa: F401
    evaluate, evaluate_batched, rme_evaluate)
