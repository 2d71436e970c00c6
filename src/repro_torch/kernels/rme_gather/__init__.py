from repro_torch.kernels.rme_gather.ref import evaluate_ref  # noqa: F401
from repro_torch.kernels.rme_gather.rme_gather import (  # noqa: F401
    assemble, assemble_batched, evaluate, evaluate_batched, evaluate_chained,
    rme_assemble, rme_evaluate, rme_evaluate_chained)
