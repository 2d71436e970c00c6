from repro_torch.kernels.tm_affine.ref import tm_affine_ref  # noqa: F401
from repro_torch.kernels.tm_affine.tm_affine import (  # noqa: F401
    tm_affine_block, tm_affine_gather)
from repro_torch.kernels.tm_affine.chain import tm_chain  # noqa: F401
