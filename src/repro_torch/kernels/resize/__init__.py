from repro_torch.kernels.resize.ops import resize_call  # noqa: F401
from repro_torch.kernels.resize.ref import resize_ref  # noqa: F401
