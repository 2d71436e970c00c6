from repro_torch.kernels.img2col.ops import conv2d_call, img2col_call  # noqa: F401
from repro_torch.kernels.img2col.ref import conv2d_ref, img2col_ref  # noqa: F401
