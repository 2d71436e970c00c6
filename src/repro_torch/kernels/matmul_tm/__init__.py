from repro_torch.kernels.matmul_tm.ops import (  # noqa: F401
    matmul_call, matmul_pixel_shuffle_call, matmul_split_call,
    matmul_tm_call, matmul_transpose_call)
from repro_torch.kernels.matmul_tm.ref import (  # noqa: F401
    matmul_pixel_shuffle_ref, matmul_ref, matmul_transpose_ref)
