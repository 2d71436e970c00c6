"""Hand-written CUDA kernels for Hopper, one package per JAX-package Pallas
kernel family, each with a plain PyTorch version beside it.  The sources
live in ``repro_torch/csrc`` and build at first use (:mod:`.build`)."""
