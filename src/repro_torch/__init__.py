"""PyTorch/CUDA port of the TMU reproduction.

Mirrors the JAX package ``repro`` module for module: the TM instruction set
and its executor (``core``), hand-written Hopper kernels with their plain
PyTorch versions (``kernels``, sources in ``csrc``), and the paper's CNN
applications (``models``).  It imports nothing of ``repro`` and no JAX.
"""
