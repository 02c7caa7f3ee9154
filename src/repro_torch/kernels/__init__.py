"""Hand-written CUDA kernels for Hopper (``sm_90a``), one sub-package per
kernel family, each with its plain PyTorch version beside it.

Kernels are built from their ``csrc/`` sources at first use
(:mod:`repro_torch.kernels.build`); importing this package builds
nothing, so it imports on machines without ``nvcc`` or a GPU.
"""
