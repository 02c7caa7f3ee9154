"""Hand-written CUDA kernels for Hopper (``sm_90a``), one sub-package per
kernel family, each with its plain PyTorch version beside it.

Kernels are built from their ``csrc/`` sources at first use, all into one
library (:mod:`repro_torch.kernels.build`); importing this package
builds nothing, so it imports on machines without ``nvcc`` or a GPU.

No kernel has a backward: the JAX package trains through the jnp twins
of its Pallas kernels, and the port trains through its torch twins
(``cfg.use_flash=False``).  A wrapper refuses an input that requires
grad (:func:`refuse_grad`) rather than fall back to its twin.

A fake tensor (``FakeTensorMode``: a dry-run's, holding no data) takes
neither a wrapper's CUDA route nor its plain version: the wrapper
allocates the kernel's outputs, launches and counts nothing, and reports
the kernel's work (:func:`fake_launch`) to every :func:`kernel_costs`
list active, as the dry-run's roofline does.
"""
import contextlib
import contextvars

import torch
from torch._subclasses.fake_tensor import FakeTensor

_costs: contextvars.ContextVar = contextvars.ContextVar("repro_torch_kernel_costs",
                                                        default=())


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would need a gradient through kernel ``name``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel has no backward; train "
            f"with cfg.use_flash=False (the torch twins), as the JAX package trains "
            f"through its jnp twins"
        )


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a dry-run's fake tensor (no data to compute on)."""
    return isinstance(t, FakeTensor)


@contextlib.contextmanager
def kernel_costs():
    """Yield a list that collects ``(kernel, flops, bytes)`` of each kernel
    a wrapper stands in for on fake tensors until the block ends."""
    costs: list = []
    token = _costs.set(_costs.get() + (costs,))
    try:
        yield costs
    finally:
        _costs.reset(token)


def fake_launch(name: str, flops: float, tensors) -> None:
    """Report one kernel's work on fake tensors: its ``flops`` and the
    bytes of ``tensors`` (its inputs read once and outputs written once)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    for costs in _costs.get():
        costs.append((name, float(flops), nbytes))
