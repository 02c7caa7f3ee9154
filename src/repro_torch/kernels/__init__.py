"""Hand-written CUDA kernels for Hopper (``sm_90a``), one sub-package per
kernel family, each with its plain PyTorch version beside it.

Kernels are built from their ``csrc/`` sources at first use, all into one
library (:mod:`repro_torch.kernels.build`); importing this package
builds nothing, so it imports on machines without ``nvcc`` or a GPU.

No kernel has a backward: the JAX package trains through the jnp twins
of its Pallas kernels, and the port trains through its torch twins
(``cfg.use_flash=False``).  A wrapper refuses an input that requires
grad (:func:`refuse_grad`) rather than fall back to its twin.
"""
import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would need a gradient through kernel ``name``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel has no backward; train "
            f"with cfg.use_flash=False (the torch twins), as the JAX package trains "
            f"through its jnp twins"
        )
