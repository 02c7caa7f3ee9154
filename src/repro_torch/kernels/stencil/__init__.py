"""The Jacobi stencil kernels: ``stencil5_block`` (the runtime's fused
5-point block payload) and ``jacobi_sweep`` (one whole-grid sweep)."""
from .ops import (
    jacobi_sweep,
    jacobi_sweep_plain,
    launch_shapes,
    launches,
    load,
    reset_launches,
    stencil5_block,
    stencil5_block_plain,
)

__all__ = [
    "stencil5_block",
    "stencil5_block_plain",
    "jacobi_sweep",
    "jacobi_sweep_plain",
    "launches",
    "launch_shapes",
    "reset_launches",
    "load",
]
