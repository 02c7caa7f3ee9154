"""The Jacobi stencil kernels: ``stencil5_group`` (the runtime's fused
5-point block payloads, a batch of fragments in one launch, written in
place), ``stencil5_block`` (one fragment into a new tensor) and
``jacobi_sweep`` (one whole-grid sweep)."""
from .ops import (
    GROUP_MAX_FRAGS,
    fragment_shapes,
    group_sizes,
    jacobi_sweep,
    jacobi_sweep_plain,
    launch_shapes,
    launches,
    load,
    prepare_group,
    reset_launches,
    stencil5_block,
    stencil5_block_plain,
    stencil5_group,
    stencil5_group_plain,
    staged_copies,
)

__all__ = [
    "stencil5_block",
    "stencil5_block_plain",
    "stencil5_group",
    "stencil5_group_plain",
    "prepare_group",
    "GROUP_MAX_FRAGS",
    "jacobi_sweep",
    "jacobi_sweep_plain",
    "launches",
    "launch_shapes",
    "fragment_shapes",
    "group_sizes",
    "staged_copies",
    "reset_launches",
    "load",
]
