"""repro_torch.roofline — three-term roofline of a step on one H100, counted
as the step runs on the dry-run's fake tensors."""
from .analysis import (
    HW,
    CollectiveStats,
    analyze_step,
    collective_bytes,
    model_flops,
    roofline_terms,
)

__all__ = [
    "HW",
    "CollectiveStats",
    "analyze_step",
    "collective_bytes",
    "model_flops",
    "roofline_terms",
]
