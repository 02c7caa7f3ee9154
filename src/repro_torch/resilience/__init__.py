"""repro_torch.resilience — fault tolerance, elasticity, straggler
mitigation, gradient compression for the cross-pod axis."""
from .compression import int8_compress_transform, topk_ef_transform
from .fault_tolerance import (
    ClusterMonitor,
    ElasticPlan,
    HostState,
    StragglerTracker,
    TrainSupervisor,
)

__all__ = [
    "ClusterMonitor",
    "HostState",
    "ElasticPlan",
    "StragglerTracker",
    "TrainSupervisor",
    "int8_compress_transform",
    "topk_ef_transform",
]
