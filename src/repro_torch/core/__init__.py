"""repro_torch.core — the paper's runtime latency-hiding model.

Public surface:

* :class:`Runtime` — lazy-evaluation engine + comm-first flush scheduler.
* :mod:`repro_torch.core.darray` — the DistNumPy-style array API (``array(...,
  dist=True)``, views, ufuncs, reductions, matmul).
* :class:`DependencySystem` — the paper's per-base-block dependency-list
  heuristic (§5.7.2); :class:`FullDAG` — the O(n²) baseline it replaces.
* :mod:`repro_torch.core.plan` — the plan stage of the record → plan →
  execute flush pipeline: registered graph passes (transfer coalescing,
  cross-kind fusion, batched dispatch) rewrite the recorded graph
  before scheduling.
* :func:`run_schedule` — the flush algorithm (§5.7), latency-hiding and
  blocking modes; timeline accounting on an α–β cluster model.
"""
from .blocks import Fragment, Layout, OperandSpec, ViewSpec, fragment_iteration_space
from .darray import DistArray
from .engine import ArrayBase, Runtime, current_runtime
from .graph import COMM, COMPUTE, AccessNode, DependencySystem, FullDAG, OperationNode
from .plan import DEFAULT_ASYNC_PIPELINE, PlanStats, plan, resolve_pipeline
from .scheduler import DeadlockError, run_rendezvous_bsp, run_schedule
from .timeline import GIGE_2012, H100_NVLINK, TPU_V5E_ICI, ClusterSpec, TimelineResult

__all__ = [
    "Runtime",
    "DistArray",
    "current_runtime",
    "ArrayBase",
    "Layout",
    "ViewSpec",
    "Fragment",
    "OperandSpec",
    "fragment_iteration_space",
    "DependencySystem",
    "FullDAG",
    "OperationNode",
    "AccessNode",
    "COMM",
    "COMPUTE",
    "plan",
    "PlanStats",
    "resolve_pipeline",
    "DEFAULT_ASYNC_PIPELINE",
    "run_schedule",
    "run_rendezvous_bsp",
    "DeadlockError",
    "ClusterSpec",
    "TimelineResult",
    "GIGE_2012",
    "TPU_V5E_ICI",
    "H100_NVLINK",
]
