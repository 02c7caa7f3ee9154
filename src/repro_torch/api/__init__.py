"""repro_torch.api — the unified public front-end.

One import surface for the paper's promise (*sequential NumPy programs,
unmodified*) and the runtime knobs around it:

* **Evaluation** — demand-driven futures: :func:`evaluate` starts
  draining an array's dependency cone without blocking (returns
  :class:`ArrayFuture`), :func:`gather` blocks and returns the host
  ndarray, :func:`wait` / ``DistArray.block_until_ready()`` give
  JAX-style explicit sync.  ``ExecutionPolicy(sync="barrier")`` is the
  escape hatch back to the paper's whole-graph readback barrier.
* **Config objects** — :class:`RuntimeConfig` / :class:`ExecutionPolicy`
  frozen dataclasses and the :func:`runtime` context-manager helper
  replace the ``Runtime(...)`` kwarg soup.
* **Registries** — ``register_backend`` / ``register_channel`` /
  ``register_scheduler`` / ``register_pass`` plug new compute backends,
  transports, flush schedulers, and plan-stage graph passes in by name
  without touching factory code.
* **Arrays** — :class:`~repro_torch.core.darray.DistArray` creation routines;
  operations on the arrays themselves go through the NumPy namespace
  (``np.add``, ``np.sum``, ``np.matmul``, …) via the array-protocol
  dispatch implemented in ``repro_torch.core.darray``.
* **Reporting** — :func:`format_stats` renders simulated and measured
  run statistics as one table.

Typical program::

    import numpy as np
    import repro_torch

    with repro_torch.runtime(nprocs=16, block_size=64, flush="async") as rt:
        a = repro_torch.array(np.linspace(0.0, 1.0, 65536).reshape(256, 256))
        c = np.sqrt(a * a + 1.0) / 2.0          # recorded lazily
        result = np.asarray(np.sum(c, axis=0))  # readback flushes
        print(repro_torch.format_stats([("run", rt.stats())]))

The array/engine names are re-exported lazily (PEP 562): the core
modules register their plugins with :mod:`repro_torch.api.registry` at import
time, so the registry layer must stay importable from inside
``repro_torch.core`` without cycling back through the array layer.
"""
from .config import ExecutionPolicy, RuntimeConfig, ServeConfig, runtime
from .futures import ArrayFuture, evaluate, gather, wait
from .registry import (
    available_backends,
    available_channels,
    available_passes,
    available_rules,
    available_schedulers,
    get_backend,
    get_channel,
    get_pass,
    get_rule,
    get_scheduler,
    register_backend,
    register_channel,
    register_pass,
    register_rule,
    register_scheduler,
)
from .reporting import format_stats

# lazily re-exported from repro_torch.core (avoids import cycles: core modules
# import repro_torch.api.registry at module level)
_CORE_EXPORTS = {
    "DistArray": "repro_torch.core.darray",
    "array": "repro_torch.core.darray",
    "empty": "repro_torch.core.darray",
    "zeros": "repro_torch.core.darray",
    "ones": "repro_torch.core.darray",
    "full": "repro_torch.core.darray",
    "arange": "repro_torch.core.darray",
    "random": "repro_torch.core.darray",
    "matmul": "repro_torch.core.darray",
    "roll": "repro_torch.core.darray",
    "Runtime": "repro_torch.core.engine",
    "FlushTicket": "repro_torch.core.engine",
    "current_runtime": "repro_torch.core.engine",
    "ClusterSpec": "repro_torch.core.timeline",
    "GIGE_2012": "repro_torch.core.timeline",
    "TPU_V5E_ICI": "repro_torch.core.timeline",
    "H100_NVLINK": "repro_torch.core.timeline",
    # observability (repro_torch.obs): lifecycle tracing, Perfetto export,
    # wait attribution
    "trace": "repro_torch.obs",
    "TraceCollector": "repro_torch.obs",
    "export_trace": "repro_torch.obs",
    "validate_trace": "repro_torch.obs",
    "attribution": "repro_torch.obs",
    "AttributionReport": "repro_torch.obs",
    # static analysis (repro_torch.analysis): plan verifier, race oracle,
    # deadlock detection — ExecutionPolicy(verify=...) runs it per flush
    "check": "repro_torch.analysis",
    "Diagnostic": "repro_torch.analysis",
    "AnalysisReport": "repro_torch.analysis",
    "VerificationError": "repro_torch.analysis",
    "VerifyStats": "repro_torch.analysis",
    # multi-tenant serving runtime (repro_torch.serve): one shared Runtime,
    # concurrent per-request cone drains, admission control
    "Server": "repro_torch.serve",
    "Session": "repro_torch.serve",
    "Request": "repro_torch.serve",
    "TenantStats": "repro_torch.serve",
    "AdmissionError": "repro_torch.serve",
    "LatencyHistogram": "repro_torch.serve",
}

__all__ = [
    # config objects + entry point
    "runtime",
    "RuntimeConfig",
    "ExecutionPolicy",
    "ServeConfig",
    # demand-driven evaluation (futures surface)
    "ArrayFuture",
    "evaluate",
    "gather",
    "wait",
    # registries
    "register_backend",
    "get_backend",
    "available_backends",
    "register_channel",
    "get_channel",
    "available_channels",
    "register_scheduler",
    "get_scheduler",
    "available_schedulers",
    "register_pass",
    "get_pass",
    "available_passes",
    "register_rule",
    "get_rule",
    "available_rules",
    # reporting
    "format_stats",
    # lazy core re-exports
    *sorted(_CORE_EXPORTS),
]


def __getattr__(name):
    mod = _CORE_EXPORTS.get(name)
    if mod is not None:
        import importlib

        value = getattr(importlib.import_module(mod), name)
        globals()[name] = value  # cache for subsequent lookups
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
