"""repro_torch.obs — runtime tracing, Perfetto export, and wait attribution.

The observability layer of the record → plan → execute → demand
pipeline.  Three pieces:

* :class:`TraceCollector` (:mod:`repro_torch.obs.collector`) — a lock-free
  ring buffer of structured lifecycle events (op recorded / planned /
  enqueued / executed, message posted / progressed / delivered, worker
  wait spans tagged with *why*), installed globally via
  :func:`repro_torch.trace`, ``ExecutionPolicy(trace=True)`` or
  ``REPRO_TRACE=1``.  Disabled tracing is a true no-op.
* :func:`export_trace` (:mod:`repro_torch.obs.export`) — Chrome-trace /
  Perfetto JSON: one track per worker and per channel, flow arrows from
  each message's delivery to the compute op it unblocked, counter
  tracks for queue depths and in-flight messages.
* :func:`attribution` (:mod:`repro_torch.obs.attribution`) — charges every
  wait span back to the op/message that ended it and reports the top-K
  wait sources, turning the paper's aggregate wait% into named causes.

Quick use::

    import repro_torch

    with repro_torch.trace("run_trace.json") as tr:
        with repro_torch.runtime(flush="async", nprocs=8, device="cpu"):
            ... numpy program ...
    print(repro_torch.attribution(tr).format(k=5))
"""
from .attribution import AttributionReport, WaitSpan, attribution
from .collector import (
    CURRENT,
    DEFAULT_CAPACITY,
    TraceCollector,
    activate,
    current_tracer,
    deactivate,
    trace,
)
from .export import export_trace, validate_trace

__all__ = [
    "TraceCollector",
    "trace",
    "activate",
    "deactivate",
    "current_tracer",
    "DEFAULT_CAPACITY",
    "export_trace",
    "validate_trace",
    "attribution",
    "AttributionReport",
    "WaitSpan",
]
