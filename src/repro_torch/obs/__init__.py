"""repro_torch.obs — runtime tracing.

:class:`TraceCollector` (:mod:`repro_torch.obs.collector`) is a
lock-free ring buffer of structured lifecycle events (op recorded /
planned / enqueued / executed, message posted / progressed / delivered,
worker wait spans tagged with *why*), installed globally via
:func:`trace` or ``ExecutionPolicy(trace=True)``.  Disabled tracing is
a true no-op.  The Chrome-trace export and wait attribution are not
ported yet (ROADMAP): a trace export path raises ``NotImplementedError``.
"""
from .collector import (
    CURRENT,
    DEFAULT_CAPACITY,
    TraceCollector,
    activate,
    current_tracer,
    deactivate,
    trace,
)

__all__ = [
    "TraceCollector",
    "trace",
    "activate",
    "deactivate",
    "current_tracer",
    "DEFAULT_CAPACITY",
]
