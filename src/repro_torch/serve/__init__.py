"""Multi-tenant serving runtime on the demand-driven executor.

The paper's thesis — a runtime that tracks data dependencies can hide
communication latency without user effort — extends naturally to
serving: with dependency-cone flush, *each client request is exactly a
cone*, so one shared :class:`~repro_torch.core.engine.Runtime` can drain many
tenants' requests concurrently on its work-stealing worker pool, while
the dependency system keeps every tenant's results bit-identical to a
serialized execution.

* :class:`Server` — owns one shared Runtime, a record lock (recording
  is single-threaded; draining is not), and an
  :class:`AdmissionController` implementing the configured
  :class:`~repro_torch.api.config.ServeConfig` policy (max in-flight cones,
  queue-depth shedding with :class:`AdmissionError`).
* :class:`Session` — one per tenant: records the tenant's graph region
  under the server's record lock, submits each request as a
  ``flush(wait=False, targets=...)`` dependency cone, and accumulates
  per-tenant :class:`TenantStats` (a merged
  :class:`~repro_torch.exec.stats.WaitStats` plus a request
  :class:`LatencyHistogram` with p50/p95/p99).
* :class:`Request` — the in-flight handle; ``result()`` joins the cone
  and gathers the output.

See ``docs/serving.md`` for the lifecycle and the steal-threshold
heuristic (arXiv 1805.01768) that makes concurrent cones profitable.
"""
from .admission import AdmissionController, AdmissionError
from .histogram import LatencyHistogram
from .server import Request, Server, Session, TenantStats

__all__ = [
    "Server",
    "Session",
    "Request",
    "TenantStats",
    "AdmissionController",
    "AdmissionError",
    "LatencyHistogram",
]
