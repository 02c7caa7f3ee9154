"""repro_torch.exec — asynchronous multi-worker execution backend
(wall-clock latency hiding, not simulated).

The core runtime reproduces the paper's claim on a discrete-event
simulator; this subsystem executes the *same* recorded dependency graphs
with genuine concurrency so the waiting-time metric is measured:

* :class:`AsyncExecutor` — a persistent pool of per-process worker
  threads with comm-first ready queues, sweep-based completion (batched
  per-worker handoffs under the ``"batch"`` plan pass), structural
  deadlock detection.  ``submit(deps)`` starts a drain and returns a
  :class:`Future` resolving to that drain's :class:`WaitStats` — the
  non-blocking primitive behind ``Runtime.flush(wait=False)`` and the
  demand-driven readback surface.
* :mod:`~repro_torch.exec.channels` — non-blocking transfer channel with
  a progress engine (scratch buffers delivered while compute runs) vs.
  the synchronous blocking channel baseline.
* :class:`TorchBackend` — the compute backend: payloads run as torch
  code on the blocks' device, fused stencil maps on the hand-written
  ``stencil5_block`` kernel from ``repro_torch.kernels``.
* :class:`WaitStats` — measured per-worker wait-for-communication
  fractions, printable next to the simulated ``TimelineResult``.

Select it per runtime: ``Runtime(..., flush_backend="async")``.
"""
from .backend import (
    AsyncExecutor,
    ComputeBackend,
    TorchBackend,
    make_backend,
    run_rendezvous_bsp_async,
)
from .channels import AsyncChannel, BlockingChannel, RendezvousMailbox, make_channel
from .futures import Future
from .stats import WaitStats, WorkerStats
from .workers import Worker

__all__ = [
    "AsyncExecutor",
    "ComputeBackend",
    "TorchBackend",
    "make_backend",
    "run_rendezvous_bsp_async",
    "AsyncChannel",
    "BlockingChannel",
    "RendezvousMailbox",
    "make_channel",
    "Future",
    "WaitStats",
    "WorkerStats",
    "Worker",
]
