"""Admission control for the serving runtime.

Two bounds, both from :class:`~repro_torch.api.config.ServeConfig`:

* ``max_inflight`` — request cones draining concurrently on the shared
  worker pool.  Beyond it, arrivals queue.
* ``max_queue`` — queued arrivals.  Beyond it, the request is shed
  *immediately* with :class:`AdmissionError` (reason ``"queue-full"``)
  rather than building unbounded latency: under overload, fast explicit
  rejection is the only signal a client can act on (back off, retry,
  route elsewhere).  An optional ``admission_timeout`` also rejects
  queued requests that cannot get a slot in time (reason ``"timeout"``).

The controller is a plain counting semaphore with a bounded waiter
queue — no fairness guarantee beyond the condition variable's wakeup
order, which is FIFO-ish under CPython.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["AdmissionController", "AdmissionError"]


class AdmissionError(RuntimeError):
    """Request shed by admission control.

    ``reason`` is ``"queue-full"`` (arrived with the admission queue at
    ``max_queue``), ``"timeout"`` (queued longer than
    ``admission_timeout``), or ``"closed"`` (server shutting down).
    """

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


class AdmissionController:
    """Bounded-concurrency gate: ``admit()`` blocks until an in-flight
    slot frees (or sheds the request), ``release()`` frees a slot."""

    def __init__(
        self,
        max_inflight: int = 8,
        max_queue: int = 64,
        admission_timeout: Optional[float] = None,
    ):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.max_inflight = max_inflight
        self.max_queue = max_queue
        self.admission_timeout = admission_timeout
        self._cv = threading.Condition()
        self._inflight = 0
        self._queued = 0
        self._closed = False
        # observability counters (read under no lock: monotonic ints)
        self.n_admitted = 0
        self.n_rejected = 0
        self.n_over_released = 0
        self.peak_inflight = 0
        self.peak_queued = 0

    # -- introspection ----------------------------------------------------
    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def queued(self) -> int:
        return self._queued

    # -- the gate ---------------------------------------------------------
    def admit(self) -> None:
        """Take an in-flight slot, queuing if none is free.  Raises
        :class:`AdmissionError` instead of queuing past ``max_queue``,
        waiting past ``admission_timeout``, or after :meth:`close`."""
        timeout = self.admission_timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            if self._closed:
                self.n_rejected += 1
                raise AdmissionError("server is closed", "closed")
            if self._inflight >= self.max_inflight:
                if self._queued >= self.max_queue:
                    self.n_rejected += 1
                    raise AdmissionError(
                        f"admission queue full ({self._queued} waiting, "
                        f"{self._inflight} in flight) — shed, retry with "
                        f"backoff",
                        "queue-full",
                    )
                self._queued += 1
                self.peak_queued = max(self.peak_queued, self._queued)
                try:
                    while self._inflight >= self.max_inflight:
                        if self._closed:
                            self.n_rejected += 1
                            # a release() notify this waiter consumed must
                            # not die with it — pass it on or another
                            # queued waiter strands until its own timeout
                            self._cv.notify()
                            raise AdmissionError("server is closed", "closed")
                        if deadline is None:
                            self._cv.wait()
                        else:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0 or not self._cv.wait(remaining):
                                if self._inflight < self.max_inflight:
                                    break  # slot freed at the wire: take it
                                self.n_rejected += 1
                                self._cv.notify()
                                raise AdmissionError(
                                    f"no in-flight slot within {timeout} s",
                                    "timeout",
                                )
                finally:
                    self._queued -= 1
            self._inflight += 1
            self.n_admitted += 1
            self.peak_inflight = max(self.peak_inflight, self._inflight)

    def release(self) -> None:
        """Free one in-flight slot (called when the request's drain
        resolves, success or failure).  Over-releases are counted and
        clamped rather than raised — this runs on executor callback
        threads, where an exception would poison an unrelated drain."""
        with self._cv:
            if self._inflight <= 0:
                self.n_over_released += 1
                return
            self._inflight -= 1
            self._cv.notify()

    def close(self) -> None:
        """Reject all queued and future admissions (server shutdown)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
