"""The multi-tenant server: one shared Runtime, many request cones.

Execution model:

* **Recording is single-threaded.**  Every :meth:`Session.request`
  records its graph region under the server's record lock, with the
  shared runtime bound as the calling thread's current runtime for the
  duration — user code inside the request function uses the normal
  ``repro_torch.array`` / NumPy surface unchanged.
* **Draining is concurrent.**  The request's outputs are submitted as
  one non-blocking dependency-cone flush
  (``Runtime.flush(wait=False, targets=...)``); the record lock is
  released immediately, and the cone drains on the shared work-stealing
  worker pool alongside every other tenant's in-flight cones.  The
  engine joins only *conflicting* cones
  (:func:`repro_torch.core.graph.cones_conflict`), so disjoint tenants never
  serialize — and any interleaving of non-conflicting cones is
  bit-identical to a barrier flush, which is what makes multi-tenancy
  safe at all.
* **Admission is bounded.**  The :class:`AdmissionController` caps
  in-flight cones and queue depth per :class:`repro_torch.api.config.ServeConfig`;
  overload surfaces as :class:`AdmissionError`, never as unbounded
  latency.

Per-tenant accounting: each drained cone's measured
:class:`~repro_torch.exec.stats.WaitStats` is folded into that tenant's
:class:`TenantStats` (so wait-fraction is attributable per tenant), and
end-to-end request latency — admission queue included — feeds a
mergeable :class:`LatencyHistogram` for p50/p95/p99.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.exec.stats import WaitStats

from .admission import AdmissionController, AdmissionError
from .histogram import LatencyHistogram

__all__ = ["Server", "Session", "Request", "TenantStats"]


class TenantStats:
    """Accumulated per-tenant accounting: ``wait`` (a merged
    :class:`~repro_torch.exec.stats.WaitStats` over the tenant's drained
    cones), ``latency`` (end-to-end request histogram), and the request
    counters.  Metric properties (``wait_fraction``, ``makespan``, …)
    delegate to ``wait`` so :func:`repro_torch.api.reporting.format_stats`
    renders a tenant like any measured stats row."""

    def __init__(self, name: str):
        self.name = name
        self.wait = WaitStats(mode="async", nworkers=0)
        self.latency = LatencyHistogram()
        self.n_requests = 0  # admitted (submitted) requests
        self.n_rejected = 0  # shed by admission control
        self.n_failed = 0  # admitted but failed (record or drain error)

    def __getattr__(self, attr):
        if attr.startswith("_") or attr == "wait":
            raise AttributeError(attr)
        return getattr(self.wait, attr)

    def __repr__(self):
        return (
            f"TenantStats({self.name!r}, n={self.n_requests}, "
            f"rejected={self.n_rejected}, failed={self.n_failed}, "
            f"wait={self.wait_fraction * 100:.1f}%, "
            f"p99={self.latency.p99 * 1e3:.2f}ms)"
        )


def _coerce_outputs(outs):
    """Normalize a request function's return value to a list of
    DistArrays (materializing lazy Exprs — still under the record
    lock/runtime binding, so their recording lands in this cone)."""
    from repro_torch.core.darray import DistArray, Expr

    seq = outs if isinstance(outs, (tuple, list)) else (outs,)
    arrays = []
    for o in seq:
        if isinstance(o, Expr):
            o = o.materialize()
        if not isinstance(o, DistArray):
            raise TypeError(
                f"request function must return DistArrays (or lazy "
                f"expressions), got {type(o).__name__}"
            )
        arrays.append(o)
    if not arrays:
        raise TypeError("request function returned no arrays")
    return arrays


class Request:
    """Handle on one in-flight request: the output arrays plus the
    :class:`~repro_torch.core.engine.FlushTicket` of their cone drain."""

    __slots__ = ("_session", "_arrays", "_ticket", "_t0", "_single")

    def __init__(self, session, arrays, ticket, t0, single):
        self._session = session
        self._arrays = arrays
        self._ticket = ticket
        self._t0 = t0
        self._single = single

    @property
    def session(self) -> "Session":
        return self._session

    def done(self) -> bool:
        return self._ticket.done()

    def wait(self, timeout: Optional[float] = None) -> "Request":
        """Join this request's cone drain without gathering (re-raises
        the drain's failure, if any)."""
        self._ticket.wait(timeout)
        return self

    def result(self, timeout: Optional[float] = None):
        """Join the drain and gather the output host ndarray(s).

        The join happens lock-free (cones drain concurrently); only the
        gather itself takes the server's record lock — by then the cone
        has landed in block storage, so the critical section is a copy,
        not a drain."""
        self._ticket.wait(timeout)
        with self._session._server._record_lock:
            outs = tuple(np.asarray(a) for a in self._arrays)
        return outs[0] if self._single else outs

    # executor-thread callback registered by Session.request: resolves
    # the request's accounting exactly when its drain does, keeping the
    # admission window equal to the true number of in-flight cones even
    # when no client thread ever calls result()
    def _on_drained(self, ticket) -> None:
        session = self._session
        session._server._admission.release()
        dt = time.monotonic() - self._t0
        stats = None
        failed = False
        try:
            # resolves the ticket's bookkeeping (stats fold into the
            # runtime, removal from the outstanding list) on this thread;
            # the future is already done, so this never blocks
            stats = ticket.wait()
        except BaseException:
            failed = True  # re-raised to callers of result()/wait()
        with session._lock:
            t = session.stats
            t.latency.record(dt)
            if failed:
                t.n_failed += 1
            elif isinstance(stats, WaitStats):
                t.wait.merge(stats)

    def __repr__(self):
        state = "ready" if self.done() else "pending"
        return (
            f"Request(tenant={self._session.name!r}, "
            f"n_outputs={len(self._arrays)}, {state})"
        )


class Session:
    """One tenant's handle on the server.  ``request(fn, *args)``
    records ``fn``'s graph region and submits it as a dependency cone;
    per-tenant accounting accumulates in :attr:`stats`."""

    def __init__(self, server: "Server", name: str):
        self._server = server
        self.name = name
        self._lock = threading.Lock()  # guards stats merges
        self.stats = TenantStats(name)

    def request(self, fn, *args, **kwargs) -> Request:
        """Admit, record, and submit one request.

        ``fn(*args, **kwargs)`` runs under the server's record lock with
        the shared runtime active on the calling thread; it must build
        and return the request's output DistArray(s) using the normal
        array surface, without reading results back (readback belongs in
        :meth:`Request.result`, outside the lock).  Raises
        :class:`AdmissionError` when shed by admission control.

        The record lock covers only recording plus cone *extraction*
        (:meth:`~repro_torch.core.engine.Runtime.extract_cone`); planning,
        verification, and executor submission
        (:meth:`~repro_torch.core.engine.Runtime.submit_cone`) run after the
        lock is released, concurrently across client threads — the lock
        hold time (tracked in :attr:`Server.lock_hold`) is recording
        cost only, not planning cost."""
        from repro_torch.core import engine as _engine

        server = self._server
        t0 = time.monotonic()
        try:
            server._admission.admit()
        except AdmissionError:
            with self._lock:
                self.stats.n_rejected += 1
            raise
        try:
            with server._record_lock:
                t_lock = time.perf_counter()
                prev = getattr(_engine._tls, "runtime", None)
                _engine._tls.runtime = server.runtime
                try:
                    outs = fn(*args, **kwargs)
                    arrays = _coerce_outputs(outs)
                    handle = server.runtime.extract_cone(list(arrays))
                finally:
                    _engine._tls.runtime = prev
                    held = time.perf_counter() - t_lock
            server._note_lock_hold(held)
            # off the lock: plan + verify + submit on this client thread
            # (a failure here has already failed the handle's ticket)
            t_plan = time.perf_counter()
            ticket = server.runtime.submit_cone(handle)
            server._note_plan_time(time.perf_counter() - t_plan)
        except BaseException:
            server._admission.release()
            with self._lock:
                self.stats.n_failed += 1
            raise
        with self._lock:
            self.stats.n_requests += 1
        req = Request(
            self, arrays, ticket, t0, single=not isinstance(outs, (tuple, list))
        )
        ticket.add_done_callback(req._on_drained)
        return req

    def __repr__(self):
        return f"Session({self.name!r})"


class Server:
    """One shared runtime serving many tenants.

    Construction mirrors :func:`repro_torch.runtime`: pass config objects or
    keyword overrides (``RuntimeConfig`` / ``ExecutionPolicy`` /
    ``ServeConfig`` fields are routed by name).  The policy must use the
    measured async flush backend with demand-driven sync — concurrent
    cone drains are an executor-level mechanism; the simulator and the
    barrier discipline both serialize everything by design."""

    def __init__(self, config=None, policy=None, serve=None, **overrides):
        from repro_torch.api.config import (
            ExecutionPolicy,
            RuntimeConfig,
            ServeConfig,
            _CONFIG_FIELDS,
            _POLICY_FIELDS,
        )
        from repro_torch.core.engine import Runtime

        serve_fields = {f.name for f in dataclasses.fields(ServeConfig)}
        srv_kw = {k: v for k, v in overrides.items() if k in serve_fields}
        cfg_kw = {k: v for k, v in overrides.items() if k in _CONFIG_FIELDS}
        pol_kw = {k: v for k, v in overrides.items() if k in _POLICY_FIELDS}
        unknown = set(overrides) - serve_fields - _CONFIG_FIELDS - _POLICY_FIELDS
        if unknown:
            raise TypeError(
                f"unknown server option(s) {sorted(unknown)} — valid fields: "
                f"ServeConfig {sorted(serve_fields)}, RuntimeConfig "
                f"{sorted(_CONFIG_FIELDS)}, ExecutionPolicy "
                f"{sorted(_POLICY_FIELDS)}"
            )
        config = (config or RuntimeConfig()).replace(**cfg_kw)
        policy = (policy or ExecutionPolicy(flush="async")).replace(**pol_kw)
        if policy.flush != "async":
            raise ValueError(
                "Server requires ExecutionPolicy(flush='async'): concurrent "
                "cone drains need the measured executor; the simulator "
                "drains synchronously"
            )
        if policy.resolved_sync != "demand":
            raise ValueError(
                "Server requires demand-driven sync (sync='demand' or "
                "'auto'): barrier sync joins every tenant's work on each "
                "readback, serializing the server"
            )
        self.config = config
        self.policy = policy
        self.serve_config = (serve or ServeConfig()).replace(**srv_kw)
        self.runtime = Runtime.from_config(config, policy)
        self._admission = AdmissionController(
            self.serve_config.max_inflight,
            self.serve_config.max_queue,
            self.serve_config.admission_timeout,
        )
        # RLock: Request.result's gather may trigger a (cheap, empty)
        # cone flush that is itself re-entrant from the recording side
        self._record_lock = threading.RLock()
        # record-lock hold time per request (recording + extraction only
        # — planning runs off the lock): the record/plan split's success
        # metric
        self.lock_hold = LatencyHistogram()
        # ...and the off-lock plan+verify+submit time per request: the
        # lock-hold + plan-time pair is what the record lock *would*
        # have held in an on-lock design
        self.plan_time = LatencyHistogram()
        self._lock_hold_lock = threading.Lock()
        self._sessions: dict = {}
        self._sessions_lock = threading.Lock()
        self._closed = False

    def _note_lock_hold(self, seconds: float) -> None:
        from repro_torch.obs import collector as _obs

        with self._lock_hold_lock:
            self.lock_hold.record(seconds)
        col = _obs.CURRENT
        if col is not None:
            col.lock_held("record", seconds)

    def _note_plan_time(self, seconds: float) -> None:
        with self._lock_hold_lock:
            self.plan_time.record(seconds)

    @property
    def admission(self) -> AdmissionController:
        return self._admission

    def session(self, name: str) -> Session:
        """The tenant's session, created on first use."""
        with self._sessions_lock:
            if self._closed:
                raise AdmissionError("server is closed", "closed")
            s = self._sessions.get(name)
            if s is None:
                s = self._sessions[name] = Session(self, name)
            return s

    def stats(self) -> dict:
        """``{tenant name: TenantStats}``, sorted by name."""
        with self._sessions_lock:
            items = sorted(self._sessions.items())
        return {name: s.stats for name, s in items}

    def format_stats(self, per_worker: bool = False) -> str:
        """Render every tenant as a row of the unified stats table
        (makespan / wait% / volume, plus the latency-quantile lines)."""
        from repro_torch.api.reporting import format_stats

        return format_stats(
            list(self.stats().items()), per_worker=per_worker
        )

    def close(self) -> None:
        """Shut down: reject queued and future admissions, join every
        outstanding drain (in submission order), release the worker
        pool.  The first drain failure no client observed is re-raised
        after resources are released.  Double-close is a no-op."""
        if self._closed:
            return
        self._closed = True
        self._admission.close()
        with self._record_lock:
            self.runtime.close()

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            try:
                self.close()
            except Exception:
                pass  # the body's exception wins; resources are released
        return False

    def __repr__(self):
        return (
            f"Server(nprocs={self.config.nprocs}, "
            f"tenants={len(self._sessions)}, "
            f"inflight={self._admission.inflight}/"
            f"{self.serve_config.max_inflight})"
        )
