"""Ring-buffer lifecycle-event collector — the tracing substrate.

One :class:`TraceCollector` holds a bounded ``deque`` of event tuples
``(ts, etype, uid, worker, extra)``; ``ts`` is seconds relative to the
collector's creation (``time.perf_counter``-based).  Appending to a
``maxlen`` deque is GIL-atomic, so workers, channel progress threads and
the recording main thread all emit without any lock — when the buffer
fills, the *oldest* events drop (``dropped`` reports how many).

The collector is installed into the module-global ``CURRENT`` slot
(:func:`activate` / :func:`deactivate`).  Every instrumentation site in
the runtime does::

    col = _obs.CURRENT
    if col is not None:
        col.some_event(...)

— a module-attribute load plus an ``is not None`` test, a few
nanoseconds.  With no collector active, tracing is a true no-op: no
allocation, no branch into this module, no behavioural difference.

Event taxonomy (see docs/observability.md for the full reference):

======================  =====================================================
etype                   meaning / extra payload
======================  =====================================================
``recorded``            op inserted into the dependency system
``rewritten``           plan pass built/replaced a node; extra =
                        ``(pass_name, (src_uid, ...))``
``dropped``             plan pass eliminated a node outright (dead-store
                        elimination); extra = pass name
``plan-pass``           one pass ran; extra = ``(name, n_ops_in, n_ops_out)``
``flush-begin``         Runtime.flush started; uid = flush id, extra =
                        ``(n_pending_total, n_cone, sync_mode, backend)``
``drain-begin/-end``    one executor drain segment; uid = flush id (tag),
                        begin extra = ``(n_pending, nworkers)``
``enqueued``            op pushed onto a worker ready queue; extra = qdepth
``dequeued``            op popped by its worker
``compute-start/-end``  backend execution of one compute payload
``msg-posted``          transfer handed to a channel; extra =
                        ``(chan, src_proc, dst_proc, nbytes)``
``msg-progressed``      progress engine picked the message up; extra = chan
``msg-delivered``       data movement done, consumers may decrement
``ready``               op's refcount hit zero; extra = uid of the op whose
                        completion caused it (wait attribution's causality)
``wait-start/-end``     worker (or ``"main"``) blocked; extra = reason, and
                        on end ``(reason, ender_uid)`` — the op/message
                        whose arrival ended the wait
``counter``             gauge sample; uid = counter name, extra = value
``plan-cache``          plan stage consulted the plan-shape cache; uid =
                        flush id, extra = ``(hit, n_ops)``
``lock-held``           a serving lock was held; uid = lock label (e.g.
                        ``"record"``), extra = held seconds
======================  =====================================================
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional

__all__ = [
    "TraceCollector",
    "CURRENT",
    "DEFAULT_CAPACITY",
    "activate",
    "deactivate",
    "current_tracer",
    "trace",
]

DEFAULT_CAPACITY = 1_000_000

#: The active collector, or None (tracing disabled).  Instrumentation
#: sites read this attribute directly; keep it a plain module global.
CURRENT: Optional["TraceCollector"] = None


class TraceCollector:
    """Bounded buffer of lifecycle events plus an op-metadata registry.

    ``ops`` maps uid -> ``(kind, label, nbytes)`` so per-op metadata is
    recorded once (at ``recorded``/``rewritten``/``msg-posted`` time)
    instead of repeated on every event.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self.t0 = time.perf_counter()
        self.events: deque = deque(maxlen=capacity)
        self.ops: dict = {}  # uid -> (kind, label, nbytes)
        # uid -> flush/drain tag: with concurrent drains, per-op events
        # interleave across flushes; this registry lets export/attribution
        # route every op back to the drain segment that owns it
        self.flush_of: dict = {}
        self.n_emitted = 0

    # -- introspection ----------------------------------------------------
    def __len__(self) -> int:
        return len(self.events)

    @property
    def dropped(self) -> int:
        """Events pushed out of the ring buffer (oldest first)."""
        return max(0, self.n_emitted - len(self.events))

    def now(self) -> float:
        return time.perf_counter() - self.t0

    # -- recording / planning --------------------------------------------
    def op_recorded(self, op) -> None:
        self.ops[op.uid] = (op.kind, op.label, op.nbytes)
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "recorded", op.uid, None, None)
        )

    def op_rewritten(self, pass_name: str, op, src_uids) -> None:
        self.ops[op.uid] = (op.kind, op.label, op.nbytes)
        self.n_emitted += 1
        self.events.append(
            (
                time.perf_counter() - self.t0,
                "rewritten",
                op.uid,
                None,
                (pass_name, tuple(src_uids)),
            )
        )

    def op_dropped(self, pass_name: str, op) -> None:
        """A plan pass eliminated ``op`` outright (dead-store
        elimination); extra = the pass name.  Together with
        ``rewritten`` this is the complete rewrite provenance the
        static plan verifier (repro_torch.analysis) consumes."""
        if op.uid not in self.ops:
            self.ops[op.uid] = (op.kind, op.label, op.nbytes)
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "dropped", op.uid, None, pass_name)
        )

    def plan_pass(self, name: str, n_in: int, n_out: int) -> None:
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "plan-pass", None, None, (name, n_in, n_out))
        )

    def plan_cache(self, fid, hit: bool, n_ops: int) -> None:
        """The plan stage consulted the plan-shape cache for flush
        ``fid``: ``hit`` says whether a cached recipe was replayed
        (skipping the pass pipeline and re-verification), ``n_ops`` is
        the cone's pre-plan operation count."""
        self.n_emitted += 1
        self.events.append(
            (
                time.perf_counter() - self.t0,
                "plan-cache",
                fid,
                "main",
                (bool(hit), n_ops),
            )
        )

    def lock_held(self, label: str, seconds: float) -> None:
        """A serving-layer lock (``label``, e.g. ``"record"``) was held
        for ``seconds`` — the record/plan split's success metric."""
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "lock-held", label, "main", seconds)
        )

    # -- flush / drain segments ------------------------------------------
    def flush_begin(self, fid, n_total: int, n_cone: int, sync: str, backend: str) -> None:
        self.n_emitted += 1
        self.events.append(
            (
                time.perf_counter() - self.t0,
                "flush-begin",
                fid,
                "main",
                (n_total, n_cone, sync, backend),
            )
        )

    def drain_begin(self, tag, n_pending: int, nworkers: int) -> None:
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "drain-begin", tag, None, (n_pending, nworkers))
        )

    def drain_end(self, tag) -> None:
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "drain-end", tag, None, None)
        )

    def drain_ops(self, tag, uids) -> None:
        """Register every op of a submitted drain under its flush/drain
        tag (no event emitted — pure registry, used to keep traces
        structurally valid when drains interleave)."""
        flush_of = self.flush_of
        for uid in uids:
            flush_of[uid] = tag

    # -- worker queues ----------------------------------------------------
    def enqueued(self, uid, worker, qdepth: int) -> None:
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "enqueued", uid, worker, qdepth)
        )

    def dequeued(self, uid, worker) -> None:
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "dequeued", uid, worker, None)
        )

    # batch variants for the per-op hot paths: one timestamp and one
    # method call per *batch* keeps traced dispatch overhead <5% on the
    # 10k-op chain (ops pushed/popped together share one instant anyway)
    def enqueued_many(self, uids, worker, qdepth: int) -> None:
        ts = time.perf_counter() - self.t0
        append = self.events.append
        for uid in uids:
            append((ts, "enqueued", uid, worker, qdepth))
        self.n_emitted += len(uids)

    def dequeued_many(self, uids, worker) -> None:
        ts = time.perf_counter() - self.t0
        append = self.events.append
        for uid in uids:
            append((ts, "dequeued", uid, worker, None))
        self.n_emitted += len(uids)

    def ready_many(self, pairs) -> None:
        """``pairs`` is a list of ``(uid, cause_uid)`` tuples."""
        ts = time.perf_counter() - self.t0
        append = self.events.append
        for uid, cause in pairs:
            append((ts, "ready", uid, None, cause))
        self.n_emitted += len(pairs)

    # extra = per-thread CPU clock sample: wall-clock slice bounds show
    # GIL/scheduler preemption in the timeline, while the CPU delta is
    # what WaitStats.compute_busy measures — attribution uses the delta
    # so its wait_fraction is the same construction as the measured one
    def compute_start(self, uid, worker) -> None:
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "compute-start", uid, worker,
             time.thread_time())
        )

    def compute_end(self, uid, worker) -> None:
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "compute-end", uid, worker,
             time.thread_time())
        )

    def compute_device(self, uid, worker, seconds: float) -> None:
        """Device seconds of one compute unit (a payload or a grouped
        launch) whose first op is ``uid``, emitted when its gated event
        pair resolves at the end of the drain (CUDA blocks only).
        Attribution charges these in place of the unit's CPU delta."""
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "compute-device", uid, worker,
             seconds)
        )

    # -- channel messages --------------------------------------------------
    def msg_posted(self, op, chan: str) -> None:
        uid = op.uid
        if uid not in self.ops:
            self.ops[uid] = (op.kind, op.label, op.nbytes)
        procs = op.procs
        src = procs[0] if procs else None
        dst = procs[-1] if procs else None
        self.n_emitted += 1
        self.events.append(
            (
                time.perf_counter() - self.t0,
                "msg-posted",
                uid,
                None,
                (chan, src, dst, op.nbytes),
            )
        )

    def msg_progressed(self, uid, chan: str) -> None:
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "msg-progressed", uid, None, chan)
        )

    def msg_delivered(self, uid, chan: str) -> None:
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "msg-delivered", uid, None, chan)
        )

    # -- causality / waits -------------------------------------------------
    def ready(self, uid, cause_uid) -> None:
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "ready", uid, None, cause_uid)
        )

    def wait_start(self, worker, reason: str) -> None:
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "wait-start", None, worker, reason)
        )

    def wait_end(self, worker, reason: str, ender_uid) -> None:
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "wait-end", None, worker, (reason, ender_uid))
        )

    # -- counters ----------------------------------------------------------
    def counter(self, name: str, value) -> None:
        self.n_emitted += 1
        self.events.append(
            (time.perf_counter() - self.t0, "counter", name, None, value)
        )


def activate(collector: TraceCollector) -> Optional[TraceCollector]:
    """Install ``collector`` as the active tracer; returns the previous
    one (pass it back to :func:`deactivate` to restore nesting)."""
    global CURRENT
    prev = CURRENT
    CURRENT = collector
    return prev


def deactivate(prev: Optional[TraceCollector] = None) -> None:
    """Restore ``prev`` (or disable tracing entirely)."""
    global CURRENT
    CURRENT = prev


def current_tracer() -> Optional[TraceCollector]:
    """The active collector, or None when tracing is disabled."""
    return CURRENT


class trace:
    """Context manager enabling tracing for a region of the program::

        with repro_torch.trace("run_trace.json") as tr:
            ... record / flush / gather ...
        # on exit: tracing restored, trace exported to the given path

    ``path=None`` skips the export — inspect the returned collector with
    :func:`repro_torch.obs.attribution` / :func:`repro_torch.obs.export_trace`
    yourself.  Runtimes entered while a ``trace()`` region is active
    adopt the ambient collector instead of creating their own, so one
    trace can span several runtimes (or one runtime several regions).
    """

    def __init__(self, path: Optional[str] = None, capacity: int = DEFAULT_CAPACITY):
        self.path = path
        self.collector = TraceCollector(capacity=capacity)
        self._prev: Optional[TraceCollector] = None

    def __enter__(self) -> TraceCollector:
        self._prev = activate(self.collector)
        return self.collector

    def __exit__(self, exc_type, exc, tb):
        deactivate(self._prev)
        if self.path is not None and exc_type is None:
            from .export import export_trace

            export_trace(self.collector, self.path)
        return False
