"""Per-process worker threads with comm-first ready queues (paper §5.7,
executed on the wall clock instead of the event simulator).

Each simulated process rank gets one :class:`Worker` thread and one
private ready deque.  The scheduler invariants hold at the dispatch
granularity:

* invariant 1 — an operation is enqueued only when its refcount hits
  zero (the dependency system guarantees this);
* invariant 2 — a worker initiates every ready *communication*
  operation before touching ready computation (comm-first pop order; on
  the async channel, initiation is non-blocking so all ready transfers
  are in flight before the first compute payload runs).  Under batched
  dispatch this holds *per batch*: a transfer that becomes ready while
  a batch is executing is initiated at the next wakeup, not mid-batch —
  the latency cost of amortizing the handoff (adaptive batch sizing is
  the ROADMAP follow-up).  Async-channel transfers are unaffected:
  they are posted by the completion sweep and never queue on workers;
* invariant 3 — a worker only blocks (goes idle) when it has neither
  ready communication nor ready computation *and* there is nothing
  worth stealing from a loaded peer.

Dispatch granularity is pluggable (the ``"batch"`` plan pass): with
``batch=True`` a worker drains its *entire* queue per wakeup
(comm-first within the batch) and the executor completes the whole
batch through one dependency-system sweep, amortizing the lock+event
handoff that otherwise costs ~0.1 ms per operation; with
``batch=False`` it pops one operation per wakeup — the pre-plan
baseline, kept measurable for the dispatch-overhead benchmark.

Work stealing (arXiv 1805.01768 regime — steal latency vs. task
granularity): a worker whose own queue is empty asks the executor's
steal policy (``steal_fn``) for work before parking.  The victim's
queue is popped from the *tail* under the victim's own lock
(:meth:`Worker.steal_from`), preserving the victim's program-order
head; the stolen batch is re-sorted comm-first by the thief, so
invariant 2 holds per executed batch on both sides.  This is safe for
bit-identical results because two simultaneously-*ready* operations are
never conflicting (invariant 1): any interleaving of ready ops executes
the same payloads against disjoint data.

Workers report wall-clock accounting into a :class:`WorkerStats` each:
compute-busy, comm-blocked (synchronous channels), idle time, the
number of queue wakeups, and steal counters.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

from repro_torch.core.graph import COMM, OperationNode
from repro_torch.obs import collector as _obs

from .stats import WorkerStats

__all__ = ["Worker"]


class Worker(threading.Thread):
    """One simulated process: drains its own ready queue comm-first,
    one batch (or one op, ``batch=False``) per wakeup; steals from
    loaded peers before parking when the executor provides a policy."""

    def __init__(
        self,
        rank: int,
        execute_batch: Callable[[list[OperationNode], "Worker"], None],
        on_error: Callable[[BaseException], None],
        batch: bool = True,
        steal_fn: Optional[Callable[["Worker"], Optional[list]]] = None,
    ):
        super().__init__(name=f"exec-worker-{rank}", daemon=True)
        self.rank = rank
        self._execute_batch = execute_batch
        self._on_error = on_error
        self._batch = batch
        self._steal_fn = steal_fn
        self._cv = threading.Condition()
        self._queue: deque[OperationNode] = deque()
        self._stopped = False
        self._idle_floor = 0.0  # drain start; earlier parked time not idle
        # bumped under _cv by every wake source (push/wake/stop): a thief
        # re-checks it after a failed steal attempt so a wake that fired
        # *during* the attempt is never lost (no polling timeout needed)
        self._wake_seq = 0
        self.stats = WorkerStats()

    # -- producer side (executor dispatch) --------------------------------
    def push_batch(self, ops: Sequence[OperationNode]) -> None:
        """Enqueue a list of ready ops with a single lock+notify — one
        handoff regardless of the batch size."""
        col = _obs.CURRENT
        with self._cv:
            self._queue.extend(ops)
            self._wake_seq += 1
            if col is not None:
                depth = len(self._queue)
                col.enqueued_many([op.uid for op in ops], self.rank, depth)
                col.counter(f"w{self.rank}.qdepth", depth)
            self._cv.notify()

    def push(self, op: OperationNode) -> None:
        self.push_batch((op,))

    def set_batch(self, batch: bool) -> None:
        """Switch dispatch granularity between drains.  The persistent
        executor calls this at submit time (no drain in flight, queue
        empty), so the flag never changes under a live batch."""
        with self._cv:
            self._batch = batch

    def drain_started(self) -> None:
        """Mark the start of a new drain: time spent parked on an empty
        queue *before* this point (the main thread recording between
        drains) must not be accounted as dependency-wait idle time."""
        with self._cv:
            self._idle_floor = time.perf_counter()

    def wake(self) -> None:
        """Nudge a parked worker to re-run its steal policy (called by
        the executor after dispatching a batch heavy enough to steal
        from)."""
        with self._cv:
            self._wake_seq += 1
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._wake_seq += 1
            self._cv.notify()

    # -- victim side of stealing ------------------------------------------
    def qlen(self) -> int:
        """Racy queue-length read — a heuristic input for victim
        selection, never a correctness decision."""
        return len(self._queue)

    def steal_from(self, n: int) -> list[OperationNode]:
        """Pop up to ``n`` ops from the *tail* of this worker's queue
        (always leaving at least one — the victim was woken for it).
        Tail-stealing keeps the victim's head untouched: its comm-first
        program-order prefix is what it pops next.  Returns the stolen
        ops in their original queue order."""
        with self._cv:
            n = min(n, len(self._queue) - 1)
            if n <= 0:
                return []
            stolen = [self._queue.pop() for _ in range(n)]
        stolen.reverse()
        return stolen

    def discard(self, pred: Callable[[OperationNode], bool]) -> int:
        """Drop queued ops matching ``pred`` (a failed drain's leftovers
        must not execute against re-planned state); returns the count."""
        with self._cv:
            before = len(self._queue)
            self._queue = deque(op for op in self._queue if not pred(op))
            return before - len(self._queue)

    # -- consumer side ----------------------------------------------------
    def _pop_locked(self) -> list[OperationNode]:
        """Pop the next unit of work from the (non-empty) own queue —
        the whole queue (batched) or a single comm-first op (unbatched).
        Caller holds ``_cv``."""
        if not self._batch:
            for i, op in enumerate(self._queue):
                if op.kind == COMM:
                    del self._queue[i]
                    return [op]
            return [self._queue.popleft()]
        ops = list(self._queue)
        self._queue.clear()
        return ops

    def _pop_batch(self) -> Optional[list[OperationNode]]:
        """Pop the next unit of work: own queue first, then a steal
        attempt, then park.  Any ready transfer outranks every ready
        compute within the popped batch (invariant 2).  Blocks while
        there is nothing to do, accounting idle time; returns None on
        shutdown."""
        col = _obs.CURRENT
        idle_from = None
        stolen = False
        while True:
            with self._cv:
                if self._queue:
                    ops = self._pop_locked()
                    break
                if self._stopped:
                    return None
                if idle_from is None:
                    idle_from = time.perf_counter()
                    if col is not None:
                        col.wait_start(self.rank, "empty-queue")
                seq = self._wake_seq
            # own queue empty — run the steal policy OUTSIDE our lock
            # (it takes the victim's lock; holding both would order them)
            if self._steal_fn is not None:
                got = self._steal_fn(self)
                if got:
                    ops = got
                    stolen = True
                    break
            with self._cv:
                if not self._queue and not self._stopped and self._wake_seq == seq:
                    self._cv.wait()
        if idle_from is not None:
            self.stats.idle += time.perf_counter() - max(
                idle_from, self._idle_floor
            )
        self.stats.n_wakeups += 1
        if stolen:
            self.stats.n_steals += 1
            self.stats.n_stolen += len(ops)
            # bin the steal into each op's own drain too: overlapped
            # drains report drain.procs (per-op accounting), not the
            # worker-stats lifetime delta a solo drain reports, and the
            # rebalance must stay visible per tenant
            seen_drains = set()
            for op in ops:
                dstats = op._drain.procs[self.rank]
                dstats.n_stolen += 1
                if id(op._drain) not in seen_drains:
                    seen_drains.add(id(op._drain))
                    dstats.n_steals += 1
        if self._batch or stolen:
            ops.sort(key=lambda op: op.kind != COMM)  # comm-first, stable
        if col is not None:
            if idle_from is not None:
                col.wait_end(self.rank, "empty-queue", ops[0].uid)
            col.dequeued_many([op.uid for op in ops], self.rank)
            col.counter(f"w{self.rank}.batch", len(ops))
            if stolen:
                col.counter(f"w{self.rank}.stolen", len(ops))
        return ops

    def run(self) -> None:
        try:
            while True:
                ops = self._pop_batch()
                if ops is None:
                    return
                self._execute_batch(ops, self)
        except BaseException as exc:  # pragma: no cover - surfaced by executor
            self._on_error(exc)
