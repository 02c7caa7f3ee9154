"""Transfer channels: the communication substrate of the async executor.

Two interchangeable channel disciplines, mirroring the paper's two
measurement setups on the wall clock:

* :class:`AsyncChannel` — non-blocking.  ``post`` hands the transfer to a
  *progress engine* (dedicated threads playing the role of MPI's
  ``MPI_Testsome`` progress loop / the NIC DMA engine) and returns a
  :class:`~repro_torch.exec.futures.Future` immediately, so the posting worker
  goes straight back to ready computation.  The scratch buffer is
  delivered — and the consumer refcounts decremented — from the progress
  thread via the future's done-callback.
* :class:`BlockingChannel` — synchronous.  ``post`` performs the copy (and
  the simulated wire latency, if any) inline on the calling worker
  thread; the elapsed time is accounted as communication *waiting* by the
  worker, reproducing the paper's blocking baseline.

Both accept an optional ``latency`` (seconds per message): a real sleep
standing in for wire latency on a single machine, so overlap is
measurable even when the memcpy itself is fast.  The async engine sleeps
on its own threads (latency hidden); the blocking channel sleeps on the
worker (latency exposed).

:class:`RendezvousMailbox` implements two-sided rendezvous matching for
the BSP runner (`repro_torch.exec.backend.run_rendezvous_bsp_async`) — the
messaging discipline whose fig. 6 deadlock motivates the paper's
one-sided flush algorithm.  Its deadlock detection is deterministic: when
every live rank is parked on an unmatched send/recv, no progress is
possible and the mailbox trips.
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, Optional

from repro_torch.api.registry import get_channel, register_channel
from repro_torch.obs import collector as _obs

from .futures import Future

__all__ = ["AsyncChannel", "BlockingChannel", "RendezvousMailbox", "make_channel"]

# execute_fn: callable(op) that performs the actual data movement
TransferFn = Callable[[object], None]


class AsyncChannel:
    """Non-blocking channel backed by a deadline-heap progress engine.

    Wire latency is *pipelined*, exactly as in the α–β cluster model: the
    delivery deadline is stamped when the message is posted (``now +
    latency``), so a thousand in-flight messages overlap their latencies
    instead of serializing them.  Only the actual data movement (the
    memcpy into the scratch buffer — the NIC-occupancy analogue)
    serializes on the progress threads."""

    blocking = False
    trace_name = "async"

    def __init__(self, progress_threads: int = 2, latency: float = 0.0):
        self.latency = latency
        self._cv = threading.Condition()
        self._heap: list = []  # (due, seq, op, execute, fut)
        self._seq = 0
        self._stopped = False
        self._threads = [
            threading.Thread(
                target=self._progress_loop, name=f"progress-{i}", daemon=True
            )
            for i in range(max(1, progress_threads))
        ]
        self.n_posted = 0
        self.n_delivered = 0
        for t in self._threads:
            t.start()

    def post(self, op, execute: TransferFn) -> Future:
        """Initiate a transfer; returns immediately with its future."""
        fut = Future()
        due = time.monotonic() + self.latency
        col = _obs.CURRENT
        with self._cv:
            self.n_posted += 1
            heapq.heappush(self._heap, (due, self._seq, op, execute, fut))
            self._seq += 1
            if col is not None:
                col.msg_posted(op, self.trace_name)
                col.counter("msgs-inflight", self.n_posted - self.n_delivered)
            self._cv.notify()
        return fut

    def post_many(self, items) -> list[Future]:
        """Initiate a batch of transfers — ``items`` is a sequence of
        ``(op, execute)`` pairs — with a single lock acquisition and
        one progress-engine wakeup, the channel-side analogue of the
        batched worker handoff."""
        futs = []
        due = time.monotonic() + self.latency
        col = _obs.CURRENT
        with self._cv:
            for op, execute in items:
                fut = Future()
                self.n_posted += 1
                heapq.heappush(self._heap, (due, self._seq, op, execute, fut))
                self._seq += 1
                if col is not None:
                    col.msg_posted(op, self.trace_name)
                futs.append(fut)
            if col is not None and items:
                col.counter("msgs-inflight", self.n_posted - self.n_delivered)
            self._cv.notify_all()
        return futs

    def _progress_loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._stopped:
                        return
                    if self._heap:
                        due = self._heap[0][0]
                        now = time.monotonic()
                        if due <= now:
                            _, _, op, execute, fut = heapq.heappop(self._heap)
                            break
                        self._cv.wait(timeout=due - now)
                    else:
                        self._cv.wait()
            col = _obs.CURRENT
            if col is not None:
                col.msg_progressed(op.uid, self.trace_name)
            try:
                execute(op)
            except BaseException as exc:  # surface through the future
                fut.set_exception(exc)
                continue
            with self._cv:
                self.n_delivered += 1
                if col is not None:
                    col.msg_delivered(op.uid, self.trace_name)
                    col.counter("msgs-inflight", self.n_posted - self.n_delivered)
            fut.set_result(op)

    def close(self) -> None:
        """Stop the progress threads; double-close is a no-op."""
        with self._cv:
            if self._stopped:
                return
            self._stopped = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)


class BlockingChannel:
    """Synchronous channel: the transfer happens on the caller's thread."""

    blocking = True
    trace_name = "blocking"

    def __init__(self, latency: float = 0.0):
        self.latency = latency
        self._count_lock = threading.Lock()  # posts come from all workers
        self.n_posted = 0
        self.n_delivered = 0

    def post(self, op, execute: TransferFn) -> Future:
        fut = Future()
        col = _obs.CURRENT
        with self._count_lock:
            self.n_posted += 1
        if col is not None:
            col.msg_posted(op, self.trace_name)
            col.msg_progressed(op.uid, self.trace_name)
        try:
            if self.latency > 0.0:
                time.sleep(self.latency)
            execute(op)
        except BaseException as exc:
            fut.set_exception(exc)
            return fut
        with self._count_lock:
            self.n_delivered += 1
        if col is not None:
            col.msg_delivered(op.uid, self.trace_name)
        fut.set_result(op)
        return fut

    def post_many(self, items) -> list[Future]:
        """Synchronous batch post: transfers execute inline, in order."""
        return [self.post(op, execute) for op, execute in items]

    def close(self) -> None:
        pass


# Registry entries take the full keyword set; disciplines that don't use
# a knob (the blocking channel has no progress engine) ignore it, so one
# factory signature covers every transport — including the ROADMAP's
# future multi-host channels.
register_channel(
    "async",
    lambda *, latency=0.0, progress_threads=2: AsyncChannel(
        progress_threads=progress_threads, latency=latency
    ),
)
register_channel(
    "blocking",
    lambda *, latency=0.0, progress_threads=2: BlockingChannel(latency=latency),
)


def make_channel(name, *, latency: float = 0.0, progress_threads: int = 2):
    """Resolve a transfer channel through the plugin registry (an
    already-built — possibly shared — channel passes through)."""
    if not isinstance(name, str):
        return name
    return get_channel(name)(latency=latency, progress_threads=progress_threads)


# ---------------------------------------------------------------------------
# Two-sided rendezvous messaging (fig. 6 reproduction substrate)
# ---------------------------------------------------------------------------


class RendezvousDeadlock(Exception):
    """Internal signal: every live rank is parked on an unmatched message."""

    def __init__(self, stuck: list[dict]):
        self.stuck = stuck
        super().__init__(f"{len(stuck)} ranks parked with no matching partner")


class RendezvousMailbox:
    """Two-sided tag matching with rendezvous semantics and deterministic
    deadlock detection.

    A ``send(rank, peer, tag)`` completes only when ``peer`` posts the
    matching ``recv(peer, rank, tag)`` (and vice versa).  Each rank may be
    parked on at most one operation (BSP in-order execution).  When every
    live rank is parked and no pair matches, the mailbox raises
    :class:`RendezvousDeadlock` on *all* parked ranks — there is no
    timeout involved, the stall is detected structurally.
    """

    def __init__(self, nranks: int):
        self.nranks = nranks
        self._cv = threading.Condition()
        # rank -> {"kind", "peer", "tag", "step"} while parked
        self._parked: dict[int, dict] = {}
        self._matched: set[int] = set()
        self._done: set[int] = set()
        self._dead: Optional[list[dict]] = None

    def _match_of(self, rank: int) -> Optional[int]:
        mine = self._parked[rank]
        want = "recv" if mine["kind"] == "send" else "send"
        peer = mine["peer"]
        theirs = self._parked.get(peer)
        if (
            theirs is not None
            and peer not in self._matched
            and theirs["kind"] == want
            and theirs["peer"] == rank
            and theirs["tag"] == mine["tag"]
        ):
            return peer
        return None

    def _check_stall(self) -> None:
        # all live (not-done) ranks parked and unmatched -> global stall
        live = self.nranks - len(self._done)
        if live == 0 or len(self._parked) < live:
            return
        for r in self._parked:
            if r not in self._matched and self._match_of(r) is not None:
                return
        if any(r in self._matched for r in self._parked):
            return  # someone is about to leave; progress still possible
        self._dead = [dict(rank=r, **op) for r, op in sorted(self._parked.items())]
        self._cv.notify_all()

    def transact(self, rank: int, kind: str, peer: int, tag, step: int) -> None:
        """Post a send or recv and block until it rendezvouses."""
        with self._cv:
            if self._dead is not None:
                raise RendezvousDeadlock(self._dead)
            self._parked[rank] = dict(kind=kind, peer=peer, tag=tag, step=step)
            partner = self._match_of(rank)
            if partner is not None:
                # complete both sides of the rendezvous
                self._matched.add(rank)
                self._matched.add(partner)
                self._cv.notify_all()
            while rank not in self._matched:
                if self._dead is not None:
                    del self._parked[rank]
                    raise RendezvousDeadlock(self._dead)
                self._check_stall()
                self._cv.wait(timeout=0.05)
            del self._parked[rank]
            self._matched.discard(rank)
            self._cv.notify_all()

    def finish(self, rank: int) -> None:
        with self._cv:
            self._done.add(rank)
            self._check_stall()
            self._cv.notify_all()
