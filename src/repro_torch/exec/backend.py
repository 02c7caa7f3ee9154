"""Asynchronous flush executor and pluggable compute backends.

:class:`AsyncExecutor` drains a recorded
:class:`~repro_torch.core.graph.DependencySystem` with genuine concurrency —
the wall-clock counterpart of ``repro_torch.core.scheduler.run_schedule``:

* one :class:`~repro_torch.exec.workers.Worker` thread per simulated process,
  each with a private comm-first ready queue;
* transfers go through a :mod:`~repro_torch.exec.channels` discipline — the
  non-blocking :class:`AsyncChannel` progress engine delivers scratch
  buffers while compute runs, the :class:`BlockingChannel` reproduces the
  synchronous baseline on the worker's own clock;
* completion is sweep-based: a finished worker batch (or a channel
  future's done-callback) performs the refcount decrements
  (``deps.complete``) and dispatches newly-ready operations — the
  graph's ``on_ready`` hook delivers them straight to worker queues,
  no central scheduler loop.  Under the ``"batch"`` plan pass the
  sweep moves per-worker *lists* per lock round trip
  (``batch_dispatch=True``), amortizing the Python handoff overhead;
* the numerical result is bit-identical to the simulated executor's: the
  dependency system totally orders every pair of conflicting accesses, so
  any schedule that respects it interprets the payloads (shared
  ``repro_torch.core.engine.execute_payload``) into the same block contents.
  Every thread launches device work on the one current stream, so the
  device runs it in the order the dependency system released it;
* with blocks on a CUDA device, compute is timed on the device: a CUDA
  event pair around each payload (or grouped launch) on that stream,
  held behind a stream gate until the payload is queued, so that a pair
  counts the payload's kernels and not the host's dispatch; the pairs
  are resolved when the drain ends (:class:`_DeviceClock`), and the
  drain's makespan ends when the device has finished its work.

Deadlock is detected structurally, not by timeout: when nothing is in
flight and the dependency system still has pending operations, no future
can ever resolve — the executor raises
:class:`~repro_torch.core.scheduler.DeadlockError` listing the stuck
operation-nodes.  :func:`run_rendezvous_bsp_async` applies the same
treatment to the paper's fig. 6 schedule executed with real threads and
two-sided rendezvous messaging.
"""
from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.api.registry import get_backend, register_backend
from repro_torch.core.engine import MapPayload, execute_payload, resolve_ref
from repro_torch.core.graph import COMM, DependencySystem, OperationNode
from repro_torch.core.scheduler import DeadlockError, format_stuck_ops
from repro_torch.core.ufunc import loop_dtypes, operand_key, to_numpy_dtype
from repro_torch.kernels.stencil import prepare_group as prepare_stencil5_group
from repro_torch.kernels.stencil import stencil5_group
from repro_torch.obs import collector as _obs

from .channels import RendezvousDeadlock, RendezvousMailbox, make_channel
from .futures import Future
from .stats import WaitStats, WorkerStats
from .workers import Worker

__all__ = [
    "ComputeBackend",
    "TorchBackend",
    "make_backend",
    "AsyncExecutor",
    "run_rendezvous_bsp_async",
]


# ---------------------------------------------------------------------------
# Compute backends
# ---------------------------------------------------------------------------


class ComputeBackend:
    """Executes operation payloads against the runtime's block storage.

    A backend may also run several ops of one worker batch as one
    launch: :meth:`split_batch` picks them out as launch groups
    (:class:`LaunchGroup`) and :meth:`prepare_group` readies each.  The
    ops of one batch were ready together, so they never conflict and may
    run in any order."""

    name = "abstract"

    def __init__(self, storage: dict, scratch: dict):
        self.storage = storage
        self.scratch = scratch

    def execute(self, op: OperationNode) -> None:
        raise NotImplementedError

    def split_batch(self, ops: list) -> tuple[list, list]:
        """(launch groups, the ops left for :meth:`execute`, in order)."""
        return [], list(ops)

    def prepare_group(self, group: "LaunchGroup"):
        """The host's work for one group (checks, the kernel's table);
        returns the call that launches it, which the executor times on
        the device apart from this work."""
        raise NotImplementedError


@dataclass
class LaunchGroup:
    """Ops of one worker batch that run as one launch: ``items[i]`` is
    what the launch needs of ``ops[i]``, ``sizes[i]`` its element count
    (the share of the launch's time it is charged)."""

    ops: list
    items: list
    sizes: list
    weight: float

    def subset(self, keep: list) -> "LaunchGroup":
        return LaunchGroup([self.ops[i] for i in keep], [self.items[i] for i in keep],
                           [self.sizes[i] for i in keep], self.weight)


class TorchBackend(ComputeBackend):
    """Runs block payloads as torch code on the blocks' device.

    * Every payload kind goes through the torch
      :func:`~repro_torch.core.engine.execute_payload`: maps and fused
      expression trees (``UFunc.tree``, re-traced with the torch
      primitives through ``eval_tree``) in NumPy's loop dtypes,
      reductions, fills, combines, and matmuls through ``torch.matmul``.
    * Fused 5-point stencil maps ``w * ((((x0+x1)+x2)+x3)+x4)`` go to
      the hand-written stencil kernel (:mod:`repro_torch.kernels.stencil`)
      when NumPy would compute them in the blocks' own float32/float64
      dtype and store them in that dtype; the kernel accumulates in that
      dtype and in that order, so the result is bit-identical to the
      NumPy interpreter.  Those of one worker batch with one dtype and
      weight go to ``stencil5_group`` together (:meth:`split_batch`): one
      launch, each result written straight into its output block.
    """

    name = "torch"

    _STENCIL_DTYPES = (np.dtype(np.float32), np.dtype(np.float64))
    # (block dtype, weight's operand key) -> whether NumPy's multiply loop
    # stays in the block dtype (a pure function of the key)
    _stencil_loop_ok: dict = {}

    @staticmethod
    def _stencil5_weight(tree) -> Optional[object]:
        """Match ``w * ((((x0+x1)+x2)+x3)+x4)`` — the fused 5-point
        stencil sweep — returning the weight constant, else None."""
        if not (isinstance(tree, tuple) and len(tree) == 2):
            return None
        f, subs = tree
        if getattr(f, "name", None) != "multiply" or len(subs) != 2:
            return None
        const, chain = subs
        if const[0] != "const":
            const, chain = chain, const
        if const[0] != "const":
            return None
        expect = 4
        while isinstance(chain, tuple) and len(chain) == 2 and getattr(
            chain[0], "name", None
        ) == "add":
            _, (left, right) = chain
            if right != ("leaf", expect):
                return None
            expect -= 1
            chain = left
        if chain != ("leaf", 0) or expect != 0:
            return None
        return const[1]

    def execute(self, op: OperationNode) -> None:
        match = self._stencil5_args(op.payload)
        if match is None:
            execute_payload(op.payload, self.storage, self.scratch)
        else:
            stencil5_group([match[:2]], weight=match[2])

    def _view(self, ref) -> torch.Tensor:
        """``resolve_ref`` of a tensor reference; a 2-D fragment of a 2-D
        block by ``as_strided`` (the same view as slicing, at half the
        host cost: the stencil path makes six a fragment)."""
        if ref[0] == "b":
            _, bid, frag = ref
            blk = self.storage[(bid, frag.block)]
            if blk.ndim == 2 and len(frag.local) == 2:
                (s0, e0, t0), (s1, e1, t1) = frag.local
                (n0, n1), (r0, r1) = blk.shape, blk.stride()
                if 0 <= s0 <= e0 <= n0 and 0 <= s1 <= e1 <= n1:
                    return blk.as_strided((-(-(e0 - s0) // t0), -(-(e1 - s1) // t1)),
                                          (r0 * t0, r1 * t1),
                                          blk.storage_offset() + s0 * r0 + s1 * r1)
        return resolve_ref(ref, self.storage, self.scratch)

    def _stencil5_args(self, p) -> Optional[tuple]:
        """(the five operand views, the output view, the weight) of a
        payload the stencil kernel takes, else None."""
        if not isinstance(p, MapPayload) or p.ufunc.tree is None or len(p.args) != 5:
            return None
        if any(r[0] == "c" for r in p.args):
            return None
        w = self._stencil5_weight(p.ufunc.tree)
        if w is None:
            return None
        xs = [self._view(r) for r in p.args]
        x0 = xs[0]
        if x0.ndim != 2 or any(
            x.shape != x0.shape or x.dtype != x0.dtype for x in xs
        ):
            return None
        key = (x0.dtype, operand_key(w))
        ok = self._stencil_loop_ok.get(key)
        if ok is None:
            dt = to_numpy_dtype(x0.dtype)
            # the kernel computes in the blocks' dtype: take it only where
            # NumPy would too (a strong np.float64 weight promotes float32)
            ok = (dt in self._STENCIL_DTYPES
                  and loop_dtypes("multiply", (dt, key[1]))[1] == dt)
            self._stencil_loop_ok[key] = ok
        if not ok:
            return None
        # the kernel writes in place: the output view must be the
        # operands' shape and dtype (else the store would broadcast or cast)
        out = self._view(("b", p.out_base, p.out_frag))
        if out.shape != x0.shape or out.dtype != x0.dtype:
            return None
        return xs, out, float(w)

    def split_batch(self, ops: list) -> tuple[list, list]:
        """Group the batch's stencil ops by dtype, device and weight."""
        groups: dict = {}
        rest = []
        for op in ops:
            try:
                match = self._stencil5_args(op.payload)
            except Exception:  # execute() raises it again, failing only this op's drain
                match = None
            if match is None:
                rest.append(op)
                continue
            xs, out, w = match
            g = groups.setdefault((out.dtype, out.device, w), LaunchGroup([], [], [], w))
            g.ops.append(op)
            g.items.append((xs, out))
            g.sizes.append(out.numel())
        return list(groups.values()), rest

    def prepare_group(self, group: LaunchGroup):
        if group.items[0][1].device.type == "cuda":
            return functools.partial(prepare_stencil5_group(group.items).launch, group.weight)
        return functools.partial(stencil5_group, group.items, weight=group.weight)


register_backend("torch", TorchBackend)


def make_backend(name, storage: dict, scratch: dict) -> ComputeBackend:
    """Resolve a compute backend through the plugin registry (an
    already-built instance passes through)."""
    if isinstance(name, ComputeBackend):
        return name
    return get_backend(name)(storage, scratch)


# ---------------------------------------------------------------------------
# The asynchronous executor
# ---------------------------------------------------------------------------


def _payload_kind(ops) -> str:
    """A compute unit's name for the device clock's timeout log: the
    payload's type (and ufunc), and how many ops share its launch."""
    payload = ops[0].payload
    uf = getattr(payload, "ufunc", None)
    kind = type(payload).__name__ + (f"({getattr(uf, 'name', uf)})" if uf is not None else "")
    return kind if len(ops) == 1 else f"{kind} x{len(ops)} in one launch"


class _DeviceClock:
    """Device time of compute payloads on one CUDA device.

    Every worker launches on the device's current stream, so the stream
    runs payloads one after another.  :meth:`timed` queues, under
    ``stream_lock`` (which the executor's transfers take too), a stream
    gate (:class:`~repro_torch.kernels.stream_gate.StreamGate`), the
    start event, the payload (or grouped launch) and the end event, then
    opens the gate.  The start event therefore runs only once the whole
    payload is queued behind it, and the end event right after its last
    kernel: a pair times the payload's kernels and the device's own gaps
    between them, not the host's dispatch, and no other launch lands
    between its events, so the pairs add up to the device's busy time.
    Device work the executor's owner issues outside it (the runtime's
    scatter, fill and gather) takes ``stream_lock`` too: queued inside a
    pair it would count there, and a synchronous copy queued behind a
    gate blocks the gate holder's own driver calls until the gate times
    out.

    A gate lets its stream go after ``GATE_TIMEOUT_S`` even if it is
    never opened: a payload that synchronises inside waits that out once
    and runs, and its pair counts from the timeout on.  Each timeout is
    counted in ``gate_timeouts`` (of the worker and of each drain the
    payload served) and logged in ``timeout_log`` as (kind, cause,
    host seconds the gate was held); ``max_hold_s`` is the longest the
    host held any gate.  The gate is made when the first drain is
    submitted (:meth:`make_gate`), and a drain cannot start without it:
    if it cannot be built, submitting raises; if a gate cannot be
    launched, the payload fails, and so does its drain.

    Pairs are kept per worker until :meth:`settle` (at the end of each
    drain) resolves them; a worker that holds more than ``MAX_PENDING``
    resolves its oldest first, waiting for the device if it must, so a
    long drain keeps a bounded number of live events."""

    MAX_PENDING = 64
    # well above the host's longest stall inside a gated section, and far
    # below a test's time limit.  With 8 serving tenants recording beside
    # the drains, a gate holder waits out Python's generation-2 garbage
    # collections, which hold the GIL for up to seconds (chip_smoke.py
    # phase S prints the longest): a 50 ms limit timed such gates out, and
    # their pairs counted host time.  The limit bounds only a payload that
    # synchronises inside, which none on the runtime's paths does.
    GATE_TIMEOUT_S = 5.0

    def __init__(self, device: torch.device, nworkers: int, stream_lock=None):
        self.device = device
        self.stream_lock = stream_lock if stream_lock is not None else threading.Lock()
        self._lock = threading.Lock()  # guards _pending, _free and the accounting
        self._pending = [collections.deque() for _ in range(nworkers)]
        self._free: list = []
        self._gate = None  # made by make_gate, under stream_lock
        self._timeouts_seen = 0  # of the gate's count, read into _timed_out
        self._timed_out: set = set()  # epochs that timed out, not yet resolved
        self.timeout_log: list = []
        self.max_hold_s = 0.0

    def make_gate(self) -> None:
        """Build the gate library and the gate (once), before a drain's
        payloads run, so that no payload's host time includes them."""
        if self._gate is not None:  # made: no wait behind a payload's launch
            return
        with self.stream_lock:
            if self._gate is None:
                from repro_torch.kernels.stream_gate import StreamGate

                self._gate = StreamGate(self.device)

    def _event(self):
        with self._lock:
            if self._free:
                return self._free.pop()
        return torch.cuda.Event(enable_timing=True)

    def timed(self, fn, ops) -> tuple:
        """Run ``fn`` between the two events of a gated pair; returns the
        record :meth:`add` takes.  ``ops`` (the unit's operations) name it
        in the timeout log."""
        start, end = self._event(), self._event()
        stream = torch.cuda.current_stream(self.device)
        with self.stream_lock:
            t0 = time.perf_counter()
            epoch = self._gate.wait(stream, self.GATE_TIMEOUT_S)
            fn_s = 0.0
            try:
                start.record(stream)
                t1 = time.perf_counter()
                fn()
                fn_s = time.perf_counter() - t1
            finally:
                end.record(stream)
                self._gate.open(epoch)
                held = time.perf_counter() - t0
                self.max_hold_s = max(self.max_hold_s, held)
        return start, end, epoch, (ops, fn_s, held)

    def add(self, rank: int, pair: tuple, wstats: WorkerStats, shares: list) -> None:
        """Keep ``pair`` (from :meth:`timed`) until settled: its time goes
        to ``wstats`` and, split by ``shares`` (``(drain stats,
        fraction)``), to each op's drain."""
        with self._lock:
            q = self._pending[rank]
            q.append((*pair, wstats, shares, rank, _obs.CURRENT))
            oldest = q.popleft() if len(q) > self.MAX_PENDING else None
        if oldest is not None:
            oldest[1].synchronize()
            with self._lock:
                self._resolve(oldest)

    def _resolve(self, rec) -> None:
        """Account one complete pair (call with ``_lock`` held, once its
        end event has completed), and hand its device time to the trace
        collector that saw the unit launch.  An event pair that cannot be
        resolved raises."""
        start, end, epoch, (ops, fn_s, held), wstats, shares, rank, col = rec
        t = start.elapsed_time(end) / 1e3
        wstats.compute_busy += t
        for dstats, share in shares:
            dstats.compute_busy += t * share
        if col is not None:
            col.compute_device(ops[0].uid, rank, t)
        n = self._gate.timeouts()
        for i in range(self._timeouts_seen, n):
            self._timed_out.add(self._gate.timed_out_epoch(i))
        self._timeouts_seen = n
        if epoch in self._timed_out:
            self._timed_out.discard(epoch)
            wstats.gate_timeouts += 1
            for dstats in {id(d): d for d, _ in shares}.values():
                dstats.gate_timeouts += 1
            # a payload that synchronised blocked the host until the gate
            # let go; otherwise the host was slower than the limit
            cause = ("it synchronised" if fn_s >= self.GATE_TIMEOUT_S
                     else "the host took longer than the timeout")
            self.timeout_log.append((_payload_kind(ops), cause, held))
        self._free += (start, end)

    def settle(self) -> None:
        """Wait for the device to finish everything launched so far and
        account every pair recorded before."""
        with self._lock:
            recs = [rec for q in self._pending for rec in q]
            for q in self._pending:
                q.clear()
        fin = torch.cuda.Event()
        fin.record(torch.cuda.current_stream(self.device))
        fin.synchronize()
        with self._lock:
            for rec in recs:
                self._resolve(rec)

    def close(self) -> None:
        """Free the gate once the device has run every gate queued."""
        with self.stream_lock:
            if self._gate is not None:
                torch.cuda.synchronize(self.device)
                self._gate.close()
                self._gate = None


class _Drain:
    """Bookkeeping for one in-flight drain on the shared pool.

    Every pending op is stamped with its owning drain at submit time
    (``op._drain``), so completion sweeps, per-drain stat accounting and
    failure cleanup can route mixed worker batches back to the right
    drain without a global registry lookup per op."""

    __slots__ = (
        "deps", "fut", "tag", "inflight", "ready_batch", "prev_hook",
        "t0", "snap", "solo", "finished", "procs",
        "comm_bytes", "n_comm_ops", "n_compute_ops", "n_handoffs",
        "n_messages",
    )

    def __init__(self, deps: DependencySystem, tag, nworkers: int):
        self.deps = deps
        self.fut = Future()
        self.tag = tag
        self.inflight = 0
        self.ready_batch: list[OperationNode] = []
        self.prev_hook = None
        self.t0 = 0.0
        self.snap: Optional[dict] = None
        # True while this drain has had the pool to itself for its whole
        # lifetime: its stats can then be the exact lifetime-delta the
        # serialized executor reported (including worker idle time)
        self.solo = True
        self.finished = False
        self.procs = [WorkerStats() for _ in range(nworkers)]
        self.comm_bytes = 0
        self.n_comm_ops = 0
        self.n_compute_ops = 0
        self.n_handoffs = 0
        self.n_messages = 0


class AsyncExecutor:
    """Drains DependencySystems on a persistent work-stealing worker
    pool + transfer channels.

    The executor is *persistent*: :meth:`submit` hands it a recorded
    graph (typically one dependency cone of a demand-driven flush) and
    returns a :class:`~repro_torch.exec.futures.Future` that resolves — from
    the completing worker/progress thread — with that drain's
    :class:`WaitStats`.  The submitting thread keeps running (recording
    more operations) while the drain proceeds, and **multiple drains
    may be in flight concurrently**: each drain carries its own
    dependency system, in-flight counter and per-worker accounting, and
    completion sweeps route mixed batches back per drain.  The caller
    is responsible for only submitting graphs whose access footprints
    don't conflict with in-flight drains (``Runtime.flush`` joins
    conflicting tickets first — see ``repro_torch.core.graph.cones_conflict``);
    ops *within* one submitted graph are ordered by its dependency
    system as always.  :meth:`run` is the blocking convenience
    (``submit().result()``).

    Work stealing: a worker whose queue runs dry asks :meth:`_steal_for`
    for work before parking.  Victim selection is longest-queue-first
    gated by the latency-aware threshold of arXiv 1805.01768 — steal
    only when the victim holds at least ``steal_threshold`` ops *and*
    the expected work moved (half the victim's queue × the EWMA task
    grain) exceeds ``steal_latency``, the measured cost of a steal
    round trip.  Otherwise a slow cone's tail would be diced into
    steals that cost more than they move.

    With ``batch_dispatch=True`` (set by the ``"batch"`` plan pass) the
    completion sweep groups newly-ready compute ops per worker and
    pushes each group with one lock+notify, workers drain their whole
    queue per wakeup, and a finished batch is completed through a
    single dependency-system sweep — the handoff count drops from one
    per operation to one per batch (``WaitStats.n_handoffs``)."""

    def __init__(
        self,
        nworkers: int,
        storage: dict,
        scratch: dict,
        backend: str = "torch",
        channel: str = "async",
        latency: float = 0.0,
        progress_threads: int = 2,
        batch_dispatch: bool = False,
        steal: bool = True,
        steal_threshold: int = 4,
        steal_latency: float = 1e-4,
        device=None,
        stream_lock=None,
    ):
        self.nworkers = nworkers
        self.backend = make_backend(backend, storage, scratch)
        # blocks on a CUDA device: compute is timed by device events, not
        # by the host's thread time (a launch returns once it is queued)
        device = torch.device("cpu" if device is None else device)
        # (``stream_lock``: the owner's, for device work it issues outside
        # the executor — Runtime.scatter / gather)
        self._clock = (_DeviceClock(device, nworkers, stream_lock)
                       if device.type == "cuda" else None)
        # a channel instance may be shared across flushes (the owner closes
        # it); a name means this executor owns the channel's lifecycle
        self._owns_channel = isinstance(channel, str)
        self.channel = make_channel(
            channel, latency=latency, progress_threads=progress_threads
        )
        self.mode = "blocking-channel" if self.channel.blocking else "async"
        self.batch_dispatch = batch_dispatch
        self.steal = steal and nworkers > 1
        self.steal_threshold = max(2, steal_threshold)
        self.steal_latency = max(0.0, steal_latency)
        # EWMA of per-op compute grain (seconds) — the τ in the 1805.01768
        # gate "move only if n·τ ≥ steal latency".  Starts at the steal
        # latency so the first steals are allowed until measured.  Host
        # time, also on a GPU: it is weighed against a host-side steal
        # latency, and stealing moves host launch work.
        self._grain_ewma = max(self.steal_latency, 1e-6)
        self.workers = [
            Worker(
                r,
                self._run_batch,
                self._record_error,
                batch=batch_dispatch,
                steal_fn=self._steal_for if self.steal else None,
            )
            for r in range(nworkers)
        ]
        self._glock = threading.Lock()  # guards drains + counters
        self._drains: dict[int, _Drain] = {}  # id(drain) -> drain
        self._anon_tags = itertools.count()
        self._error: Optional[BaseException] = None
        self._workers_started = False
        self._closed = False
        # lifetime totals (executor introspection; per-drain stats are
        # accounted per-op on each _Drain)
        self.comm_bytes = 0
        self.n_comm_ops = 0
        self.n_compute_ops = 0
        self.n_handoffs = 0

    # -- error paths -------------------------------------------------------
    def _record_error(self, exc: BaseException) -> None:
        """Pool-level failure (worker thread death, internal error): the
        pool is no longer trustworthy — poison it and fail every active
        drain."""
        with self._glock:
            if self._error is None:
                self._error = exc
            drains = list(self._drains.values())
        for d in drains:
            self._finish_drain(d, exc)

    def _fail_drain(self, drain: _Drain, exc: BaseException) -> None:
        """Per-op failure: only the owning drain dies; the pool (and any
        concurrent drains) keeps running."""
        self._finish_drain(drain, exc)

    # -- transfer execution (runs on progress threads / workers) ----------
    def _exec_comm(self, op: OperationNode) -> None:
        if self._clock is None:
            execute_payload(op.payload, self.backend.storage, self.backend.scratch)
            return
        with self._clock.stream_lock:  # never inside a compute payload's event pair
            execute_payload(op.payload, self.backend.storage, self.backend.scratch)

    # -- work stealing -----------------------------------------------------
    def _steal_for(self, thief: Worker) -> Optional[list[OperationNode]]:
        """Steal policy, run by an idle worker before parking: pick the
        longest queue holding at least ``steal_threshold`` ops, take
        half its tail (one op unbatched), but only when the expected
        work moved clears the steal-latency gate (arXiv 1805.01768)."""
        if self._closed or self._error is not None:
            return None
        victim = None
        vlen = self.steal_threshold - 1
        for w in self.workers:
            if w is thief:
                continue
            n = w.qlen()  # racy heuristic read; steal_from re-checks
            if n > vlen:
                victim, vlen = w, n
        if victim is None:
            return None
        n = max(1, vlen // 2) if self.batch_dispatch else 1
        # latency-aware gate: moving n ops pays only when their expected
        # grain amortizes the steal round trip
        if n * self._grain_ewma < self.steal_latency:
            return None
        return victim.steal_from(n) or None

    def _wake_thieves(self, loaded_ranks) -> None:
        """After a dispatch left some queue at/above the steal threshold,
        nudge parked empty-queue workers to re-run the steal policy."""
        for w in self.workers:
            if w.rank not in loaded_ranks and w.qlen() == 0:
                w.wake()

    # -- dispatch ---------------------------------------------------------
    def _count_op(self, op: OperationNode, drain: _Drain) -> None:
        """Op accounting — call with _glock held (many threads dispatch)."""
        if op.kind == COMM:
            self.n_comm_ops += 1
            self.comm_bytes += op.nbytes
            drain.n_comm_ops += 1
            drain.comm_bytes += op.nbytes
            drain.n_messages += 1  # every comm op is posted exactly once
        else:
            self.n_compute_ops += 1
            drain.n_compute_ops += 1

    def _dispatch_batch(self, ops: list[OperationNode]) -> None:
        """Route a sweep of ready ops.  COMM on the async channel is
        initiated immediately from the discovering thread in one batched
        post (aggressive initiation — invariant 2 holds even while the
        owner workers are mid-compute); everything else is grouped per
        owner and handed to the comm-first ready queues — one push per
        worker under batched dispatch, one per op otherwise."""
        if not ops:
            return
        async_comm: list[OperationNode] = []
        per_worker: dict[int, list[OperationNode]] = {}
        for op in ops:
            if op.kind == COMM and not self.channel.blocking:
                async_comm.append(op)
            else:
                per_worker.setdefault(op.procs[0] % self.nworkers, []).append(op)
        if async_comm:
            post_many = getattr(self.channel, "post_many", None)
            items = [(op, self._exec_comm) for op in async_comm]
            if post_many is not None:
                futs = post_many(items)
            else:  # channel plugin without batched posting
                futs = [self.channel.post(op, ex) for op, ex in items]
            for op, fut in zip(async_comm, futs):
                fut.add_done_callback(self._comm_callback(op))
        handoffs = 0
        heavy = False
        for rank, group in per_worker.items():
            if self.batch_dispatch:
                self.workers[rank].push_batch(group)
                handoffs += 1
            else:
                for op in group:
                    self.workers[rank].push(op)
                    handoffs += 1
            heavy = heavy or len(group) >= self.steal_threshold
        if handoffs:
            with self._glock:
                self.n_handoffs += handoffs
                for rank, group in per_worker.items():
                    seen = set()
                    for op in group:
                        d = op._drain
                        if id(d) not in seen:
                            seen.add(id(d))
                            d.n_handoffs += 1
        if self.steal and heavy:
            self._wake_thieves(set(per_worker))

    def _comm_callback(self, op: OperationNode):
        def cb(fut) -> None:
            exc = fut.exception()
            if exc is not None:
                self._fail_drain(op._drain, exc)
            else:
                self._ops_done((op,))

        return cb

    def _run_batch(self, ops: list[OperationNode], worker: Worker) -> None:
        """Execute one worker batch (comm-first order already applied by
        the pop) and complete it through a single dependency sweep.  A
        batch may mix ops from several concurrent drains; per-op stats
        are binned into each op's own drain, and a failing op kills only
        its drain — the rest of the batch still executes.  The compute
        ops go to the backend's launch groups (:meth:`ComputeBackend.
        split_batch`) first, then one by one in the batch's order."""
        completed: list[OperationNode] = []
        compute: list[OperationNode] = []
        col = _obs.CURRENT
        rank = worker.rank
        for op in ops:
            drain: _Drain = op._drain
            if drain.finished:
                continue  # drain failed elsewhere: its leftovers are void
            dstats = drain.procs[rank]
            if op.kind == COMM:  # blocking channel only: inline transfer
                t0 = time.perf_counter()  # wall: the blocking IS the waiting
                if col is not None:
                    col.wait_start(rank, "channel")
                fut = self.channel.post(op, self._exec_comm)
                try:
                    # wait for resolution: the built-in BlockingChannel
                    # resolves before post() returns, but a registered
                    # blocking transport may resolve from a delivery
                    # thread — the op must not complete before its data
                    fut.result()
                except BaseException as exc:
                    dt = time.perf_counter() - t0
                    worker.stats.comm_busy += dt
                    worker.stats.n_comm += 1
                    dstats.comm_busy += dt
                    dstats.n_comm += 1
                    if col is not None:
                        col.wait_end(rank, "channel", op.uid)
                    self._fail_drain(drain, exc)
                    continue
                dt = time.perf_counter() - t0
                worker.stats.comm_busy += dt
                worker.stats.n_comm += 1
                dstats.comm_busy += dt
                dstats.n_comm += 1
                if col is not None:
                    col.wait_end(rank, "channel", op.uid)
                completed.append(op)
                continue
            compute.append(op)
        if compute:
            groups, rest = self.backend.split_batch(compute)
            for group in groups:
                # a failed unit before this one may have ended some drains
                keep = [i for i, op in enumerate(group.ops) if not op._drain.finished]
                if len(keep) < len(group.ops):
                    group = group.subset(keep)
                if group.ops:
                    self._run_compute(group.ops, group.sizes, worker, col, completed,
                                      prepare=functools.partial(self.backend.prepare_group,
                                                                group))
            for op in rest:
                if not op._drain.finished:
                    self._run_compute((op,), (1,), worker, col, completed,
                                      run=functools.partial(self.backend.execute, op))
        if completed:
            self._ops_done(completed)

    def _run_compute(self, ops, sizes, worker: Worker, col, completed: list, *,
                     prepare=None, run=None) -> None:
        """Run one compute unit — one payload (``run``), or one grouped
        launch of several (``prepare()`` returns its launch) — and
        account it to each of its ops, split by ``sizes`` (element
        counts).  ``host_busy`` is per-thread CPU time: wall durations on
        an oversubscribed machine include GIL/scheduler preemption, which
        would inflate "busy" exactly when contention is worst.
        ``compute_busy`` is that same time on the CPU, and on a GPU the
        device time of the launch (its event pair, resolved later; a
        group's host preparation stays outside the pair).  A failing unit
        kills the drain of each of its ops."""
        rank = worker.rank
        if col is not None:
            for op in ops:
                col.compute_start(op.uid, rank)
        t0 = time.thread_time()
        try:
            if run is None:
                run = prepare()
            if self._clock is None:
                run()
            else:
                pair = self._clock.timed(run, ops)
        except BaseException as exc:
            if col is not None:
                for op in ops:
                    col.compute_end(op.uid, rank)
            for drain in {id(op._drain): op._drain for op in ops}.values():
                self._fail_drain(drain, exc)
            return
        dt = time.thread_time() - t0
        total = sum(sizes)
        shares = [n / total for n in sizes] if total else [1 / len(ops)] * len(ops)
        for op, share in zip(ops, shares):
            dstats = op._drain.procs[rank]
            worker.stats.host_busy += dt * share
            worker.stats.n_compute += 1
            dstats.host_busy += dt * share
            dstats.n_compute += 1
            if self._clock is None:
                worker.stats.compute_busy += dt * share
                dstats.compute_busy += dt * share
            # unlocked EWMA: a heuristic input for the steal gate only
            self._grain_ewma += 0.2 * (dt * share - self._grain_ewma)
        if self._clock is not None:
            self._clock.add(rank, pair, worker.stats,
                            [(op._drain.procs[rank], share) for op, share in zip(ops, shares)])
        for op in ops:
            if col is not None:
                col.compute_end(op.uid, rank)
            completed.append(op)

    # -- completion (worker batches and channel callbacks land here) -------
    def _ops_done(self, ops) -> None:
        # this runs on worker/progress threads (including as a future
        # done-callback): it must never raise, or the completing thread
        # dies and the drain hangs
        try:
            self._ops_done_inner(ops)
        except BaseException as internal:  # pragma: no cover - defensive
            self._record_error(internal)

    def _ops_done_inner(self, ops) -> None:
        col = _obs.CURRENT
        to_dispatch: list[OperationNode] = []
        finishing: list[tuple[_Drain, Optional[BaseException]]] = []
        with self._glock:
            groups: dict[int, list[OperationNode]] = {}
            for op in ops:
                groups.setdefault(id(op._drain), []).append(op)
            for key, dops in groups.items():
                drain = self._drains.get(key)
                if drain is None or drain.finished:
                    continue  # late completions of an already-failed drain
                deps = drain.deps
                drain.inflight -= len(dops)
                ready_pairs = [] if col is not None else None
                for op in dops:
                    # complete() returns the ops this completion made ready
                    # — the causality edge wait attribution charges along
                    made_ready = deps.complete(op)  # on_ready -> ready_batch
                    if ready_pairs is not None:
                        for nxt in made_ready:
                            ready_pairs.append((nxt.uid, op.uid))
                if ready_pairs:
                    col.ready_many(ready_pairs)
                newly = drain.ready_batch
                drain.ready_batch = []
                drain.inflight += len(newly)
                for nxt in newly:
                    self._count_op(nxt, drain)
                to_dispatch.extend(newly)
                if drain.inflight == 0:
                    finishing.append(
                        (drain, None if deps.done else self._deadlock_error(deps))
                    )
            if col is not None:
                col.counter(
                    "ops-inflight",
                    sum(d.inflight for d in self._drains.values()),
                )
        self._dispatch_batch(to_dispatch)
        for drain, exc in finishing:
            self._finish_drain(drain, exc)

    def _deadlock_error(self, deps: Optional[DependencySystem]) -> DeadlockError:
        stuck = deps.pending_ops() if deps is not None else []
        return DeadlockError(
            f"async flush stalled: {len(stuck)} operations pending, none in "
            f"flight — dependency cycle or lost completion.\nstuck operation-nodes:\n"
            + format_stuck_ops(stuck)
        )

    # -- per-drain accounting ---------------------------------------------
    def _snapshot(self) -> dict:
        return dict(
            workers=[w.stats.snapshot() for w in self.workers],
            comm_bytes=self.comm_bytes,
            n_comm_ops=self.n_comm_ops,
            n_compute_ops=self.n_compute_ops,
            n_handoffs=self.n_handoffs,
            n_posted=getattr(self.channel, "n_posted", 0),
        )

    def _stats_since(self, snap: dict, elapsed: float) -> WaitStats:
        procs = [w.stats.since(s) for w, s in zip(self.workers, snap["workers"])]
        return WaitStats(
            mode=self.mode,
            nworkers=self.nworkers,
            elapsed=elapsed,
            procs=procs,
            comm_bytes=self.comm_bytes - snap["comm_bytes"],
            n_comm_ops=self.n_comm_ops - snap["n_comm_ops"],
            n_compute_ops=self.n_compute_ops - snap["n_compute_ops"],
            seq_time=sum(p.compute_busy for p in procs),
            n_flushes=1,
            n_handoffs=self.n_handoffs - snap["n_handoffs"],
            n_messages=getattr(self.channel, "n_posted", 0) - snap["n_posted"],
        )

    def _drain_stats(self, drain: _Drain, elapsed: float) -> WaitStats:
        """Per-drain WaitStats.  A drain that had the pool to itself its
        whole lifetime reports the exact lifetime-delta the serialized
        executor reported (including worker idle time between its ops);
        an overlapped drain reports its own per-op accounting — worker
        idle/wakeups are shared-pool quantities with no meaningful
        per-drain split, so they stay zero and ``wait_fraction``
        (compute-vs-elapsed) remains well-defined per tenant."""
        if drain.solo:
            return self._stats_since(drain.snap, elapsed)
        return WaitStats(
            mode=self.mode,
            nworkers=self.nworkers,
            elapsed=elapsed,
            procs=drain.procs,
            comm_bytes=drain.comm_bytes,
            n_comm_ops=drain.n_comm_ops,
            n_compute_ops=drain.n_compute_ops,
            seq_time=sum(p.compute_busy for p in drain.procs),
            n_flushes=1,
            n_handoffs=drain.n_handoffs,
            n_messages=drain.n_messages,
        )

    def _finish_drain(
        self, drain: _Drain, exc: Optional[BaseException] = None
    ) -> None:
        """Finalize one drain exactly once: detach its graph, restore its
        hook, and resolve its future — with the measured WaitStats, or
        with ``exc``.  Runs on whichever thread completes (or kills) the
        drain's last in-flight operation."""
        with self._glock:
            if drain.finished:
                return
            drain.finished = True
            self._drains.pop(id(drain), None)
            drain.ready_batch = []
            drain.inflight = 0
        if drain.deps is not None:
            drain.deps.on_ready = drain.prev_hook
        if exc is not None:
            # a failed drain's queued-but-unexecuted leftovers must not
            # run later against state a subsequent flush re-plans
            for w in self.workers:
                w.discard(lambda op: getattr(op, "_drain", None) is drain)
        if self._clock is not None:
            # the makespan ends when the device has finished the drain's
            # work, and its compute is known only then
            try:
                self._clock.settle()
            except BaseException as err:
                if exc is None:
                    exc = err
                else:
                    exc.add_note(f"device compute timing could not be settled: {err!r}")
        # after settling: the trace's drain segment ends where the
        # makespan does, and holds the drain's device-time events
        col = _obs.CURRENT
        if col is not None:
            col.drain_end(drain.tag)
        elapsed = time.perf_counter() - drain.t0
        if exc is not None:
            drain.fut.set_exception(exc)
        else:
            drain.fut.set_result(self._drain_stats(drain, elapsed))

    # -- main entry -------------------------------------------------------
    def submit(
        self,
        deps: DependencySystem,
        batch_dispatch: Optional[bool] = None,
        tag=None,
    ) -> Future:
        """Start draining ``deps`` and return a Future resolving to the
        drain's :class:`WaitStats` (or raising its failure).  Returns
        immediately; the caller keeps its thread.  May be called again
        while prior drains are in flight — concurrent drains share the
        worker pool; the caller guarantees the submitted graphs'
        access footprints don't conflict (``Runtime.flush`` serializes
        conflicting cones by joining their tickets first)."""
        return self.submit_many([(deps, tag)], batch_dispatch=batch_dispatch)[0]

    def submit_many(
        self,
        items: list,
        batch_dispatch: Optional[bool] = None,
    ) -> list:
        """Start draining several graphs — ``items`` is a list of
        ``(deps, tag)`` pairs — in ONE submission round, returning one
        Future per item (in order).  The cross-tenant cone batcher's
        entry point: registering the whole group under a single
        global-lock round, a single worker wake, and a single initial
        dispatch sweep amortizes the per-drain submission overhead that
        dominates small-cone serving workloads.

        Exactly like repeated :meth:`submit` calls otherwise; the caller
        guarantees the graphs' access footprints are mutually
        non-conflicting (the cone batcher inherits this from
        ``Runtime._join_conflicting``'s extraction-order bound).  Every
        drain submitted through a group of two or more is accounted as
        an *overlapped* drain (per-drain stats binning, never the
        solo-exact lifetime delta) — co-submitted cones share the pool
        by construction."""
        if self._closed:
            raise RuntimeError("AsyncExecutor is closed")
        if self._error is not None:
            raise self._error
        if self._clock is not None:
            self._clock.make_gate()
        col = _obs.CURRENT
        prepared = []  # (deps, drain, pending) per item
        with self._glock:
            if batch_dispatch is not None and batch_dispatch != self.batch_dispatch:
                if self._drains:
                    raise RuntimeError(
                        "cannot switch dispatch granularity while drains "
                        "are in flight"
                    )
                self.batch_dispatch = batch_dispatch
                for w in self.workers:
                    w.set_batch(batch_dispatch)
            for deps, tag in items:
                if tag is None:
                    # drains need a distinguishable id: trace segments of
                    # concurrent drains pair begin/end events by tag
                    tag = f"anon-{next(self._anon_tags)}"
                drain = _Drain(deps, tag, self.nworkers)
                drain.prev_hook = deps.on_ready
                pending = deps.pending_ops()
                for op in pending:
                    op._drain = drain
                prepared.append((deps, drain, pending))
            if self._drains or len(prepared) > 1:
                for d in self._drains.values():
                    d.solo = False
                for _deps, drain, _p in prepared:
                    drain.solo = False
            for _deps, drain, _p in prepared:
                drain.snap = self._snapshot()
                drain.t0 = time.perf_counter()
                self._drains[id(drain)] = drain
            if not self._workers_started:
                self._workers_started = True
                for w in self.workers:
                    w.start()
        for deps, drain, pending in prepared:
            # late-bound: _ops_done swaps ready_batch for a fresh list per
            # sweep; the default-arg binding pins each drain to its hook
            deps.on_ready = lambda op, d=drain: d.ready_batch.append(op)
            if col is not None:
                col.drain_begin(drain.tag, deps.n_pending, self.nworkers)
                col.drain_ops(drain.tag, [op.uid for op in pending])
        for w in self.workers:
            w.drain_started()  # parked-between-drains time is not idle
        # initial dispatch: everything recorded ready before we attached
        to_dispatch = []
        finishing = []
        with self._glock:
            for deps, drain, _p in prepared:
                initial = []
                while True:
                    op = deps.pop_ready()
                    if op is None:
                        break
                    initial.append(op)
                    self._count_op(op, drain)
                drain.inflight += len(initial)
                to_dispatch.extend(initial)
                if not initial:
                    finishing.append(
                        (drain,
                         None if deps.done else self._deadlock_error(deps))
                    )
        for drain, exc in finishing:
            self._finish_drain(drain, exc)  # empty graph: empty stats
        if to_dispatch:
            self._dispatch_batch(to_dispatch)
        return [drain.fut for _deps, drain, _p in prepared]

    @property
    def n_active_drains(self) -> int:
        with self._glock:
            return len(self._drains)

    def run(self, deps: DependencySystem) -> WaitStats:
        """Drain ``deps`` to completion; returns the measured WaitStats
        for this flush (``submit`` + blocking wait).  The worker pool
        persists across calls until :meth:`close`."""
        return self.submit(deps).result()

    def close(self) -> None:
        """Stop the worker pool and (if owned) the channel.  Idempotent —
        a double close is a no-op.  Any still-active drain is failed
        (the owner should have joined its tickets first)."""
        if self._closed:
            return
        self._closed = True
        with self._glock:
            drains = list(self._drains.values())
        for d in drains:
            self._finish_drain(
                d, RuntimeError("AsyncExecutor closed with a drain in flight")
            )
        for w in self.workers:
            w.stop()
        if self._workers_started:
            for w in self.workers:
                w.join(timeout=5.0)
        if self._clock is not None:
            self._clock.close()
        if self._owns_channel:
            self.channel.close()


# ---------------------------------------------------------------------------
# Fig. 6 on real threads: naive BSP + two-sided rendezvous messaging
# ---------------------------------------------------------------------------


def run_rendezvous_bsp_async(
    per_proc_programs: list[list[dict]], static_check: bool = True
) -> int:
    """Execute the paper's naive evaluation (fig. 6) with real threads:
    each rank walks its own operation list in order; sends and receives
    rendezvous through a :class:`RendezvousMailbox`.

    Well-ordered schedules complete and return the number of completed
    steps.  Schedules like fig. 6's deadlock — rejected *statically at
    plan time* by the ``repro_torch.analysis`` deadlock rule (a cycle in the
    cross-rank message-match graph, or an unmatched message) before any
    thread starts, and — for completeness with ``static_check=False`` —
    also detected structurally at runtime (all live ranks parked on
    unmatched messages).  Both paths refuse with a
    :class:`DeadlockError` listing the stuck operation-nodes.  This is
    the contrast the flush executor exists for: the *same* data movement
    expressed as one-sided transfers in a dependency graph cannot
    deadlock (§5.7.1).
    """
    if static_check:
        from repro_torch.analysis import check

        report = check(schedule=per_proc_programs, rules=("deadlock",))
        if not report.ok:
            raise DeadlockError(
                "rendezvous-BSP schedule rejected statically at plan time "
                "(repro_torch.analysis deadlock rule):\n"
                + "\n".join(d.message for d in report.errors)
            )
    n = len(per_proc_programs)
    mailbox = RendezvousMailbox(n)
    steps = [0] * n
    failures: list[RendezvousDeadlock] = []
    lock = threading.Lock()

    def rank_main(rank: int) -> None:
        try:
            for pc, op in enumerate(per_proc_programs[rank]):
                if op["kind"] == "compute":
                    steps[rank] += 1
                    continue
                mailbox.transact(rank, op["kind"], op["peer"], op["tag"], pc)
                steps[rank] += 1
        except RendezvousDeadlock as exc:
            with lock:
                failures.append(exc)
        finally:
            mailbox.finish(rank)

    threads = [
        threading.Thread(target=rank_main, args=(r,), name=f"bsp-rank-{r}")
        for r in range(n)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        stuck = failures[0].stuck
        lines = [
            f"  p{s['rank']}@step{s['step']}: {s['kind']} tag={s['tag']!r} "
            f"peer=p{s['peer']}"
            for s in stuck
        ]
        raise DeadlockError(
            "rendezvous-BSP schedule deadlocked (paper fig. 6): every live "
            "rank is parked on an unmatched two-sided message.\n"
            "stuck operation-nodes:\n" + "\n".join(lines)
        )
    return sum(steps)
