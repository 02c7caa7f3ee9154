"""Lazy-evaluation engine (paper §5.5–§5.7).

The :class:`Runtime` records every operation on distributed arrays instead
of executing it (lazy evaluation, §5.6).  Operations are split into
sub-view-block fragments (§5.2), each fragment becoming one operation-node
whose access-nodes are inserted into per-base-block dependency lists
(§5.7.2).  Remote operand fragments generate communication operation-nodes
(transfer → scratch buffer) that the comm-first flush scheduler (§5.7)
initiates aggressively.

A *flush* (triggered by a read of distributed data, by the recorded-op
threshold, or by context exit — §5.6) drains the dependency system through
:func:`repro_torch.core.scheduler.run_schedule`, simultaneously executing the
real block work and accounting the timeline on the cluster model.

Blocks live on the runtime's ``torch.device`` (the GPU unless the caller
asks for the CPU): :meth:`Runtime.scatter` and :meth:`Runtime.fill_base`
allocate block tensors there, every payload runs as torch code on them
(:func:`execute_payload`), and :meth:`Runtime.gather` copies a view back
into a host ``ndarray`` — the user-facing model stays NumPy.

Flushes are *demand-driven* (``sync="demand"``): a readback extracts and
drains only the dependency cone of the blocks being read
(:func:`repro_torch.core.graph.producer_cone`), and ``flush(wait=False)``
submits the drain to the persistent executor and returns a
:class:`FlushTicket` instead of joining, so recording overlaps the
drain.  ``sync="barrier"`` restores the paper's whole-graph blocking
flush (the simulator default).
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time as _time
import weakref
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.obs import collector as _obs

from .blocks import (
    Fragment,
    Layout,
    OperandSpec,
    ViewSpec,
    default_process_grid,
    fragment_iteration_space,
)
from .graph import (
    COMM,
    COMPUTE,
    AccessNode,
    DependencySystem,
    OperationNode,
    producer_cone,
)
from .scheduler import run_schedule  # noqa: F401  (registers the built-in modes)
from .timeline import GIGE_2012, ClusterSpec, TimelineResult
from .ufunc import (
    UFunc,
    apply_ufunc,
    eval_ufunc,
    get_ufunc,
    to_numpy_dtype,
    to_torch_dtype,
    torch_reduce,
)

__all__ = [
    "Runtime",
    "ArrayBase",
    "FlushTicket",
    "PendingFlush",
    "current_runtime",
    "execute_payload",
    "resolve_ref",
    "import_storage",
    "export_storage",
]

_base_ids = itertools.count(1)
_scratch_ids = itertools.count(1)

_tls = threading.local()


def current_runtime() -> "Runtime":
    rt = getattr(_tls, "runtime", None)
    if rt is None:
        raise RuntimeError("no active repro_torch.core Runtime — use `with Runtime(...):`")
    return rt


# ---------------------------------------------------------------------------
# Operation payloads (executed by the scheduler at schedule time)
# ---------------------------------------------------------------------------

# input reference: ("b", base_id, Fragment) local block piece,
#                  ("s", scratch_id)        delivered/communicated piece,
#                  ("c", constant)          python scalar


@dataclass
class MapPayload:
    ufunc: UFunc
    out_base: int
    out_frag: Fragment
    args: tuple  # ordered input references
    out_dtype: np.dtype


@dataclass
class TransferPayload:
    src: tuple  # ("b", base_id, Fragment) or ("s", scratch_id)
    dst_scratch: int


@dataclass
class ReducePartialPayload:
    ufunc_name: str
    src: tuple
    axes: tuple[int, ...]  # operand axes to reduce
    dst_scratch: int
    keepdims: bool = False


@dataclass
class CombinePayload:
    ufunc_name: str
    out_base: int
    out_frag: Fragment
    src_scratch: int
    init: bool


@dataclass
class MatmulPayload:
    out_base: int
    out_frag: Fragment
    a: tuple
    b: tuple
    trans_a: bool
    trans_b: bool
    init: bool


@dataclass
class FillPayload:
    out_base: int
    out_frag: Fragment
    value: object


# -- plan-stage payloads (produced by repro_torch.core.plan / repro_torch.core.fusion
# graph passes, never recorded directly) ------------------------------------


@dataclass
class CoalescedTransferPayload:
    """Several same-(src, dst) transfers merged into ONE wire message by
    the ``coalesce`` plan pass: the channel posts a single send whose
    delivery fills every constituent scratch buffer."""

    transfers: tuple  # tuple[TransferPayload, ...]


@dataclass
class FusedMapReducePayload:
    """A map whose only consumer was a partial reduction of the same
    fragment (and whose output base is dead), fused by the ``fuse`` plan
    pass: the elementwise result goes straight into the reduction's
    scratch buffer without a block-storage round trip."""

    map: MapPayload
    ufunc_name: str
    axes: tuple[int, ...]
    dst_scratch: int
    keepdims: bool = False


# ---------------------------------------------------------------------------
# Payload interpretation — shared by the simulated executor (run_schedule's
# ``executor`` callback) and the asynchronous executor in repro_torch.exec.
# It is deliberately a pure function of (payload, storage, scratch): any
# executor that respects the dependency graph's ordering of conflicting
# accesses produces bit-identical block contents through it.  Blocks and
# scratch buffers are tensors on one device; every launch goes to the
# current stream, so device work is ordered by host launch order, which
# the dependency graph already fixes.
# ---------------------------------------------------------------------------


def resolve_ref(ref, storage: dict, scratch: dict):
    """Input reference -> tensor: ("b", base, frag) block piece (a view),
    ("s", sid) scratch buffer, ("c", const) scalar."""
    kind = ref[0]
    if kind == "b":
        _, bid, frag = ref
        return storage[(bid, frag.block)][frag.slices]
    if kind == "s":
        return scratch[ref[1]]
    return ref[1]  # constant


def _store(blk: torch.Tensor, slices, value) -> None:
    """``blk[slices] = value`` with NumPy's assignment semantics:
    broadcast, then cast to the block's dtype.  A scalar is stored as a
    Python number, which the device fills in without a host copy."""
    if isinstance(value, np.generic):
        value = value.item()
    blk[slices] = value


def execute_payload(p, storage: dict, scratch: dict) -> None:
    """Execute one operation payload against block/scratch storage."""
    if isinstance(p, TransferPayload):
        # always materialize a copy: the wire transfer must snapshot the
        # source at send time (an aliasing view would see later writes)
        scratch[p.dst_scratch] = resolve_ref(p.src, storage, scratch).clone()
    elif isinstance(p, MapPayload):
        args = [resolve_ref(r, storage, scratch) for r in p.args]
        res = eval_ufunc(p.ufunc, args)
        _store(storage[(p.out_base, p.out_frag.block)], p.out_frag.slices, res)
    elif isinstance(p, ReducePartialPayload):
        arr = resolve_ref(p.src, storage, scratch)
        scratch[p.dst_scratch] = torch_reduce(
            p.ufunc_name, arr, p.axes if p.axes else None, p.keepdims
        )
    elif isinstance(p, CombinePayload):
        part = scratch[p.src_scratch]
        blk = storage[(p.out_base, p.out_frag.block)]
        if p.init:
            _store(blk, p.out_frag.slices, part)
        else:
            cur = blk[p.out_frag.slices]
            _store(blk, p.out_frag.slices,
                   apply_ufunc(get_ufunc(p.ufunc_name), cur, part))
    elif isinstance(p, MatmulPayload):
        a = resolve_ref(p.a, storage, scratch)
        b = resolve_ref(p.b, storage, scratch)
        if p.trans_a:
            a = a.T
        if p.trans_b:
            b = b.T
        dt = to_torch_dtype(
            np.result_type(to_numpy_dtype(a.dtype), to_numpy_dtype(b.dtype))
        )
        val = torch.matmul(a.to(dt), b.to(dt))
        blk = storage[(p.out_base, p.out_frag.block)]
        if p.init:
            _store(blk, p.out_frag.slices, val)
        else:
            blk[p.out_frag.slices].add_(val)
    elif isinstance(p, FillPayload):
        blk = storage[(p.out_base, p.out_frag.block)]
        _store(blk, p.out_frag.slices, p.value)
    elif isinstance(p, CoalescedTransferPayload):
        for t in p.transfers:
            scratch[t.dst_scratch] = resolve_ref(t.src, storage, scratch).clone()
    elif isinstance(p, FusedMapReducePayload):
        m = p.map
        args = [resolve_ref(r, storage, scratch) for r in m.args]
        res = eval_ufunc(m.ufunc, args)
        if not isinstance(res, torch.Tensor):  # every operand was folded
            dev = storage[(m.out_base, m.out_frag.block)].device
            res = torch.tensor(res, device=dev)
        # reproduce the store semantics the unfused pair had: the map
        # result was broadcast into (and cast to) the output fragment,
        # then the reduction read exactly that fragment
        res = torch.broadcast_to(res, m.out_frag.shape).to(
            to_torch_dtype(m.out_dtype)
        )
        scratch[p.dst_scratch] = torch_reduce(
            p.ufunc_name, res, p.axes if p.axes else None, p.keepdims
        )
    else:  # pragma: no cover
        raise TypeError(f"unknown payload {type(p)}")


def import_storage(storage: dict, device) -> dict:
    """Block store of ``ndarray`` blocks keyed ``(base_id, coord)`` ->
    the same store as tensors on ``device`` (each block copied)."""
    device = torch.device(device)
    return {k: torch.tensor(v, device=device) for k, v in storage.items()}


def export_storage(storage: dict) -> dict:
    """Inverse of :func:`import_storage`: every block tensor copied back
    into a host ``ndarray``."""
    return {k: v.cpu().numpy().copy() for k, v in storage.items()}


def _wait_label() -> str:
    """Trace label for a thread blocked on a ticket: ``"main"`` for the
    main thread, a per-thread client label otherwise — concurrent
    waiters must not collide on one wait-span key."""
    t = threading.current_thread()
    if t is threading.main_thread():
        return "main"
    return f"client-{t.ident}"


class FlushTicket:
    """Handle on one (possibly still draining) flush — what
    ``Runtime.flush(wait=False)`` returns instead of joining the
    executor.

    ``wait()`` blocks until the drain completes, merges the drain's
    measured stats into the runtime's accumulated statistics exactly
    once, and returns the flush's stats object; ``done()`` polls.  A
    ticket for a simulated (or empty) flush comes back already
    completed — the API surface is uniform across backends.

    Tickets are thread-safe: with concurrent cone drains (the serving
    runtime), several client threads may wait the same ticket, and the
    runtime's reaper may resolve it first.  Bookkeeping (stats merge,
    ticket-list removal) runs exactly once, on whichever thread resolves
    first; a ticket that failed re-raises its exception on every
    subsequent ``wait()``.

    A ticket may be created *pending* (``pending=True``) before its
    executor future exists: ``Runtime.extract_cone`` hands the ticket
    out while still under the serving record lock, and
    ``Runtime.submit_cone`` later binds the real future (``_bind``) —
    or fails the ticket (``_fail``) — from outside the lock.  Waiters
    that arrive in the window park on an Event until the binding
    resolves, and ``add_done_callback`` queues callbacks until then."""

    __slots__ = ("_rt", "_fut", "_stats", "_resolved", "_tag", "_keys",
                 "_regions", "_exc", "_lock", "_bound", "_callbacks")

    def __init__(self, rt: "Runtime", fut=None, stats=None, tag=None, keys=None,
                 regions=None, pending=False):
        self._rt = rt
        self._fut = fut  # repro_torch.exec Future -> WaitStats, or None
        self._stats = stats  # pre-completed result (sim flush / empty cone)
        self._resolved = fut is None and not pending
        self._tag = tag  # flush id — the trace segment this ticket joins
        # cone access footprint (reads, writes) from cone_access_keys;
        # None = whole-graph flush (conflicts with everything)
        self._keys = keys
        # region-precise footprint (cone_region_footprint), populated
        # only under verify="full" — the race oracle's input
        self._regions = regions
        self._exc: Optional[BaseException] = None
        self._lock = threading.Lock()
        # set once the ticket has either a future or a local resolution;
        # pending tickets (extracted but not yet submitted) leave it clear
        self._bound = threading.Event()
        if fut is not None or not pending:
            self._bound.set()
        self._callbacks: list = []  # queued while pending (unbound)

    def done(self) -> bool:
        return self._resolved or (self._fut is not None and self._fut.done())

    def add_done_callback(self, fn) -> None:
        """Run ``fn(self)`` when the drain resolves (immediately if it
        already has).  Runs on the resolving executor thread — keep it
        short and non-blocking."""
        with self._lock:
            if self._fut is None and not self._resolved:
                self._callbacks.append(fn)  # pending: registered at _bind
                return
            fut = self._fut
        if fut is None:
            fn(self)
        else:
            fut.add_done_callback(lambda _f: fn(self))

    # -- deferred binding (extract_cone / submit_cone split) ---------------
    def _bind(self, fut) -> None:
        """Attach the executor future of a pending ticket (called by
        ``Runtime.submit_cone`` once planning finished off-lock) and
        flush the callbacks queued while unbound."""
        with self._lock:
            self._fut = fut
            cbs = self._callbacks
            self._callbacks = []
        self._bound.set()
        for fn in cbs:
            fut.add_done_callback(lambda _f, fn=fn: fn(self))

    def _resolve_local(self, stats=None) -> None:
        """Resolve a pending ticket without an executor future (empty
        cone, or a simulated cone drain that already ran inline)."""
        with self._lock:
            self._resolved = True
            self._stats = stats
            cbs = self._callbacks
            self._callbacks = []
        self._bound.set()
        self._rt._ticket_discard(self)
        for fn in cbs:
            fn(self)

    def _fail(self, exc: BaseException) -> bool:
        """Fail a still-pending ticket (plan/verify/submit raised before
        a future existed).  No-op — returning False — once a future is
        bound or the ticket resolved: the future's own failure path owns
        the bookkeeping then."""
        with self._lock:
            if self._resolved or self._fut is not None:
                return False
            self._resolved = True
            self._exc = exc
            cbs = self._callbacks
            self._callbacks = []
        self._bound.set()
        self._rt._ticket_failed(self)
        for fn in cbs:
            fn(self)
        return True

    def wait(self, timeout: Optional[float] = None):
        """Block until the drain completes.  Returns the flush's stats
        (a :class:`repro_torch.exec.WaitStats` for async drains, a
        :class:`TimelineResult` for simulated ones, ``None`` when the
        flush had nothing to drain); raises the drain's failure (again,
        on every call — a failed flush stays failed)."""
        with self._lock:
            if self._resolved:
                if self._exc is not None:
                    raise self._exc
                return self._stats
            fut = self._fut
        if fut is None:
            # pending ticket: another thread is still planning/submitting
            # this cone — park until it binds a future or resolves
            if not self._bound.wait(timeout):
                raise TimeoutError(
                    f"flush #{self._tag}: cone still being planned/"
                    f"submitted after {timeout} s"
                )
            with self._lock:
                if self._resolved:
                    if self._exc is not None:
                        raise self._exc
                    return self._stats
                fut = self._fut
        # a thread blocking on a drain is the third wait reason: a
        # barrier (whole-graph flush, or joining a demand-driven cone)
        col = _obs.CURRENT
        span = col is not None and not fut.done()
        label = _wait_label()
        if span:
            col.wait_start(label, "barrier")
        try:
            res = fut.result(timeout)
        except TimeoutError:
            if span:
                col.wait_end(label, "barrier", self._tag)
            raise  # still in flight — the ticket stays waitable
        except BaseException as exc:
            if span:
                col.wait_end(label, "barrier", self._tag)
            with self._lock:
                if not self._resolved:
                    self._resolved = True
                    self._exc = exc
                    self._rt._ticket_failed(self)
            raise
        if span:
            col.wait_end(label, "barrier", self._tag)
        with self._lock:
            if not self._resolved:
                self._resolved = True
                self._stats = res
                self._rt._ticket_done(self, res)
        return res


@dataclass
class PendingFlush:
    """The record-side half of a demand-driven flush, produced by
    :meth:`Runtime.extract_cone` under the caller's record serialization
    and consumed by :meth:`Runtime.submit_cone` *outside* it.

    Everything the plan+submit stage needs is captured here at
    extraction time: the cone's own dependency system (``deps``), its
    access-key footprint (``keys`` — what ``_join_conflicting`` keys
    off), the dead-base set already restricted to bases no remainder
    operation touches, and the flush id.  ``deps is None`` marks an
    empty cone: nothing to drain, but the submit stage must still join
    in-flight writers of the requested blocks (``empty_read`` carries
    the resolved read keys / base ids for that join)."""

    ticket: FlushTicket
    deps: Optional[DependencySystem]
    keys: tuple  # (reads, writes) from cone_access_keys
    dead: set
    fid: Optional[int]
    n_total: int
    empty_read: Optional[tuple] = None  # (read_keys, base_ids), empty cone


class _ConeBatcher:
    """Cross-tenant cone batching: merge several small, mutually
    non-conflicting planned cones arriving from concurrent submitter
    threads into one executor submission (``AsyncExecutor.submit_many``)
    — one global-lock round, one worker wake, one dispatch sweep for
    the whole group instead of per cone.

    Leader/follower: the first thread to enqueue becomes the leader and
    loops submitting whatever has accumulated (up to ``max_batch`` per
    round); threads that enqueue while a leader is active just leave
    their cone in the queue — their ticket is bound to its future by
    whichever leader round picks it up.  Co-queued cones are mutually
    non-conflicting *by construction*: a conflicting later cone blocks
    in ``_join_conflicting`` on the earlier cone's (still unbound)
    ticket before it ever reaches the batcher."""

    __slots__ = ("_rt", "_lock", "_pending", "_leader", "max_batch",
                 "n_batches", "n_merged")

    def __init__(self, rt: "Runtime", max_batch: int = 8):
        self._rt = rt
        self._lock = threading.Lock()
        self._pending: list = []  # (deps, hints, ticket) triples
        self._leader = False
        self.max_batch = max_batch
        self.n_batches = 0
        self.n_merged = 0

    def enqueue(self, deps, hints, ticket) -> None:
        with self._lock:
            self._pending.append((deps, hints, ticket))
            if self._leader:
                return  # the active leader's next round takes it
            self._leader = True
        try:
            while True:
                with self._lock:
                    batch = self._pending[: self.max_batch]
                    del self._pending[: len(batch)]
                    if not batch:
                        self._leader = False
                        return
                    self.n_batches += 1
                    if len(batch) > 1:
                        self.n_merged += len(batch)
                self._rt._submit_batch(batch)
        except BaseException:
            with self._lock:
                leftover = self._pending
                self._pending = []
                self._leader = False
            for _d, _h, t in leftover:
                t._fail(RuntimeError("cone batch submission failed"))
            raise


class ArrayBase:
    """The array-base (paper §5.1): owns the actual memory via the runtime's
    block storage; never manipulated directly by the user."""

    __slots__ = ("id", "shape", "dtype", "layout", "__weakref__")

    def __init__(self, shape, dtype, layout):
        self.id = next(_base_ids)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.layout = layout

    def __repr__(self):
        return f"ArrayBase(id={self.id}, shape={self.shape}, dtype={self.dtype})"


class Runtime:
    """The DistNumPy-style runtime: lazy recording + comm-first flush."""

    def __init__(
        self,
        nprocs: int = 4,
        block_size: Union[int, tuple] = 128,
        mode: str = "latency_hiding",
        cluster: Optional[ClusterSpec] = None,
        flush_threshold: int = 200_000,
        execute: bool = True,
        fusion: bool = False,
        flush_backend: str = "sim",
        exec_backend: str = "torch",
        exec_channel: Optional[str] = None,
        exec_latency: Union[float, str] = 0.0,  # seconds, or "alpha"
        exec_progress_threads: int = 2,
        exec_steal: bool = True,
        exec_steal_threshold: int = 4,
        exec_steal_latency: float = 1e-4,
        passes: Union[str, Sequence[str]] = "auto",
        sync: str = "auto",
        trace: Union[bool, str] = False,
        verify: str = "off",
        plan_cache: Optional[bool] = None,
        batch_cones: bool = False,
        device: Union[str, torch.device, None] = None,
    ):
        # every block and scratch buffer lives on this device; None means
        # the GPU, and there is no fallback to the CPU
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Runtime(device={str(self.device)!r}): no CUDA device is "
                f"visible; pass device='cpu' to run the blocks on the host"
            )
        self.nprocs = nprocs
        self.block_size = block_size
        self.mode = mode
        self.cluster = (cluster or GIGE_2012).with_nprocs(nprocs)
        self.flush_threshold = flush_threshold
        self.execute = execute
        self.fusion = fusion
        if flush_backend not in ("sim", "async"):
            raise ValueError(f"unknown flush_backend {flush_backend!r} (sim|async)")
        if flush_backend == "async" and not execute:
            raise ValueError("flush_backend='async' requires execute=True "
                             "(it runs the real block work)")
        self.flush_backend = flush_backend
        self.exec_backend = exec_backend
        # channel discipline defaults to the runtime mode: latency-hiding
        # uses the non-blocking progress engine, blocking the sync channel
        self.exec_channel = exec_channel or (
            "async" if mode == "latency_hiding" else "blocking"
        )
        # fail at construction, not at the first flush mid-program; names
        # resolve through the plugin registries (repro_torch.api.registry), so a
        # freshly registered scheduler/backend/channel is valid here too
        from repro_torch.api.registry import BACKENDS, CHANNELS, SCHEDULERS

        if mode not in SCHEDULERS:
            raise ValueError(
                f"unknown mode {mode!r} "
                f"(registered schedulers: {', '.join(SCHEDULERS.available())})"
            )
        if flush_backend == "async":
            if isinstance(exec_backend, str) and exec_backend not in BACKENDS:
                raise ValueError(
                    f"unknown exec_backend {exec_backend!r} "
                    f"(registered: {', '.join(BACKENDS.available())})"
                )
            if isinstance(self.exec_channel, str) and self.exec_channel not in CHANNELS:
                raise ValueError(
                    f"unknown exec_channel {self.exec_channel!r} "
                    f"(registered: {', '.join(CHANNELS.available())})"
                )
        if isinstance(exec_latency, str):
            from repro_torch.comm.emulation import resolve_latency

            exec_latency = resolve_latency(exec_latency, self.cluster)
        self.exec_latency = exec_latency
        self.exec_progress_threads = exec_progress_threads
        self.exec_steal = exec_steal
        self.exec_steal_threshold = exec_steal_threshold
        self.exec_steal_latency = exec_steal_latency
        self.exec_stats = None  # WaitStats accumulated across async flushes
        # plan-stage pass pipeline (record -> PLAN -> execute); "auto"
        # resolves per flush backend: the measured executor gets the
        # default optimization pipeline, the simulator stays the paper's
        # unrewritten graphs.  Resolution validates every name against
        # the pass registry, so typos fail here, not at the first flush.
        from .plan import PlanStats, resolve_pipeline

        self.passes = resolve_pipeline(passes, flush_backend)
        self.plan_stats = PlanStats()
        # readback discipline: "demand" drains only the dependency cone of
        # the array being read, "barrier" the whole recorded graph (the
        # paper's §5.6 semantics).  "auto" resolves to demand under the
        # measured async backend and barrier under the simulator, so every
        # paper figure stays bit-identical by default.
        if sync not in ("auto", "demand", "barrier"):
            raise ValueError(f"unknown sync {sync!r} (auto|demand|barrier)")
        self.sync_mode = (
            sync
            if sync != "auto"
            else ("demand" if flush_backend == "async" else "barrier")
        )
        # compute backend + channel + executor persist across flushes
        # (progress threads and the worker pool are expensive to
        # rebuild); created lazily, released by close()
        self._exec_backend_obj = None
        self._exec_channel_obj = None
        self._exec_executor_obj = None
        self._tickets: list[FlushTicket] = []  # outstanding wait=False flushes
        # _tickets is mutated from client threads (ticket bookkeeping runs
        # on whichever thread resolves first under concurrent cone drains)
        self._ticket_lock = threading.Lock()
        # failures first observed by the reaper (no one waited the ticket
        # yet); surfaced — in submission order — at the next full sync
        self._deferred_errors: list[BaseException] = []
        self._closed = False

        self.deps = DependencySystem()
        # Device work the recording side issues outside the executor
        # (scatter, fill, gather) queues under the executor's stream lock,
        # so it never lands inside a gated event pair.  A synchronous copy
        # queued behind a pair's stream gate also blocks the driver calls
        # of the worker that holds the gate, until the gate times out
        # (without this lock, chip_smoke.py phase S counted 439 timeouts
        # in 12681 pairs of 8 concurrent tenants on the H100).
        self._stream_lock = threading.Lock() if self.device.type == "cuda" else None
        # (base_id, coord) -> block tensor on self.device
        self.storage: dict[tuple, torch.Tensor] = {}
        self.scratch: dict[int, torch.Tensor] = {}
        self._xfer_cache: dict[tuple, int] = {}
        self._write_epoch: dict[tuple, int] = {}  # (base_id, coord) -> version
        self._combine_seen: set = set()
        self._dead_bases: set[int] = set()
        self._live_bases: dict[int, bool] = {}
        self.result = TimelineResult(mode=mode, cluster=self.cluster)
        self.flush_count = 0
        self._recorded_since_flush = 0
        self._in_record = 0
        # -- tracing (repro_torch.obs): a policy/kwarg request, or REPRO_TRACE.
        # "1"/"true" enable collection; any other non-"0" value is also an
        # export path written at close().  A trace() context manager active
        # at __enter__ wins: the runtime adopts the ambient collector so
        # one trace can span several runtimes.
        if trace is False or trace is None:
            env = os.environ.get("REPRO_TRACE", "")
            if env not in ("", "0", "false", "False"):
                trace = True if env in ("1", "true", "True") else env
        self.trace_path = trace if isinstance(trace, str) else None
        self._trace_requested = bool(trace)
        self._trace_owned = False
        self._trace_prev = None
        self.tracer = None
        # -- static verification (repro_torch.analysis): a policy/kwarg request,
        # or REPRO_VERIFY=plan|full from the environment (mirrors
        # REPRO_TRACE: the env only applies when the kwarg stayed "off").
        if verify == "off":
            env = os.environ.get("REPRO_VERIFY", "")
            if env not in ("", "0", "off", "false", "False"):
                verify = env
        if verify not in ("off", "plan", "full"):
            raise ValueError(f"unknown verify {verify!r} (off|plan|full)")
        self.verify_mode = verify
        self.verify_stats = None
        self.last_verify_report = None
        if verify != "off":
            from repro_torch.analysis import VerifyStats

            self.verify_stats = VerifyStats()
        # -- plan-shape cache: a cone whose canonical structural signature
        # was planned (and verified) once replays the recorded rewrite
        # recipe instead of re-running the pass pipeline.  Kwarg wins;
        # None defers to REPRO_PLAN_CACHE (default: enabled).
        if plan_cache is None:
            env = os.environ.get("REPRO_PLAN_CACHE", "")
            plan_cache = env not in ("0", "false", "False", "off")
        self.plan_cache_enabled = bool(plan_cache) and bool(self.passes)
        self._plan_cache = None
        if self.plan_cache_enabled:
            from .plan_cache import PlanCache

            self._plan_cache = PlanCache()
        # guards plan_stats / verify_stats / last_verify_report: with the
        # plan stage off the record lock, several submitting threads
        # plan (and verify) concurrently
        self._stats_lock = threading.Lock()
        # guards lazy executor/backend/channel construction (first
        # concurrent submit_cone calls race to build them)
        self._exec_lock = threading.Lock()
        # -- cross-tenant cone batching: merge several small,
        # non-conflicting in-queue cones into one executor submit round
        self.batch_cones = bool(batch_cones)
        self._batcher = (
            _ConeBatcher(self)
            if self.batch_cones and flush_backend == "async"
            else None
        )

    @classmethod
    def from_config(cls, config=None, policy=None) -> "Runtime":
        """Build a Runtime from :class:`~repro_torch.api.config.RuntimeConfig`
        (array layout / recording) and
        :class:`~repro_torch.api.config.ExecutionPolicy` (scheduling /
        backends) — the config-object front door; ``repro_torch.runtime(...)``
        wraps this."""
        from repro_torch.api.config import ExecutionPolicy, RuntimeConfig

        config = config if config is not None else RuntimeConfig()
        policy = policy if policy is not None else ExecutionPolicy()
        return cls(
            nprocs=config.nprocs,
            block_size=config.block_size,
            mode=policy.scheduler,
            cluster=policy.cluster,
            flush_threshold=config.flush_threshold,
            execute=config.execute,
            fusion=config.fusion,
            flush_backend=policy.flush,
            exec_backend=policy.backend,
            exec_channel=policy.resolved_channel,
            exec_latency=policy.latency,
            exec_progress_threads=policy.progress_threads,
            exec_steal=getattr(policy, "steal", True),
            exec_steal_threshold=getattr(policy, "steal_threshold", 4),
            exec_steal_latency=getattr(policy, "steal_latency", 1e-4),
            passes=policy.passes,
            # resolved here so ExecutionPolicy.resolved_sync is the single
            # authority on what "auto" means for the config path
            sync=policy.resolved_sync,
            trace=policy.trace,
            verify=getattr(policy, "verify", "off"),
            plan_cache=getattr(policy, "plan_cache", None),
            batch_cones=getattr(policy, "batch_cones", False),
            device=config.device,
        )

    # -- context management -------------------------------------------------
    def __enter__(self):
        if getattr(_tls, "runtime", None) is not None:
            raise RuntimeError("nested Runtimes are not supported")
        _tls.runtime = self
        if _obs.CURRENT is not None:
            # an ambient repro_torch.trace() region owns the collector; adopt it
            self.tracer = _obs.CURRENT
        elif self._trace_requested:
            self.tracer = _obs.TraceCollector()
            self._trace_prev = _obs.activate(self.tracer)
            self._trace_owned = True
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self.flush()  # §5.6 trigger 3: end of program (a barrier)
        finally:
            _tls.runtime = None
            if exc_type is None:
                self.close()  # surfaces any un-delivered drain failure
            else:
                try:
                    self.close()
                except Exception:
                    # the body's exception is the one that matters;
                    # resources were still released
                    pass
        return False

    def close(self) -> None:
        """Release executor resources: join *all* outstanding
        ``FlushTicket``s in submission order, stop the persistent worker
        pool, and shut down the channel's progress threads.  The first
        executor exception encountered while joining — including
        failures parked by the reaper that no waiter ever observed — is
        re-raised *after* every resource is released: a close must not
        silently drop a drain failure.  ``__exit__`` calls this on both
        the clean and the exception path; double-close is a no-op."""
        if self._closed:
            return
        err: Optional[BaseException] = None
        try:
            try:
                self._sync_outstanding()
            except BaseException as exc:
                # a pool-level failure already dropped its executor; the
                # resource release below must still happen before the
                # failure surfaces
                err = exc
        finally:
            self._closed = True
            if self._exec_executor_obj is not None:
                self._exec_executor_obj.close()
                self._exec_executor_obj = None
            if self._exec_channel_obj is not None:
                self._exec_channel_obj.close()
                self._exec_channel_obj = None
                self._exec_backend_obj = None
            if self._trace_owned:
                _obs.deactivate(self._trace_prev)
                self._trace_owned = False
                if self.trace_path and self.tracer is not None:
                    from repro_torch.obs.export import export_trace

                    export_trace(self.tracer, self.trace_path)
        if err is not None:
            raise err

    # -- array creation -------------------------------------------------------
    def _make_layout(self, shape, block_shape=None) -> Layout:
        nd = len(shape)
        if block_shape is None:
            bs = self.block_size
            if isinstance(bs, int):
                block_shape = tuple(max(1, min(bs, s)) for s in shape)
            else:
                block_shape = tuple(
                    max(1, min(b, s)) for b, s in zip(bs, shape)
                )
        # grid-aware process grid: assign process factors to the dims with
        # the most blocks (a [n,1] vector gets pgrid (p,1), not (√p,√p))
        grid = [max(1, -(-s // b)) for s, b in zip(shape, block_shape)]
        pgrid = [1] * nd
        n = self.nprocs
        factors = []
        f = 2
        while f * f <= n:
            while n % f == 0:
                factors.append(f)
                n //= f
            f += 1
        if n > 1:
            factors.append(n)
        if nd:
            for f in sorted(factors, reverse=True):
                i = max(range(nd), key=lambda d: grid[d] / pgrid[d])
                pgrid[i] *= f
        return Layout(tuple(shape), tuple(block_shape), tuple(pgrid))

    def new_base(self, shape, dtype, block_shape=None) -> ArrayBase:
        base = ArrayBase(shape, dtype, self._make_layout(shape, block_shape))
        self._live_bases[base.id] = True
        weakref.finalize(base, self._dead_bases.add, base.id)
        return base

    def scatter(self, base: ArrayBase, data: np.ndarray) -> None:
        """Distribute host data into base-blocks on the runtime's device
        (eager, creation time)."""
        data = np.asarray(data, dtype=base.dtype).reshape(base.shape)
        for coord, sl in base.layout.blocks():
            with self._device_work():
                self.storage[(base.id, coord)] = torch.tensor(
                    data[sl], device=self.device
                )

    def fill_base(self, base: ArrayBase, value) -> None:
        dtype = to_torch_dtype(base.dtype)
        if isinstance(value, np.generic):
            value = value.item()
        for coord, _ in base.layout.blocks():
            with self._device_work():
                self.storage[(base.id, coord)] = torch.full(
                    base.layout.block_shape_at(coord), value, dtype=dtype,
                    device=self.device,
                )

    def _device_work(self):
        """The lock host-side device work outside the executor takes
        (``_stream_lock``; none on the CPU)."""
        lock = self._stream_lock
        return lock if lock is not None else contextlib.nullcontext()

    def gather(self, base: ArrayBase, view: ViewSpec) -> np.ndarray:
        """Read back a view (flushes first — §5.6 trigger 1).

        Under ``sync="demand"`` only the dependency cone of the blocks
        ``view`` touches is drained — the transitive producer closure of
        their pending writes — and everything else stays recorded; under
        ``sync="barrier"`` the whole graph is drained (the paper's
        original semantics)."""
        spec = OperandSpec(view, base.layout, tuple(range(view.ndim)))
        if self.sync_mode == "demand":
            keys = {
                (base.id, frag.block)
                for _, (frag,) in fragment_iteration_space(view.vshape, (spec,))
            }
            self.flush(targets=keys)
        else:
            self.flush()
        out = np.empty(view.vshape, dtype=base.dtype)
        for vint, (frag,) in fragment_iteration_space(view.vshape, (spec,)):
            dst = tuple(slice(lo, hi) for lo, hi in vint)
            blk = self.storage.get((base.id, frag.block))
            if blk is None:
                raise RuntimeError(
                    f"array base {base.id} has no block storage — its blocks "
                    f"were purged after every owning array was garbage-"
                    f"collected; keep a reference to the DistArray (or its "
                    f"ArrayFuture) until readback"
                )
            with self._device_work():
                out[dst] = blk[frag.slices].cpu().numpy()
        return out

    # -- recording ------------------------------------------------------------
    def _write_version(self, base_id: int, coord: tuple) -> int:
        return self._write_epoch.get((base_id, coord), 0)

    def _bump_write(self, base_id: int, coord: tuple) -> None:
        k = (base_id, coord)
        self._write_epoch[k] = self._write_epoch.get(k, 0) + 1

    def _transfer(self, base: ArrayBase, frag: Fragment, dst_proc: int) -> int:
        """Record (dedup'd) communication of one sub-view-block to
        ``dst_proc``; returns the scratch id the data will land in."""
        key = (
            base.id,
            frag.block,
            frag.local,
            dst_proc,
            self._write_version(base.id, frag.block),
        )
        sid = self._xfer_cache.get(key)
        if sid is not None:
            return sid
        sid = next(_scratch_ids)
        self._xfer_cache[key] = sid
        nbytes = frag.size * base.dtype.itemsize
        op = OperationNode(
            COMM,
            TransferPayload(("b", base.id, frag), sid),
            procs=(frag.owner, dst_proc),
            nbytes=nbytes,
            label=f"xfer b{base.id}{frag.block}->p{dst_proc}",
        )
        op.add_access(AccessNode((base.id, frag.block), frag.region, write=False))
        op.add_access(AccessNode(("s", sid), None, write=True))
        self.deps.insert(op)
        return sid

    def _transfer_scratch(self, sid_src: int, nbytes: int, src: int, dst: int) -> int:
        sid = next(_scratch_ids)
        op = OperationNode(
            COMM,
            TransferPayload(("s", sid_src), sid),
            procs=(src, dst),
            nbytes=nbytes,
            label=f"xfer s{sid_src}->p{dst}",
        )
        op.add_access(AccessNode(("s", sid_src), None, write=False))
        op.add_access(AccessNode(("s", sid), None, write=True))
        self.deps.insert(op)
        return sid

    def _insert_compute(self, payload, out_base, out_frag, reads, cost, label=""):
        op = OperationNode(
            COMPUTE, payload, procs=(out_frag.owner,), cost=cost, label=label
        )
        op.add_access(
            AccessNode((out_base.id, out_frag.block), out_frag.region, write=True)
        )
        for ref in reads:
            kind = ref[0]
            if kind == "b":
                _, bid, frag = ref
                op.add_access(AccessNode((bid, frag.block), frag.region, write=False))
            elif kind == "s":
                op.add_access(AccessNode(("s", ref[1]), None, write=False))
        self.deps.insert(op)
        self._bump_write(out_base.id, out_frag.block)
        self._recorded_since_flush += 1

    def _maybe_flush(self) -> None:
        if self._in_record == 0 and self._recorded_since_flush >= self.flush_threshold:
            # §5.6 trigger 2: threshold.  A demand-driven async runtime
            # kicks the drain off WITHOUT joining it — communication is
            # initiated as aggressively as possible while the main thread
            # keeps recording (the paper's motivation, on real threads).
            if self.sync_mode == "demand" and self.flush_backend == "async":
                self.flush(wait=False)
            else:
                self.flush()

    def record_map(
        self,
        ufunc: UFunc,
        out,  # (ArrayBase, ViewSpec)
        inputs: Sequence,  # list of (ArrayBase, ViewSpec) or ("c", scalar)
    ) -> None:
        """Record an elementwise ufunc over equally-shaped views (with
        numpy-style length-1 broadcasting)."""
        self._in_record += 1
        try:
            self._record_map(ufunc, out, inputs)
        finally:
            self._in_record -= 1
        self._maybe_flush()

    def _record_map(self, ufunc, out, inputs) -> None:
        out_base, out_view = out
        nd = out_view.ndim
        dims = tuple(range(nd))
        specs = [OperandSpec(out_view, out_base.layout, dims)]
        arr_inputs = []
        for inp in inputs:
            if isinstance(inp, tuple) and inp and inp[0] == "c":
                arr_inputs.append(None)
            else:
                b, v = inp
                specs.append(OperandSpec(v, b.layout, dims))
                arr_inputs.append((b, v))
        frags_all = fragment_iteration_space(out_view.vshape, specs)
        for vint, frags in frags_all:
            out_frag = frags[0]
            dst = out_frag.owner
            args = []
            reads = []
            fi = 1
            for inp, orig in zip(arr_inputs, inputs):
                if inp is None:
                    args.append(("c", orig[1]))
                    continue
                b, _ = inp
                frag = frags[fi]
                fi += 1
                if frag.owner != dst:
                    sid = self._transfer(b, frag, dst)
                    ref = ("s", sid)
                else:
                    ref = ("b", b.id, frag)
                args.append(ref)
                reads.append(ref)
            size = out_frag.size
            payload = MapPayload(ufunc, out_base.id, out_frag, tuple(args), out_base.dtype)
            cost = size * ufunc.cost * self.cluster.elem_time
            self._insert_compute(
                payload, out_base, out_frag, reads, cost, label=f"map:{ufunc.name}"
            )

    def record_fill(self, out, value) -> None:
        out_base, out_view = out
        dims = tuple(range(out_view.ndim))
        spec = OperandSpec(out_view, out_base.layout, dims)
        for _, (frag,) in fragment_iteration_space(out_view.vshape, (spec,)):
            payload = FillPayload(out_base.id, frag, value)
            cost = frag.size * self.cluster.elem_time
            self._insert_compute(payload, out_base, frag, (), cost, label="fill")
        self._maybe_flush()

    def record_reduce(
        self, ufunc_name: str, out, inp, axes: tuple[int, ...], keepdims: bool = False
    ) -> None:
        """Record ``out = reduce(ufunc, inp, axes)``; ``out``'s dims are
        ``inp``'s dims with ``axes`` removed (or kept as length-1 when
        ``keepdims``)."""
        self._in_record += 1
        try:
            self._record_reduce(ufunc_name, out, inp, axes, keepdims)
        finally:
            self._in_record -= 1
        self._maybe_flush()

    def _record_reduce(self, ufunc_name, out, inp, axes, keepdims) -> None:
        in_base, in_view = inp
        out_base, out_view = out
        nd = in_view.ndim
        kept = tuple(d for d in range(nd) if d not in axes)
        out_dims = tuple(range(nd)) if keepdims else kept
        specs = (
            OperandSpec(in_view, in_base.layout, tuple(range(nd))),
            OperandSpec(out_view, out_base.layout, out_dims),
        )
        for vint, (in_frag, out_frag) in fragment_iteration_space(
            in_view.vshape, specs
        ):
            src_owner = in_frag.owner
            dst_owner = out_frag.owner
            # stage 1: partial reduce at the data's owner
            sid = next(_scratch_ids)
            p1 = ReducePartialPayload(
                ufunc_name, ("b", in_base.id, in_frag), axes, sid, keepdims
            )
            op = OperationNode(
                COMPUTE,
                p1,
                procs=(src_owner,),
                cost=in_frag.size * self.cluster.elem_time,
                label=f"reduce:{ufunc_name}",
            )
            op.add_access(
                AccessNode((in_base.id, in_frag.block), in_frag.region, write=False)
            )
            op.add_access(AccessNode(("s", sid), None, write=True))
            self.deps.insert(op)
            # stage 2: ship the partial if needed
            if src_owner != dst_owner:
                nbytes = out_frag.size * out_base.dtype.itemsize
                sid = self._transfer_scratch(sid, nbytes, src_owner, dst_owner)
            # stage 3: combine into the output fragment
            ckey = (out_base.id, out_frag.block, out_frag.region)
            init = ckey not in self._combine_seen
            self._combine_seen.add(ckey)
            p3 = CombinePayload(ufunc_name, out_base.id, out_frag, sid, init)
            self._insert_compute(
                p3,
                out_base,
                out_frag,
                (("s", sid),),
                out_frag.size * self.cluster.elem_time,
                label=f"combine:{ufunc_name}",
            )

    def record_matmul(self, out, a, b, trans_a=False, trans_b=False) -> None:
        """Blocked matmul C[m,n] = Σ_k A[m,k]·B[k,n] (SUMMA-style: operand
        blocks are communicated to the owner of the output block, dedup'd
        per destination — paper §6.1.1)."""
        self._in_record += 1
        try:
            self._record_matmul(out, a, b, trans_a, trans_b)
        finally:
            self._in_record -= 1
        self._maybe_flush()

    def _record_matmul(self, out, a, b, trans_a, trans_b) -> None:
        out_base, out_view = out
        a_base, a_view = a
        b_base, b_view = b
        M, N = out_view.vshape
        K = a_view.vshape[0 if trans_a else 1]
        a_dims = (2, 0) if trans_a else (0, 2)
        b_dims = (1, 2) if trans_b else (2, 1)
        specs = (
            OperandSpec(out_view, out_base.layout, (0, 1)),
            OperandSpec(a_view, a_base.layout, a_dims),
            OperandSpec(b_view, b_base.layout, b_dims),
        )
        for vint, (c_frag, a_frag, b_frag) in fragment_iteration_space(
            (M, N, K), specs
        ):
            dst = c_frag.owner
            refs = []
            for base, frag in ((a_base, a_frag), (b_base, b_frag)):
                if frag.owner != dst:
                    refs.append(("s", self._transfer(base, frag, dst)))
                else:
                    refs.append(("b", base.id, frag))
            ckey = (out_base.id, c_frag.block, c_frag.region, "mm")
            init = ckey not in self._combine_seen
            self._combine_seen.add(ckey)
            m, n = (vint[0][1] - vint[0][0]), (vint[1][1] - vint[1][0])
            k = vint[2][1] - vint[2][0]
            payload = MatmulPayload(
                out_base.id, c_frag, refs[0], refs[1], trans_a, trans_b, init
            )
            cost = 2.0 * m * n * k * self.cluster.flop_time
            self._insert_compute(
                payload, out_base, c_frag, refs, cost, label="matmul"
            )

    # -- execution backend ------------------------------------------------
    def _resolve(self, ref):
        return resolve_ref(ref, self.storage, self.scratch)

    def _execute(self, op: OperationNode) -> None:
        execute_payload(op.payload, self.storage, self.scratch)

    # -- flush (§5.6 record -> plan -> §5.7 execute) --------------------------
    def flush(self, wait: bool = True, targets=None):
        """Drain recorded operations — all of them, or just the
        dependency cone of ``targets``.

        ``targets`` (``None`` = whole graph) is an iterable of
        DistArrays / ArrayBases / base ids: only the transitive producer
        closure of their pending writes
        (:func:`repro_torch.core.graph.producer_cone`) is extracted,
        re-inserted via ``DependencySystem.rebuild``, planned, and
        drained; the rest of the recorded graph stays pending.

        ``wait=True`` blocks until the drain completes and returns the
        per-flush stats object (:class:`TimelineResult` under the
        simulated backend, :class:`repro_torch.exec.WaitStats` under the async
        one, ``None`` when nothing had to be drained).  ``wait=False``
        submits the drain to the persistent executor and returns a
        :class:`FlushTicket` immediately, so recording continues on the
        main thread while workers drain and communication overlaps with
        Python-side recording (under the simulated backend the drain is
        synchronous and the ticket comes back completed).

        ``flush`` is *re-entrant with respect to in-flight drains*: a
        cone flush joins only the outstanding tickets whose access
        footprints **conflict** with the new cone
        (:func:`repro_torch.core.graph.cones_conflict`); disjoint cones drain
        concurrently on the shared worker pool.  A whole-graph flush
        (``targets=None``) is a barrier — it joins every outstanding
        ticket first.  Calls to ``flush`` itself must be externally
        serialized (recording is single-threaded; the serve layer's
        record lock guarantees this).

        A cone flush is the :meth:`extract_cone` + :meth:`submit_cone`
        pair run back to back: record-side extraction (which must stay
        under the caller's record serialization) followed by
        plan + executor submission (which does not — the serve
        layer calls the two halves separately, so planning runs off the
        record lock).

        The flush remains a three-stage pipeline: the (cone of the)
        *recorded* graph goes through the *plan* stage
        (:func:`repro_torch.core.plan.plan` runs the configured pass pipeline
        on the cone only), then the planned graph is *executed* by the
        scheduler or the async executor."""
        if self._closed:
            raise RuntimeError("Runtime is closed")
        if targets is not None:
            handle = self.extract_cone(targets)
            ticket = self.submit_cone(handle, cleanup=True)
            if wait:
                res = ticket.wait()
                self._barrier_cleanup()
                return res
            return ticket
        self._sync_outstanding()  # a barrier: join every drain
        deps = self.deps
        dead = set(self._dead_bases)
        n_total = deps.n_pending
        if deps.n_pending == 0:
            self._barrier_cleanup()
            return None if wait else FlushTicket(self)
        self.deps = DependencySystem()  # recording continues here
        fid = self.flush_count + 1
        col = _obs.CURRENT
        if col is not None:
            col.flush_begin(
                fid, n_total, deps.n_pending, self.sync_mode, self.flush_backend
            )
            col.counter("cone-ops", deps.n_pending)
        hints = {}
        if self.passes:
            from .plan import plan as run_plan

            pre_views = None
            if self.verify_mode != "off":
                # snapshot footprints BEFORE planning: passes rewrite
                # payloads/accesses in place (fill→map const folding), so
                # the pre-plan op objects are not a record of the pre-plan
                # program — immutable OpViews are
                from repro_torch.analysis import snapshot_ops

                _t0 = _time.perf_counter()
                pre_views = snapshot_ops(deps.pending_ops())
                with self._stats_lock:
                    self.verify_stats.verify_seconds += (
                        _time.perf_counter() - _t0
                    )
            planned = run_plan(
                deps,
                self.passes,
                dead_bases=dead,
                storage=self.storage,
            )
            deps = planned.deps
            hints = planned.hints
            with self._stats_lock:
                self.plan_stats.merge(planned.stats)
            if pre_views is not None:
                self._verify_plan(pre_views, planned, dead)
        self.flush_count += 1
        self._recorded_since_flush = self.deps.n_pending
        if self.flush_backend == "async":
            ticket = self._flush_async(deps, hints, fid, keys=None,
                                       regions=None)
            if wait:
                res = ticket.wait()
                self._barrier_cleanup()
                return res
            with self._ticket_lock:
                self._tickets.append(ticket)
            return ticket
        from repro_torch.api.registry import get_scheduler

        if col is not None:
            col.drain_begin(fid, deps.n_pending, self.nprocs)
        res = get_scheduler(self.mode)(
            deps,
            self.cluster,
            executor=self._execute if self.execute else None,
        )
        if col is not None:
            col.drain_end(fid)
        self.result.merge(res)
        self._barrier_cleanup()
        return res if wait else FlushTicket(self, stats=res)

    # -- the record/plan split (cone flushes) -------------------------------
    def extract_cone(self, targets) -> PendingFlush:
        """Record-side half of a cone flush: split the recorded graph
        into the dependency cone of ``targets`` and the remainder, and
        return a :class:`PendingFlush` whose (still pending) ticket is
        already registered with the runtime.

        This is the only part of a cone flush that reads or writes
        recording state (``self.deps``, the dead-base set, the flush
        counter), so it is the only part that must run under the
        caller's record serialization — the serve layer holds its
        record lock exactly across this call and releases it before
        :meth:`submit_cone` plans and submits the cone."""
        if self._closed:
            raise RuntimeError("Runtime is closed")
        from .graph import cone_access_keys

        self._reap_tickets()  # fold finished drains' stats, keep going
        resolved = self._resolve_targets(targets)
        dead = set(self._dead_bases)
        n_total = self.deps.n_pending
        cone_ops, rest_ops = producer_cone(self.deps.pending_ops(), resolved)
        # even an empty cone must serialize against in-flight writes
        # to the requested blocks: the caller is about to *read* them
        keys = cone_access_keys(cone_ops)
        if not cone_ops:
            read_keys = {k for k in resolved if isinstance(k, tuple)}
            ids = {k for k in resolved if not isinstance(k, tuple)}
            return PendingFlush(
                ticket=FlushTicket(self, pending=True),
                deps=None,
                keys=keys,
                dead=set(),
                fid=None,
                n_total=n_total,
                empty_read=(read_keys, ids),
            )
        regions = None
        if self.verify_mode == "full":
            # region-level race oracle against the in-flight drains,
            # BEFORE the extraction commits: a failure aborts the flush
            # with the recorded graph and every in-flight drain
            # untouched.  It stays under the caller's record
            # serialization because "in-flight" is defined by extraction
            # order — and it stamps the regions on the pending ticket,
            # so later extractions can race-check against this cone
            # while it is still being planned off the lock.
            from .graph import cone_region_footprint

            _t0 = _time.perf_counter()
            regions = cone_region_footprint(cone_ops)
            self._verify_races(keys, regions)
            with self._stats_lock:
                self.verify_stats.verify_seconds += (
                    _time.perf_counter() - _t0
                )
        # a GC'd base only licenses dead-store elimination when no
        # *remainder* operation still touches it: the cone may hold a
        # dead temp's producer (pulled in as an anti-dependency) while
        # its consumer stays pending — that store is NOT dead yet
        dead -= {acc.key[0] for op in rest_ops for acc in op.accesses}
        self.deps = DependencySystem.rebuild(rest_ops)
        cone_deps = DependencySystem.rebuild(cone_ops)
        self.flush_count += 1
        fid = self.flush_count
        self._recorded_since_flush = self.deps.n_pending
        # the pending ticket joins the outstanding list NOW, before the
        # record serialization is released: a later cone that conflicts
        # with this one must find it and wait, even though its future
        # does not exist yet (extraction order is the total order
        # _join_conflicting's `before=` bound keys off)
        ticket = FlushTicket(self, pending=True, tag=fid, keys=keys,
                             regions=regions)
        with self._ticket_lock:
            self._tickets.append(ticket)
        col = _obs.CURRENT
        if col is not None:
            col.flush_begin(
                fid, n_total, cone_deps.n_pending, self.sync_mode,
                self.flush_backend,
            )
            col.counter("cone-ops", cone_deps.n_pending)
        return PendingFlush(
            ticket=ticket,
            deps=cone_deps,
            keys=keys,
            dead=dead,
            fid=fid,
            n_total=n_total,
        )

    def submit_cone(self, handle: PendingFlush, cleanup: bool = False) -> FlushTicket:
        """Plan, verify, and submit an extracted cone — the half of a
        cone flush that needs **no** record serialization: it touches
        only the :class:`PendingFlush`'s own state plus thread-safe
        runtime structures, so concurrent client threads may plan and
        submit their cones in parallel.

        Any failure (verification, planning, executor submission) fails
        the handle's ticket — waiters and done-callbacks observe it —
        and re-raises on this thread.  ``cleanup=True`` additionally
        runs barrier housekeeping on the inline paths (empty cone /
        simulated drain); callers running off the record lock must
        leave it False, since scratch recycling races with concurrent
        recording."""
        ticket = handle.ticket
        try:
            self._submit_cone_inner(handle, cleanup)
        except BaseException as exc:
            ticket._fail(exc)
            raise
        return ticket

    def _submit_cone_inner(self, handle: PendingFlush, cleanup: bool) -> None:
        ticket = handle.ticket
        if handle.deps is None:  # empty cone: join in-flight writers only
            read_keys, ids = handle.empty_read
            self._join_conflicting((read_keys, set()), base_ids=ids)
            if cleanup:
                self._barrier_cleanup()
            ticket._resolve_local()
            return
        deps = handle.deps
        # (verify="full"'s race oracle already ran in extract_cone,
        # under the record serialization that defines "in-flight")
        self._join_conflicting(handle.keys, before=ticket)
        deps, hints = self._plan_cone(handle)
        if self.flush_backend == "async":
            if self._batcher is not None:
                self._batcher.enqueue(deps, hints, ticket)
            else:
                executor = self._ensure_executor()
                fut = executor.submit(
                    deps,
                    batch_dispatch=bool(hints.get("batch_dispatch")),
                    tag=handle.fid,
                )
                ticket._bind(fut)
            return
        # simulated backend (sync="demand" with flush_backend="sim"):
        # the drain runs inline on this thread, as before the split
        from repro_torch.api.registry import get_scheduler

        col = _obs.CURRENT
        if col is not None:
            col.drain_begin(handle.fid, deps.n_pending, self.nprocs)
        res = get_scheduler(self.mode)(
            deps,
            self.cluster,
            executor=self._execute if self.execute else None,
        )
        if col is not None:
            col.drain_end(handle.fid)
        self.result.merge(res)
        if cleanup:
            ticket._resolve_local(res)
            self._barrier_cleanup()
        else:
            ticket._resolve_local(res)

    def _plan_cone(self, handle: PendingFlush):
        """Plan stage of one extracted cone: plan-shape cache hit →
        replay the recorded rewrite recipe; miss → run the pass
        pipeline, verify, and insert the recipe.  Returns the planned
        ``(deps, hints)``.  Thread-safe: shared counters are folded
        under ``_stats_lock``, the cache locks internally."""
        deps = handle.deps
        if not self.passes:
            return deps, {}
        from .plan import plan as run_plan

        pending = deps.pending_ops()
        cache = self._plan_cache
        col = _obs.CURRENT
        sig = None
        if cache is not None:
            sig = cache.signature(pending, handle.dead, self.passes,
                                  self.storage)
            if sig is not None:
                entry = cache.lookup(sig)
                if entry is not None:
                    if col is not None:
                        col.plan_cache(handle.fid, True, len(pending))
                    new_deps, hints, stats = cache.replay(
                        entry, deps, pending
                    )
                    with self._stats_lock:
                        self.plan_stats.merge(stats)
                    return new_deps, hints
            if col is not None:
                col.plan_cache(handle.fid, False, len(pending))
        pre_views = None
        if self.verify_mode != "off" or sig is not None:
            # snapshot footprints BEFORE planning: passes rewrite
            # payloads/accesses in place, so the pre-plan op objects are
            # not a record of the pre-plan program — immutable OpViews
            # are.  The cache needs the same snapshot: a cached plan
            # must stay re-verifiable on demand (verify_cached_plans).
            from repro_torch.analysis import snapshot_ops

            _t0 = _time.perf_counter()
            pre_views = snapshot_ops(pending)
            if self.verify_mode != "off":
                with self._stats_lock:
                    self.verify_stats.verify_seconds += (
                        _time.perf_counter() - _t0
                    )
        pre_args = None
        if sig is not None:
            # pre-plan map argument tuples: const folding mutates
            # MapPayload.args in place, so the diff against these is the
            # recipe's patch list
            pre_args = {
                op.uid: op.payload.args
                for op in pending
                if isinstance(op.payload, MapPayload)
            }
        planned = run_plan(
            deps, self.passes, dead_bases=handle.dead, storage=self.storage
        )
        with self._stats_lock:
            self.plan_stats.merge(planned.stats)
        if self.verify_mode != "off":
            self._verify_plan(pre_views, planned, handle.dead)
        if sig is not None:
            cache.insert(
                sig,
                pending,
                pre_args,
                planned,
                handle.dead,
                pre_views=pre_views,
                scratch_available=set(self.scratch),
            )
        return planned.deps, planned.hints

    def verify_cached_plans(self):
        """Re-run the static plan verifier over every resident
        plan-cache entry (each was verified — or at least verifiable —
        once at insert; this proves the cached recipes are *still*
        sound on demand, e.g. from the ``graph-lint`` CI job).  Returns
        the list of :class:`repro_torch.analysis.AnalysisReport`; raises
        :class:`repro_torch.analysis.VerificationError` on any error-severity
        finding."""
        if self._plan_cache is None:
            return []
        from repro_torch.analysis import check_cached_plans

        reports = check_cached_plans(self._plan_cache)
        for r in reports:
            r.raise_if_errors()
        return reports

    @staticmethod
    def _resolve_targets(targets) -> set:
        """Normalize flush targets to the mixed set
        :func:`~repro_torch.core.graph.producer_cone` takes: base ids (ints —
        every block of that base) and/or exact ``(base_id, block)``
        keys.  A DistArray contributes only the block keys its *view*
        touches, so reading a sub-view forces a sub-cone."""
        ids = set()
        for t in targets:
            if isinstance(t, (int, np.integer)):
                ids.add(int(t))
            elif isinstance(t, tuple):
                ids.add(t)  # explicit (base_id, block) access key
            elif isinstance(t, ArrayBase):
                ids.add(t.id)
            else:
                base = getattr(t, "_base", None)  # DistArray, duck-typed
                view = getattr(t, "_view", None)
                if not isinstance(base, ArrayBase):
                    raise TypeError(
                        f"cannot flush towards {type(t).__name__}: expected a "
                        f"DistArray, an ArrayBase, a base id, or a "
                        f"(base_id, block) key"
                    )
                spec = OperandSpec(view, base.layout, tuple(range(view.ndim)))
                for _, (frag,) in fragment_iteration_space(
                    view.vshape, (spec,)
                ):
                    ids.add((base.id, frag.block))
        return ids

    def _flush_async(self, deps, hints, tag=None, keys=None,
                     regions=None) -> FlushTicket:
        """Submit ``deps`` to the persistent multi-worker executor
        (repro_torch.exec) and return the in-flight ticket without joining."""
        executor = self._ensure_executor()
        fut = executor.submit(
            deps, batch_dispatch=bool(hints.get("batch_dispatch")), tag=tag
        )
        return FlushTicket(self, fut=fut, tag=tag, keys=keys, regions=regions)

    def _submit_batch(self, batch) -> None:
        """Submit one batcher round — ``(deps, hints, ticket)`` triples
        of mutually non-conflicting planned cones — to the executor and
        bind each ticket to its future.  A single cone goes through the
        plain ``submit`` path; several go through ``submit_many`` (one
        global-lock round for the group).  On failure every ticket in
        the round is failed before re-raising."""
        try:
            executor = self._ensure_executor()
            if len(batch) == 1:
                deps, hints, ticket = batch[0]
                fut = executor.submit(
                    deps,
                    batch_dispatch=bool(hints.get("batch_dispatch")),
                    tag=ticket._tag,
                )
                ticket._bind(fut)
                return
            items = [(deps, ticket._tag) for deps, _h, ticket in batch]
            bd = any(bool(h.get("batch_dispatch")) for _d, h, _t in batch)
            futs = executor.submit_many(items, batch_dispatch=bd)
            for (_d, _h, ticket), fut in zip(batch, futs):
                ticket._bind(fut)
        except BaseException as exc:
            for _d, _h, ticket in batch:
                ticket._fail(exc)
            raise

    def _ensure_executor(self):
        from repro_torch.exec import AsyncExecutor, make_backend, make_channel

        with self._exec_lock:
            return self._ensure_executor_locked(
                AsyncExecutor, make_backend, make_channel
            )

    def _ensure_executor_locked(self, AsyncExecutor, make_backend,
                                make_channel):
        if self._exec_backend_obj is None:
            self._exec_backend_obj = make_backend(
                self.exec_backend, self.storage, self.scratch
            )
            self._exec_channel_obj = make_channel(
                self.exec_channel,
                latency=self.exec_latency,
                progress_threads=self.exec_progress_threads,
            )
        if self._exec_executor_obj is None:
            self._exec_executor_obj = AsyncExecutor(
                nworkers=self.nprocs,
                storage=self.storage,
                scratch=self.scratch,
                backend=self._exec_backend_obj,
                channel=self._exec_channel_obj,
                steal=self.exec_steal,
                steal_threshold=self.exec_steal_threshold,
                steal_latency=self.exec_steal_latency,
                device=self.device,
                stream_lock=self._stream_lock,
            )
        return self._exec_executor_obj

    # -- ticket bookkeeping -------------------------------------------------
    def _sync_outstanding(self) -> None:
        """Join *every* outstanding ``wait=False`` flush in submission
        order, merging stats.  Raises the first failure — deferred
        errors (observed by the reaper with no waiter) first, then the
        first failing join — after all tickets resolved: a barrier must
        never silently drop an executor exception."""
        errors: list[BaseException]
        with self._ticket_lock:
            errors = self._deferred_errors
            self._deferred_errors = []
        while True:
            with self._ticket_lock:
                t = self._tickets[0] if self._tickets else None
            if t is None:
                break
            try:
                t.wait()
            except BaseException as exc:
                errors.append(exc)
        if errors:
            raise errors[0]

    def _reap_tickets(self) -> None:
        """Fold the stats of already-completed tickets without blocking
        on the in-flight ones.  A completed-failed ticket nobody waited
        yet parks its error in ``_deferred_errors`` — surfaced at the
        next barrier (``_sync_outstanding``) — while the ticket itself
        keeps re-raising to any late waiter."""
        with self._ticket_lock:
            done = [t for t in self._tickets if t.done()]
        for t in done:
            try:
                t.wait()
            except BaseException as exc:
                with self._ticket_lock:
                    self._deferred_errors.append(exc)

    def _join_conflicting(self, keys, base_ids=None, before=None) -> None:
        """Join every outstanding ticket whose cone footprint conflicts
        with ``keys`` (``(reads, writes)``); tickets with no footprint
        (whole-graph flushes) conflict with everything.  ``base_ids``
        extends the read set to *all* blocks of the given bases (a
        whole-base readback with nothing pending must still wait for
        in-flight writers of any of its blocks).

        ``before`` bounds the scan at the caller's own (still pending)
        ticket: with planning off the record lock, several threads join
        concurrently, and each may only wait on tickets *extracted
        earlier* than its own — extraction order is a total order, so
        waiting only backwards keeps the wait graph acyclic."""
        from .graph import cones_conflict

        def _conflicts(t: FlushTicket) -> bool:
            if t._keys is None:
                return True
            if cones_conflict(t._keys, keys):
                return True
            if base_ids:
                _, tw = t._keys
                if any(k[0] in base_ids for k in tw if isinstance(k, tuple)):
                    return True
            return False

        while True:
            with self._ticket_lock:
                t = None
                for cand in self._tickets:
                    if cand is before:
                        break
                    if _conflicts(cand):
                        t = cand
                        break
            if t is None:
                return
            t.wait()  # propagates the conflicting drain's failure

    # -- static verification (repro_torch.analysis) -------------------------
    def _verify_plan(self, pre_views, planned, dead) -> None:
        """verify="plan"/"full": prove the planned op list preserves the
        recorded happens-before order before it reaches the executor.
        Raises :class:`repro_torch.analysis.VerificationError` on any
        error-severity finding — the flush aborts with nothing executed
        (the cone was already extracted from the recorded graph, so the
        runtime is not usable for further flushes after the raise;
        verification failures are fatal by design)."""
        from repro_torch.analysis import check

        _t0 = _time.perf_counter()
        report = check(
            pre=pre_views,
            post=planned.deps.pending_ops(),
            dead_bases=dead,
            provenance=planned.provenance,
            dropped=planned.dropped,
            scratch_available=set(self.scratch),
            rules=("plan", "deadlock"),
        )
        with self._stats_lock:
            stats = self.verify_stats
            stats.verify_seconds += _time.perf_counter() - _t0
            stats.n_flushes_verified += 1
            stats.n_diagnostics += len(report.diagnostics)
            self.last_verify_report = report
        report.raise_if_errors()

    def _verify_races(self, keys, regions) -> None:
        """verify="full": the region-level soundness oracle for the
        key-granular ``cones_conflict`` concurrency test.  A region-level
        conflict that key-level conflict detection misses means two
        drains the runtime would have run concurrently actually race —
        an error.  The reverse (key conflict, no region conflict) is the
        expected over-approximation; it is only *counted* (the precision
        statistic feeding the sub-block cone-precision roadmap item)."""
        from repro_torch.analysis.diagnostics import (
            ERROR,
            AnalysisReport,
            Diagnostic,
        )
        from .graph import cones_conflict, region_footprints_conflict

        stats = self.verify_stats
        with self._ticket_lock:
            inflight = [
                t for t in self._tickets
                if not t.done() and t._keys is not None
                and t._regions is not None
            ]
        report = AnalysisReport(rules_run=("races",))
        with self._stats_lock:
            for t in inflight:
                stats.n_race_checks += 1
                kc = cones_conflict(t._keys, keys)
                rk = region_footprints_conflict(t._regions, regions)
                if rk is not None and not kc:
                    report.diagnostics.append(Diagnostic(
                        rule="races",
                        severity=ERROR,
                        message=(
                            f"region-level conflict with in-flight drain "
                            f"#{t._tag} that key-level cones_conflict missed "
                            f"— the concurrent-drain oracle is unsound"
                        ),
                        ops=(t._tag,),
                        key=rk,
                    ))
                elif kc:
                    stats.n_key_conflicts += 1
                    report.n_key_conflicts += 1
                    if rk is None:
                        stats.n_region_false_positives += 1
                        report.n_region_false_positives += 1
            if report.diagnostics:
                stats.n_diagnostics += len(report.diagnostics)
                self.last_verify_report = report
        if report.diagnostics:
            report.raise_if_errors()

    def _ticket_done(self, ticket: FlushTicket, res) -> None:
        with self._ticket_lock:
            if res is not None:
                self._ensure_exec_stats().merge(res)
            if ticket in self._tickets:
                self._tickets.remove(ticket)

    def _ticket_discard(self, ticket: FlushTicket) -> None:
        """Drop a locally-resolved ticket (empty cone / simulated drain)
        from the outstanding list.  Stats were already merged by the
        resolver; the executor is untouched."""
        with self._ticket_lock:
            if ticket in self._tickets:
                self._tickets.remove(ticket)

    def _ticket_failed(self, ticket: FlushTicket) -> None:
        with self._ticket_lock:
            if ticket in self._tickets:
                self._tickets.remove(ticket)
        # a *pool-level* failure (worker thread death) poisons the
        # executor: drop it so the next flush builds a fresh pool
        # (channel + backend survive — progress threads are
        # unaffected).  Per-drain failures (an op raising) leave the
        # pool healthy and concurrent drains running.
        ex = self._exec_executor_obj
        if ex is not None and getattr(ex, "_error", None) is not None:
            self._exec_executor_obj = None
            ex.close()

    def _barrier_cleanup(self) -> None:
        """Housekeeping that is only safe at a true barrier — nothing in
        flight and nothing pending.  Scratch buffers, the transfer-dedup
        cache, and combine-init state must survive partial flushes
        (remainder operations still reference scratch delivered by an
        earlier cone), so they are recycled only here; likewise block
        storage of dead bases may still be read by pending operations."""
        with self._ticket_lock:
            if self._tickets:
                return
        if self.deps.n_pending:
            return
        self.scratch.clear()
        self._xfer_cache.clear()
        self._combine_seen.clear()
        self._purge_dead()

    def _ensure_exec_stats(self):
        if self.exec_stats is None:
            from repro_torch.exec import WaitStats

            mode = "async" if self.exec_channel == "async" else "blocking-channel"
            self.exec_stats = WaitStats(mode=mode, nworkers=self.nprocs)
        return self.exec_stats

    def _purge_dead(self) -> None:
        if not self._dead_bases:
            return
        dead = self._dead_bases
        for key in [k for k in self.storage if k[0] in dead]:
            del self.storage[key]
        for key in [k for k in self._write_epoch if k[0] in dead]:
            del self._write_epoch[key]
        for bid in dead:
            self._live_bases.pop(bid, None)
        self._dead_bases = set()

    # -- reporting -------------------------------------------------------------
    def stats(self):
        """Accumulated run statistics: the simulated
        :class:`TimelineResult`, or the measured
        :class:`repro_torch.exec.WaitStats` when ``flush_backend="async"``
        (both expose makespan / wait_fraction / speedup / summary()).

        Outstanding ``wait=False`` flushes are joined first, so the
        returned object reflects *whole-program* totals — per-cone
        WaitStats merge on ticket completion, never get dropped."""
        if self.flush_backend == "async":
            if not self._closed:
                self._sync_outstanding()
            return self._ensure_exec_stats()
        return self.result
