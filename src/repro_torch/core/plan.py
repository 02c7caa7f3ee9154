"""Plan stage of the record → plan → execute flush pipeline.

The paper's runtime records operations lazily and drains them through a
scheduler; this module inserts an explicit *plan* stage in between: a
pipeline of registered graph passes rewrites the recorded operation list
before any scheduling happens.  Passes attack the dispatch-overhead wall
(ROADMAP "Dispatch overhead": ~0.1 ms/op of Python thread handoff caps
single-machine scaling near 10k ops per flush) the way arXiv:1811.05077
rewrites task graphs for latency tolerance and arXiv:1810.07591
aggregates tasks to amortize per-task Python overhead:

* ``"coalesce"`` (:func:`coalesce_transfers`, here) — merge chains of
  same-(src, dst) transfers into one wire message, so the channel
  progress engine posts fewer, larger sends;
* ``"fuse"`` (:func:`repro_torch.core.fusion.fuse_cross_kind`) — cross-kind
  producer/consumer fusion beyond elementwise trees: map→reduce-partial
  pairs become joint payloads, fill values constant-fold into consuming
  maps, dead stores to collected bases are eliminated;
* ``"batch"`` (:func:`batch_dispatch`, here) — an executor hint: ready
  compute ops move between the completion sweep and the workers as
  per-worker *lists*, amortizing one lock+event round trip over many
  operations.

Passes are string-keyed plugins (``repro_torch.register_pass``) resolved
through :mod:`repro_torch.api.registry`, ordered by the pipeline on
:class:`~repro_torch.api.config.ExecutionPolicy` — they compose exactly like
backends and channels do.  Under demand-driven sync the pipeline runs
on each extracted dependency cone, not the whole recorded graph: the
runtime hands ``plan()`` the cone's dependency system and a
``dead_bases`` set already restricted to bases no *remainder* operation
still touches (a dead temp whose consumer stays pending is not dead for
this flush).

**Correctness contract** — a pass must preserve the relative program
order of every pair of conflicting accesses it keeps.  The rewritten
list is re-inserted into a fresh dependency system
(:meth:`~repro_torch.core.graph.DependencySystem.rebuild`), and because
insertion order *is* the total order of conflicting accesses (§5.7),
any executor draining the planned graph produces block contents
bit-identical to the unplanned one.  The built-in passes guarantee this
by construction: a merged operation is placed at its earliest
constituent's position, and a constituent may only be hoisted there if
no conflicting write intervenes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence, Union

from repro_torch.api.registry import get_pass, register_pass
from repro_torch.obs import collector as _obs

from .engine import CoalescedTransferPayload, TransferPayload
from .graph import (
    COMM,
    AccessNode,
    DependencySystem,
    OperationNode,
    regions_overlap,  # noqa: F401  (re-export for pass authors)
)
from .ufunc import to_numpy_dtype

__all__ = [
    "PlanStats",
    "PlanContext",
    "PlanResult",
    "plan",
    "resolve_pipeline",
    "coalesce_transfers",
    "batch_dispatch",
    "DEFAULT_ASYNC_PIPELINE",
    "MAX_COALESCE",
]

# default pipeline for the measured (async) flush backend; the simulator
# keeps the unrewritten graphs so the paper-reproduction numbers stay
# exactly the paper's
DEFAULT_ASYNC_PIPELINE = ("coalesce", "fuse", "batch")

# cap on transfers per coalesced message (bounds the latency cost of one
# oversized send and keeps per-message work balanced across progress
# threads)
MAX_COALESCE = 16


@dataclass
class PlanStats:
    """Counters accumulated across the plan stages of a runtime's
    flushes — the observable effect of the pass pipeline."""

    n_ops_in: int = 0
    n_ops_out: int = 0
    n_transfers_coalesced: int = 0  # transfer ops merged away
    n_fused: int = 0  # map→reduce pairs fused into joint payloads
    n_const_folded: int = 0  # fill values propagated into map args
    n_dropped: int = 0  # dead stores eliminated

    def merge(self, other: "PlanStats") -> "PlanStats":
        self.n_ops_in += other.n_ops_in
        self.n_ops_out += other.n_ops_out
        self.n_transfers_coalesced += other.n_transfers_coalesced
        self.n_fused += other.n_fused
        self.n_const_folded += other.n_const_folded
        self.n_dropped += other.n_dropped
        return self


@dataclass
class PlanContext:
    """Mutable state handed through the pass pipeline.

    ``ops`` is the recorded operation list in program order — list
    order, not uid order, is authoritative (passes may append
    newly-built merged nodes whose uids are larger than their
    position).  ``dead_bases`` are array-base ids whose user-facing
    arrays have been garbage-collected before this flush: their block
    contents can never be read back, which licenses dead-store
    elimination and write-skipping fusion.  ``storage`` is the
    runtime's block storage, used read-only for dtype lookups.
    ``hints`` are handed to the execution stage (e.g.
    ``batch_dispatch``).
    """

    ops: list[OperationNode]
    dead_bases: set = field(default_factory=set)
    storage: dict = field(default_factory=dict)
    hints: dict = field(default_factory=dict)
    stats: PlanStats = field(default_factory=PlanStats)
    max_coalesce: int = MAX_COALESCE
    dirty: bool = False
    # rewrite provenance, fed to obs tracing and the static plan
    # verifier (repro_torch.analysis): new uid -> (pass, source uids), and
    # dropped uid -> pass
    provenance: dict = field(default_factory=dict)
    dropped: dict = field(default_factory=dict)
    _active_pass: Optional[str] = None

    def dtype_of(self, base_id: int, block: tuple):
        """NumPy dtype of a stored block (blocks are tensors; folding
        builds NumPy scalars of this dtype)."""
        blk = self.storage.get((base_id, block))
        return None if blk is None else to_numpy_dtype(blk.dtype)

    def note_rewrite(self, op: OperationNode, sources) -> None:
        """Record that the active pass built ``op`` out of ``sources``
        (operation-nodes or uids).  Every pass that replaces nodes MUST
        call this: it is both the obs ``rewritten`` trace event and the
        provenance the plan verifier uses to follow a constituent to
        its merged node (and to blame the right pass in diagnostics)."""
        name = self._active_pass or "<pass>"
        srcs = tuple(getattr(s, "uid", s) for s in sources)
        self.provenance[op.uid] = (name, srcs)
        col = _obs.CURRENT
        if col is not None:
            col.op_rewritten(name, op, srcs)

    def note_drop(self, op: OperationNode) -> None:
        """Record that the active pass eliminated ``op`` outright
        (dead-store elimination).  Emits the obs ``dropped`` event and
        feeds the verifier's drop provenance."""
        name = self._active_pass or "<pass>"
        self.dropped[op.uid] = name
        col = _obs.CURRENT
        if col is not None:
            col.op_dropped(name, op)


@dataclass
class PlanResult:
    deps: DependencySystem
    hints: dict
    stats: PlanStats
    # rewrite/drop provenance accumulated by the pipeline (see
    # PlanContext.note_rewrite / note_drop) — the plan verifier's input
    provenance: dict = field(default_factory=dict)
    dropped: dict = field(default_factory=dict)
    # the final planned operation list in program order (``ctx.ops``) —
    # what the plan-shape cache walks to record a replayable recipe
    # (positions in this tuple, joined with ``provenance``/``dropped``,
    # say which pass produced every node)
    ops: tuple = ()


def resolve_pipeline(
    spec: Union[None, str, Sequence[str]], flush_backend: str = "sim"
) -> tuple[str, ...]:
    """Normalize a pass-pipeline spec to a tuple of registered names.

    ``"auto"`` resolves per flush backend (the measured executor gets
    :data:`DEFAULT_ASYNC_PIPELINE`, the simulator no passes); a string
    is split on commas; every name is validated against the pass
    registry so unknown passes fail at construction time.
    """
    if spec is None:
        return ()
    if isinstance(spec, str):
        if spec == "auto":
            return DEFAULT_ASYNC_PIPELINE if flush_backend == "async" else ()
        spec = tuple(s for s in (x.strip() for x in spec.split(",")) if s)
    pipeline = tuple(spec)
    from repro_torch.api.registry import PASSES

    for name in pipeline:
        if name not in PASSES:
            raise ValueError(
                f"unknown pass {name!r} "
                f"(registered: {', '.join(PASSES.available()) or 'none'})"
            )
    return pipeline


def plan(
    deps: DependencySystem,
    pipeline: Sequence[str],
    *,
    dead_bases: Optional[set] = None,
    storage: Optional[dict] = None,
    max_coalesce: int = MAX_COALESCE,
) -> PlanResult:
    """Run the pass ``pipeline`` over the recorded graph.

    Returns the (possibly rebuilt) dependency system, the executor
    hints, and the pass statistics.  When no pass rewrites the graph
    the original system is returned untouched — the plan stage costs
    one ``pending_ops`` walk and nothing else.
    """
    stats = PlanStats(n_ops_in=deps.n_pending, n_ops_out=deps.n_pending)
    if not pipeline or deps.n_pending == 0:
        return PlanResult(deps, {}, stats)
    ctx = PlanContext(
        ops=deps.pending_ops(),
        dead_bases=set(dead_bases or ()),
        storage=storage if storage is not None else {},
        stats=stats,
        max_coalesce=max_coalesce,
    )
    col = _obs.CURRENT
    for name in pipeline:
        n_before = len(ctx.ops)
        ctx._active_pass = name
        try:
            get_pass(name)(ctx)
        finally:
            ctx._active_pass = None
        if col is not None:
            col.plan_pass(name, n_before, len(ctx.ops))
    stats.n_ops_out = len(ctx.ops)
    new_deps = type(deps).rebuild(ctx.ops) if ctx.dirty else deps
    return PlanResult(
        new_deps, ctx.hints, stats, ctx.provenance, ctx.dropped, tuple(ctx.ops)
    )


# ---------------------------------------------------------------------------
# built-in pass: transfer coalescing
# ---------------------------------------------------------------------------


def _is_simple_transfer(op: OperationNode) -> bool:
    return (
        op.kind == COMM
        and isinstance(op.payload, TransferPayload)
        and len(op.procs) == 2
    )


def coalesce_transfers(ctx: PlanContext) -> None:
    """Merge chains of transfers with the same (src, dst) process pair
    into one :class:`~repro_torch.core.engine.CoalescedTransferPayload`.

    The merged node sits at the position of its *first* constituent; a
    transfer may only join an open group if none of its read keys has
    been written since the group opened (hoisting its read to the group
    position must not skip a conflicting write).  Scratch destinations
    are untouched, so consumers are oblivious to the merge — they just
    see their scratch buffer delivered by a bigger message.
    """
    ops = ctx.ops
    last_write: dict = {}  # access key -> last position with a write
    open_groups: dict[tuple, dict] = {}  # (src, dst) -> group record
    member_of: dict[int, dict] = {}  # op position -> its group
    for i, op in enumerate(ops):
        if _is_simple_transfer(op):
            key = op.procs
            g = open_groups.get(key)
            joinable = g is not None and len(g["idx"]) < ctx.max_coalesce
            if joinable:
                for acc in op.accesses:
                    if not acc.write and last_write.get(acc.key, -1) >= g["pos"]:
                        joinable = False
                        break
            if not joinable:
                g = {"pos": i, "idx": []}
                open_groups[key] = g
            g["idx"].append(i)
            member_of[i] = g
        for acc in op.accesses:
            if acc.write:
                last_write[acc.key] = i
    if not any(len(g["idx"]) > 1 for g in member_of.values()):
        return
    new_ops: list[OperationNode] = []
    merged_away = 0
    for i, op in enumerate(ops):
        g = member_of.get(i)
        if g is None or len(g["idx"]) < 2:
            new_ops.append(op)
            continue
        if i != g["idx"][0]:
            continue  # folded into the group leader's position
        members = [ops[j] for j in g["idx"]]
        merged = OperationNode(
            COMM,
            CoalescedTransferPayload(tuple(m.payload for m in members)),
            procs=op.procs,
            nbytes=sum(m.nbytes for m in members),
            label=f"xfer-coalesced[{len(members)}]",
        )
        for m in members:
            for acc in m.accesses:
                merged.add_access(AccessNode(acc.key, acc.region, acc.write))
        ctx.note_rewrite(merged, members)
        new_ops.append(merged)
        merged_away += len(members) - 1
    ctx.ops = new_ops
    ctx.dirty = True
    ctx.stats.n_transfers_coalesced += merged_away


# ---------------------------------------------------------------------------
# built-in pass: batched dispatch (executor hint)
# ---------------------------------------------------------------------------


def batch_dispatch(ctx: PlanContext) -> None:
    """Executor hint: the completion sweep groups newly-ready compute
    ops per worker and hands each worker a *list* per wakeup
    (``Worker.push_batch``), and workers drain their whole queue per
    wakeup and complete the batch through a single ``on_ready`` sweep —
    amortizing the ~0.1 ms/op lock+event handoff that caps
    single-machine scaling (ROADMAP "Dispatch overhead")."""
    ctx.hints["batch_dispatch"] = True


# shared region helpers for pass authors (``regions_overlap`` — the
# conflict geometry itself — is re-exported from repro_torch.core.graph) -----------


def region_covers(outer, inner) -> bool:
    """True iff ``outer`` contains every index of ``inner``."""
    if outer is None:
        return True
    if inner is None:
        return False
    return all(
        o0 <= i0 and i1 <= o1 for (o0, o1), (i0, i1) in zip(outer, inner)
    )


def op_reads(op: OperationNode) -> Iterable[tuple]:
    """(key, region) pairs the op reads — including the *implicit*
    read-modify-write of non-initializing combines and matmuls, whose
    access lists only carry the write."""
    from .engine import CombinePayload, MatmulPayload

    out = [(a.key, a.region) for a in op.accesses if not a.write]
    p = op.payload
    if isinstance(p, (CombinePayload, MatmulPayload)) and not p.init:
        out.extend((a.key, a.region) for a in op.accesses if a.write)
    return out


# registration last: registering triggers the registry's default-module
# load, which imports repro_torch.core.fusion — and that module imports the
# helpers above, so this module must be fully defined first
register_pass("coalesce", coalesce_transfers)
register_pass("batch", batch_dispatch)
