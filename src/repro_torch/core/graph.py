"""Dependency system (paper §5.7).

Two interchangeable implementations:

* :class:`DependencySystem` — the paper's §5.7.2 heuristic: one ordered
  *dependency-list* of access-nodes per base-block, a reference counter per
  operation-node, and an O(1) ready queue.  Insertion of an operation only
  scans the lists of the blocks it touches.
* :class:`FullDAG` — the §5.7 straw-man that compares every new node against
  every node in the graph (O(n) insert, O(n²) build).  Kept as a reference
  oracle for tests and for the overhead benchmark that motivates the
  heuristic.

Conflict rule: two access-nodes conflict iff they touch the same base-block,
at least one is a write, and their per-dimension index regions intersect.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Hashable, Iterable, Optional

from repro_torch.obs import collector as _obs

from .blocks import Region

__all__ = [
    "AccessNode",
    "OperationNode",
    "DependencySystem",
    "FullDAG",
    "regions_overlap",
    "producer_cone",
    "cone_access_keys",
    "cone_base_ids",
    "cones_conflict",
    "cone_region_footprint",
    "region_footprints_conflict",
]

_op_counter = itertools.count()

# Operation kinds.  COMM nodes are prioritized by the scheduler (§5.7
# invariant 2/3); COMPUTE nodes are everything else.
COMM = "comm"
COMPUTE = "compute"


def regions_overlap(a: Optional[Region], b: Optional[Region]) -> bool:
    """Per-dimension interval intersection — THE conflict geometry, shared
    by :meth:`AccessNode.conflicts` and the plan-stage passes.  ``None``
    means the whole block (always overlaps)."""
    if a is None or b is None:
        return True
    for (a0, a1), (b0, b1) in zip(a, b):
        if a1 <= b0 or b1 <= a0:
            return False
    return True


@dataclass
class AccessNode:
    """Memory access to one sub-view-block (paper fig. 7)."""

    key: Hashable  # (base_id, block_coord) — identifies the dependency list
    region: Optional[Region]  # None = whole block
    write: bool
    op: "OperationNode" = field(repr=False, default=None)
    # access-nodes that were inserted *later* and conflict with this one;
    # their ops get a refcount decrement when this access is removed.
    dependents: list["AccessNode"] = field(default_factory=list, repr=False)
    removed: bool = False

    def conflicts(self, other: "AccessNode") -> bool:
        if not (self.write or other.write):
            return False
        return regions_overlap(self.region, other.region)


@dataclass
class OperationNode:
    """A schedulable operation over a set of sub-view-blocks (paper fig. 7).

    ``kind`` is COMM for data transfers and COMPUTE for local work; the
    scheduler's priority rule keys on it.  ``payload`` carries whatever the
    execution backend needs (ufunc + fragments, transfer descriptor, ...).
    ``procs`` is the set of participating process ranks; ``cost`` a model
    duration in seconds for the timeline simulator; ``bytes`` the transfer
    size for comm nodes.
    """

    kind: str
    payload: object
    procs: tuple[int, ...]
    cost: float = 0.0
    nbytes: int = 0
    label: str = ""
    uid: int = field(default_factory=lambda: next(_op_counter))
    accesses: list[AccessNode] = field(default_factory=list, repr=False)
    refcount: int = 0
    executed: bool = False
    # insertion sequence within the owning dependency system — the
    # program-order key (uid is creation order, which diverges for
    # plan-stage merged nodes inserted mid-list on rebuild)
    seq: int = 0

    def add_access(self, acc: AccessNode) -> None:
        acc.op = self
        self.accesses.append(acc)


def producer_cone(
    ops: list[OperationNode], targets: set
) -> tuple[list[OperationNode], list[OperationNode]]:
    """Split a program-ordered pending-operation list into the
    *dependency cone* of ``targets`` and the untouched remainder.

    ``targets`` holds base ids (ints — every block of that base) and/or
    exact ``(base_id, block)`` access keys (a sub-view readback forces
    only the blocks it touches).

    The cone is the transitive predecessor closure — under the §5.7
    conflict rule, at access-key granularity — of every pending **write**
    to a targeted block: exactly the operations that must execute
    before those blocks are readable.  The closure is computed by one
    reverse walk that propagates two key sets:

    * ``need_any``  — keys *written* by a marked operation: any earlier
      access (read or write) to such a key conflicts, so its operation
      joins the cone.  This also captures anti-dependencies: a pending
      read of a target base recorded *before* a later write to it is
      pulled in, so it observes the program-order value, not the
      post-cone one.
    * ``need_write`` — keys *read* by a marked operation: an earlier
      write to such a key is the producer of the value read.

    Both returned lists preserve program order, so draining the cone
    first and the remainder later respects the total order of every
    conflicting access pair: any conflict between a cone operation and a
    remainder operation necessarily has the cone operation earlier —
    otherwise the closure would have marked the remainder operation too.
    Key granularity (regions ignored) over-approximates, which is sound:
    at worst a few extra operations drain early.
    """
    marked = [False] * len(ops)
    need_any: set[Hashable] = set()
    need_write: set[Hashable] = set()
    for i in range(len(ops) - 1, -1, -1):
        op = ops[i]
        hit = any(
            acc.write and (acc.key[0] in targets or acc.key in targets)
            for acc in op.accesses
        )
        if not hit:
            for acc in op.accesses:
                if acc.key in need_any or (acc.write and acc.key in need_write):
                    hit = True
                    break
        if not hit:
            continue
        marked[i] = True
        for acc in op.accesses:
            if acc.write:
                need_any.add(acc.key)
            else:
                need_write.add(acc.key)
    cone = [op for i, op in enumerate(ops) if marked[i]]
    rest = [op for i, op in enumerate(ops) if not marked[i]]
    return cone, rest


def cone_access_keys(ops: list[OperationNode]) -> tuple[set, set]:
    """The access footprint of a cone: ``(reads, writes)`` key sets at
    the §5.7 access-key granularity (regions ignored — the same sound
    over-approximation ``producer_cone`` uses).  Scratch keys
    (``("s", sid)``) are included: two cones sharing a scratch buffer
    must not drain concurrently."""
    reads: set = set()
    writes: set = set()
    for op in ops:
        for acc in op.accesses:
            (writes if acc.write else reads).add(acc.key)
    return reads, writes


def cone_base_ids(ops: list[OperationNode]) -> set:
    """The array-base ids a cone touches (scratch keys excluded).  The
    plan-shape cache keys on this to restrict the flush's dead-base set
    to the bases the pass pipeline can actually see — a dead base no
    cone operation touches cannot change what the passes do, so it must
    not fragment the cache."""
    out: set = set()
    for op in ops:
        for acc in op.accesses:
            k = acc.key
            if isinstance(k, tuple) and k and k[0] != "s":
                out.add(k[0])
    return out


def cones_conflict(a: tuple[set, set], b: tuple[set, set]) -> bool:
    """True when two cone footprints (from :func:`cone_access_keys`)
    order-depend: one's writes touch the other's reads or writes.
    Disjoint (non-conflicting) cones may drain concurrently in any
    interleaving and still produce bit-identical block contents —
    there is no access pair the dependency systems would have ordered."""
    ar, aw = a
    br, bw = b
    return bool(aw & (br | bw)) or bool(bw & ar)


def cone_region_footprint(ops: list[OperationNode]) -> dict:
    """The *region-precise* access footprint of a cone: ``key -> ([read
    regions], [write regions])``.  Unlike :func:`cone_access_keys` this
    keeps the per-dimension index regions, so two cones sharing a block
    key but touching disjoint slices can be told apart — the precision
    the key-granular conflict check gives up.  A whole-block access
    (region ``None``) collapses its list to ``[None]``."""
    fp: dict = {}
    for op in ops:
        for acc in op.accesses:
            entry = fp.get(acc.key)
            if entry is None:
                entry = fp[acc.key] = ([], [])
            lst = entry[1] if acc.write else entry[0]
            if lst and lst[0] is None:
                continue  # already whole-block
            if acc.region is None:
                lst[:] = [None]
            else:
                lst.append(acc.region)
    return fp


def _any_overlap(regions_a: list, regions_b: list) -> bool:
    for ra in regions_a:
        for rb in regions_b:
            if regions_overlap(ra, rb):
                return True
    return False


def region_footprints_conflict(a: dict, b: dict):
    """§5.7 conflict between two :func:`cone_region_footprint` maps:
    returns the first key where one side's writes overlap the other
    side's reads or writes at region granularity, or ``None`` when the
    footprints may drain concurrently."""
    keys = a.keys() & b.keys() if len(a) < len(b) else b.keys() & a.keys()
    for key in keys:
        ar, aw = a[key]
        br, bw = b[key]
        if (
            _any_overlap(aw, br)
            or _any_overlap(aw, bw)
            or _any_overlap(bw, ar)
        ):
            return key
    return None


def _reset_for_reinsert(op: OperationNode) -> None:
    """Clear the link state a previous insertion left on ``op`` so it can
    be re-inserted into a fresh graph (plan-stage rebuild)."""
    op.refcount = 0
    op.executed = False
    for acc in op.accesses:
        acc.dependents = []
        acc.removed = False


class DependencySystem:
    """Paper §5.7.2: per-base-block dependency lists + ready queue."""

    # True while rebuild() re-inserts already-recorded ops (plan stage /
    # cone extraction): re-insertion is replay, not recording, so the
    # tracer must not see a second "recorded" event per op
    _replay = False

    def __init__(self) -> None:
        # key -> list of live access-nodes, in insertion (program) order.
        self._lists: dict[Hashable, list[AccessNode]] = {}
        self.ready: deque[OperationNode] = deque()
        self.n_ops = 0
        self.n_pending = 0
        # instrumentation for the overhead benchmark
        self.scan_steps = 0
        # when set, newly-ready operations are handed to this callback
        # instead of the ready deque (used by the async executor so worker
        # dispatch happens directly on completion callbacks)
        self.on_ready: Optional[Callable[[OperationNode], None]] = None

    def _make_ready(self, op: OperationNode) -> None:
        if self.on_ready is not None:
            self.on_ready(op)
        else:
            self.ready.append(op)

    # -- recording -------------------------------------------------------
    @classmethod
    def rebuild(cls, ops: Iterable[OperationNode]) -> "DependencySystem":
        """Fresh dependency system from operation-nodes in the given
        (program) order — the re-insertion step of the plan stage
        (``repro_torch.core.plan``).  Access-node link state from a previous
        insertion is reset; because insertion order encodes the total
        order of conflicting accesses, a pass that preserves the
        relative order of the ops it keeps yields an equivalent
        schedule constraint set."""
        deps = cls()
        deps._replay = True
        try:
            for op in ops:
                _reset_for_reinsert(op)
                deps.insert(op)
        finally:
            deps._replay = False
        return deps

    def insert(self, op: OperationNode) -> None:
        """Record ``op``: insert each access into its block's dependency
        list, accumulating the refcount from conflicting earlier accesses."""
        op.seq = self.n_ops  # program order within THIS system
        refs = 0
        for acc in op.accesses:
            lst = self._lists.setdefault(acc.key, [])
            for prev in lst:
                self.scan_steps += 1
                if not prev.removed and prev.op is not op and prev.conflicts(acc):
                    prev.dependents.append(acc)
                    refs += 1
            lst.append(acc)
        op.refcount = refs
        self.n_ops += 1
        self.n_pending += 1
        col = _obs.CURRENT
        if col is not None and not self._replay:
            col.op_recorded(op)
        if refs == 0:
            self._make_ready(op)

    # -- execution bookkeeping -------------------------------------------
    def complete(self, op: OperationNode) -> list[OperationNode]:
        """Remove ``op``'s access-nodes (paper: only on execution are
        access-nodes removed) and return newly-ready operations."""
        assert not op.executed
        op.executed = True
        self.n_pending -= 1
        newly = []
        for acc in op.accesses:
            acc.removed = True
            for dep in acc.dependents:
                dep.op.refcount -= 1
                if dep.op.refcount == 0:
                    newly.append(dep.op)
                    self._make_ready(dep.op)
            acc.dependents.clear()
        # lazy compaction of dependency lists
        for acc in op.accesses:
            lst = self._lists.get(acc.key)
            if lst is not None and len(lst) > 32 and sum(a.removed for a in lst) > len(lst) // 2:
                self._lists[acc.key] = [a for a in lst if not a.removed]
        return newly

    def pop_ready(self, kind: Optional[str] = None) -> Optional[OperationNode]:
        """Pop a ready op, optionally restricted to ``kind`` (comm-first
        priority is implemented by asking for COMM first)."""
        if kind is None:
            return self.ready.popleft() if self.ready else None
        for i, op in enumerate(self.ready):
            if op.kind == kind:
                del self.ready[i]
                return op
        return None

    def ready_of_kind(self, kind: str) -> list[OperationNode]:
        return [op for op in self.ready if op.kind == kind]

    def pending_ops(self) -> list[OperationNode]:
        """All recorded-but-unexecuted operations, in *program* (insertion)
        order — the plan stage's input and the diagnostic payload for
        deadlock reports.  Keyed on ``seq``, not ``uid``: a plan-stage
        merged node sits mid-list with a larger uid, and re-planning a
        partially drained graph must not reorder it past its consumers."""
        seen: dict[int, OperationNode] = {}
        for lst in self._lists.values():
            for acc in lst:
                if not acc.removed and acc.op is not None and not acc.op.executed:
                    seen[acc.op.seq] = acc.op
        return [seen[s] for s in sorted(seen)]

    @property
    def done(self) -> bool:
        return self.n_pending == 0


class FullDAG:
    """Paper §5.7 baseline: O(n) insertion against every live node."""

    def __init__(self) -> None:
        self.nodes: list[OperationNode] = []
        self.edges: dict[int, list[OperationNode]] = {}
        self.ready: deque[OperationNode] = deque()
        self.n_pending = 0
        self.scan_steps = 0

    @classmethod
    def rebuild(cls, ops: Iterable[OperationNode]) -> "FullDAG":
        """Same contract as :meth:`DependencySystem.rebuild` for the
        O(n²) baseline graph."""
        dag = cls()
        for op in ops:
            _reset_for_reinsert(op)
            dag.insert(op)
        return dag

    def insert(self, op: OperationNode) -> None:
        op.seq = len(self.nodes)
        refs = 0
        for prev in self.nodes:
            if prev.executed:
                continue
            dep = False
            for pa in prev.accesses:
                for na in op.accesses:
                    self.scan_steps += 1
                    if pa.key == na.key and pa.conflicts(na):
                        dep = True
                        break
                if dep:
                    break
            if dep:
                self.edges.setdefault(prev.uid, []).append(op)
                refs += 1
        op.refcount = refs
        self.nodes.append(op)
        self.n_pending += 1
        if refs == 0:
            self.ready.append(op)

    def complete(self, op: OperationNode) -> list[OperationNode]:
        op.executed = True
        self.n_pending -= 1
        newly = []
        for succ in self.edges.pop(op.uid, []):
            succ.refcount -= 1
            if succ.refcount == 0:
                newly.append(succ)
                self.ready.append(succ)
        return newly

    def pop_ready(self, kind: Optional[str] = None) -> Optional[OperationNode]:
        if kind is None:
            return self.ready.popleft() if self.ready else None
        for i, op in enumerate(self.ready):
            if op.kind == kind:
                del self.ready[i]
                return op
        return None

    def ready_of_kind(self, kind: str) -> list[OperationNode]:
        return [op for op in self.ready if op.kind == kind]

    def pending_ops(self) -> list[OperationNode]:
        return [op for op in self.nodes if not op.executed]

    @property
    def done(self) -> bool:
        return self.n_pending == 0
