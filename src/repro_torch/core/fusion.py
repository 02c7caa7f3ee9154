"""Fusion: record-time elementwise trees and the plan-stage cross-kind
fusion pass.

Two fusion layers live here:

* **Record-time elementwise fusion** (paper §7 "future work",
  implemented beyond-paper): with ``Runtime(fusion=True)``, operator
  applications build :class:`~repro_torch.core.darray.Expr` trees instead of
  materializing a temporary per ufunc; the whole tree is recorded as
  ONE joint operation.  Fewer operation-nodes → lower
  dependency-system overhead; no intermediate temporaries → less
  memory traffic; higher per-fragment arithmetic intensity → more
  computation to hide each transfer behind (§5.4 overlap window).

* **Plan-stage cross-kind fusion** (the ``"fuse"`` pass,
  :func:`fuse_cross_kind`): record-time fusion only merges elementwise
  ufuncs.  This pass runs over the *recorded* graph and fuses across
  operation kinds:

  - **map → reduce-partial**: a map whose output fragment is consumed
    only by a partial reduction of the exact same fragment — and whose
    output base is dead (the user dropped the temporary, e.g.
    ``(x * x).sum()``) — becomes one
    :class:`~repro_torch.core.engine.FusedMapReducePayload`, skipping the
    block-storage round trip entirely;
  - **fill → map**: a map operand whose fragment was last written by a
    contiguous fill covering it constant-folds the fill value into the
    argument list, deleting the dependency edge;
  - **dead-store elimination**: fills and maps writing regions of dead
    bases that no remaining operation reads are dropped.

  All rewrites preserve the relative program order of the conflicting
  accesses they keep (the fused node sits at the producer's position),
  so planned graphs stay bit-identical to the unfused simulator — the
  property-based test in ``tests/test_plan.py`` checks exactly this on
  random programs.
"""
from __future__ import annotations

from collections import defaultdict

from repro_torch.api.registry import register_pass

from .darray import Expr  # noqa: F401  (re-export: the record-time layer)
from .engine import (
    FillPayload,
    FusedMapReducePayload,
    MapPayload,
    ReducePartialPayload,
)
from .graph import COMPUTE, AccessNode, OperationNode
from .plan import PlanContext, op_reads, region_covers, regions_overlap

__all__ = ["Expr", "fuse_cross_kind"]


def _rebuild_map_accesses(op: OperationNode, p: MapPayload) -> None:
    """Re-derive the access list of a map whose args changed (mirrors
    ``Runtime._insert_compute``'s construction)."""
    writes = [a for a in op.accesses if a.write]
    op.accesses = []
    for a in writes:
        op.add_access(AccessNode(a.key, a.region, write=True))
    for ref in p.args:
        if ref[0] == "b":
            _, bid, frag = ref
            op.add_access(
                AccessNode((bid, frag.block), frag.region, write=False)
            )
        elif ref[0] == "s":
            op.add_access(AccessNode(("s", ref[1]), None, write=False))


def _const_fold_fills(ctx: PlanContext) -> None:
    """fill → map: replace map operands whose fragment was last written
    by a covering contiguous fill with the fill value (cast to the
    block dtype, so the ufunc sees exactly what a block read would have
    produced)."""
    writes_at: dict = defaultdict(list)  # key -> [(pos, region, op)]
    folded = 0
    for i, op in enumerate(ctx.ops):
        p = op.payload
        if isinstance(p, MapPayload):
            new_args = list(p.args)
            changed = False
            for k, ref in enumerate(p.args):
                if ref[0] != "b":
                    continue
                _, bid, frag = ref
                last = None
                for pos, region, wop in reversed(
                    writes_at.get((bid, frag.block), ())
                ):
                    if regions_overlap(region, frag.region):
                        last = wop
                        break
                if last is None or not isinstance(last.payload, FillPayload):
                    continue
                fp = last.payload
                if any(st != 1 for _, _, st in fp.out_frag.local):
                    continue  # strided fill: does not cover contiguously
                if not region_covers(fp.out_frag.region, frag.region):
                    continue
                dtype = ctx.dtype_of(bid, frag.block)
                if dtype is None:
                    continue
                new_args[k] = ("c", dtype.type(fp.value))
                changed = True
                folded += 1
            if changed:
                p.args = tuple(new_args)
                _rebuild_map_accesses(op, p)
                ctx.dirty = True
        for acc in op.accesses:
            if acc.write:
                writes_at[acc.key].append((i, acc.region, op))
    ctx.stats.n_const_folded += folded


def _fuse_map_reduce(ctx: PlanContext) -> None:
    """map → reduce-partial fusion on dead temporaries."""
    ops = ctx.ops
    reads_by_key: dict = defaultdict(list)  # key -> [(pos, region)]
    writes_by_key: dict = defaultdict(list)  # key -> [(pos, region, op)]
    for i, op in enumerate(ops):
        for key, region in op_reads(op):
            reads_by_key[key].append((i, region))
        for a in op.accesses:
            if a.write:
                writes_by_key[a.key].append((i, a.region, op))
    fused: dict[int, OperationNode] = {}  # map position -> fused node
    dropped: set[int] = set()  # reduce positions folded away
    for i, op in enumerate(ops):
        p = op.payload
        if not isinstance(p, ReducePartialPayload) or p.src[0] != "b":
            continue
        _, bid, frag = p.src
        if bid not in ctx.dead_bases:
            continue
        key = (bid, frag.block)
        # the latest writer overlapping the reduced fragment before us
        last = None
        for pos, region, wop in reversed(writes_by_key.get(key, ())):
            if pos < i and regions_overlap(region, frag.region):
                last = (pos, wop)
                break
        if last is None:
            continue
        mpos, mop = last
        mp = mop.payload
        if (
            mpos in fused
            or not isinstance(mp, MapPayload)
            or mp.out_frag.block != frag.block
            or mp.out_frag.local != frag.local
        ):
            continue
        # sole reader: nothing after the map reads its output region
        # except this reduction (earlier readers saw the pre-map value
        # and are unaffected by skipping the write)
        sole = all(
            pos <= mpos or pos == i or not regions_overlap(region, mp.out_frag.region)
            for pos, region in reads_by_key.get(key, ())
        )
        if not sole:
            continue
        node = OperationNode(
            COMPUTE,
            FusedMapReducePayload(mp, p.ufunc_name, p.axes, p.dst_scratch, p.keepdims),
            procs=mop.procs,
            cost=mop.cost + op.cost,
            label=f"map+reduce:{p.ufunc_name}",
        )
        for a in mop.accesses:
            if not a.write:
                node.add_access(AccessNode(a.key, a.region, write=False))
        node.add_access(AccessNode(("s", p.dst_scratch), None, write=True))
        ctx.note_rewrite(node, (mop, op))
        fused[mpos] = node
        dropped.add(i)
    if fused:
        ctx.ops = [
            fused.get(i, op) for i, op in enumerate(ops) if i not in dropped
        ]
        ctx.dirty = True
        ctx.stats.n_fused += len(fused)


def _drop_dead_stores(ctx: PlanContext) -> None:
    """Eliminate fills/maps writing dead-base regions never read by any
    remaining operation (the base was garbage-collected, so the blocks
    can never be gathered either)."""
    ops = ctx.ops
    reads_by_key: dict = defaultdict(list)
    for i, op in enumerate(ops):
        for key, region in op_reads(op):
            reads_by_key[key].append((i, region))
    drop: set[int] = set()
    for i, op in enumerate(ops):
        p = op.payload
        if not isinstance(p, (FillPayload, MapPayload)):
            continue
        if p.out_base not in ctx.dead_bases:
            continue
        frag = p.out_frag
        if any(
            pos > i and regions_overlap(region, frag.region)
            for pos, region in reads_by_key.get((p.out_base, frag.block), ())
        ):
            continue
        drop.add(i)
    if drop:
        for i in drop:
            ctx.note_drop(ops[i])
        ctx.ops = [op for i, op in enumerate(ops) if i not in drop]
        ctx.dirty = True
        ctx.stats.n_dropped += len(drop)


def fuse_cross_kind(ctx: PlanContext) -> None:
    """The ``"fuse"`` plan pass: fill→map constant folding, then
    map→reduce-partial fusion, then dead-store elimination (each stage
    re-indexes, so later stages see earlier rewrites)."""
    _const_fold_fills(ctx)
    _fuse_map_reduce(ctx)
    _drop_dead_stores(ctx)


register_pass("fuse", fuse_cross_kind)
