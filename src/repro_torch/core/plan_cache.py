"""Plan-shape cache: skip re-planning (and re-verifying) cones whose
*shape* was planned before.

Serving workloads are repetitive — the same request function records the
same operation graph over and over, differing only in which array bases
(and scratch ids) the fresh cone happens to use.  Planning is pure
structure: every decision the pass pipeline makes (which transfers
coalesce, which map→reduce pairs fuse, which fill values fold, which
dead stores drop) depends only on the cone's *canonical* shape — the
operation list modulo a consistent renaming of base ids and scratch ids
— plus the dead-base set, the pass pipeline, and the block dtypes.  Two
cones with equal canonical signatures therefore plan identically.

The cache exploits that in two steps:

* :meth:`PlanCache.signature` canonicalizes a cone into a hashable
  structural key (first-occurrence renaming ``base→c0,c1,…`` /
  ``scratch→s0,s1,…``; every pass-relevant datum — ufunc trees, fragment
  geometry, fill/constant values, block dtypes, proc placements, access
  footprints, the dead set — is part of the key, so a signature hit is a
  *proof* of identical planning, not a heuristic);
* on a cold plan, :meth:`PlanCache.insert` diffs the planned operation
  list (``PlanResult.ops`` + rewrite provenance) against the pre-plan
  list into a replayable **recipe** — keep/patch, coalesce(positions),
  fuse(map, reduce) steps; on a hit, :meth:`PlanCache.replay` applies
  the recipe to the *fresh* cone's operation nodes, constructing merged
  nodes exactly as the passes would (same payloads, same access lists,
  same program order).

Because the insert-time plan went through the static plan verifier (or
is at least verifiable — the entry retains the pre/post footprint
snapshots, provenance, and drop records), a replay needs no
re-verification: it is the same rewrite, re-targeted.
:meth:`Runtime.verify_cached_plans` re-checks every resident entry on
demand (the graph lint for cached plans).

Unknown payload kinds, unregistered passes, or rewrites the recipe
language cannot express make a cone *uncacheable* — the cold path
simply runs every time, counted in :attr:`PlanCache.n_uncacheable`.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Optional

from .engine import (
    CombinePayload,
    FillPayload,
    FusedMapReducePayload,
    MapPayload,
    MatmulPayload,
    ReducePartialPayload,
    TransferPayload,
)
from .graph import COMM, COMPUTE, AccessNode, OperationNode
from .ufunc import to_numpy_dtype

__all__ = ["PlanCache", "PlanCacheEntry"]

# passes whose rewrites the recipe language can express; any other name
# in the pipeline makes every cone uncacheable (correct, just cold)
_REPLAYABLE_PASSES = frozenset({"coalesce", "fuse", "batch"})

_DEFAULT_MAXSIZE = 256


class _Canon:
    """First-occurrence canonical renaming of base ids and scratch ids:
    the cone recorded by request N and the one recorded by request N+1
    use different global counters, but walk their operations in program
    order and both collapse to ``c0, c1, …`` / ``s0, s1, …``."""

    __slots__ = ("bases", "scratch")

    def __init__(self):
        self.bases: dict = {}
        self.scratch: dict = {}

    def base(self, bid) -> int:
        out = self.bases.get(bid)
        if out is None:
            out = self.bases[bid] = len(self.bases)
        return out

    def scr(self, sid) -> int:
        out = self.scratch.get(sid)
        if out is None:
            out = self.scratch[sid] = len(self.scratch)
        return out


def _const_sig(v):
    """Value signature for a scalar constant: dtype identity + exact
    value (``.item()`` for numpy scalars, so hashing never sees a 0-d
    array)."""
    dt = getattr(v, "dtype", None)
    name = str(dt) if dt is not None else type(v).__name__
    return (name, v.item() if hasattr(v, "item") else v)


def _tree_sig(spec):
    """Signature of a fused-ufunc expression tree: primitive names and
    leaf positions, with const *values* resolved so two trees differing
    only in an embedded constant get distinct keys."""
    if spec is None:
        return None
    tag = spec[0]
    if tag == "leaf":
        return spec
    if tag == "const":
        return ("const", _const_sig(spec[1]))
    f, subs = spec
    return (f.name, tuple(_tree_sig(s) for s in subs))


def _ufunc_sig(uf):
    return (uf.name, str(uf.out_dtype), _tree_sig(uf.tree))


def _frag_sig(frag):
    return (frag.block, frag.local, frag.owner)


class _Uncacheable(Exception):
    pass


def _block_dtype(storage, bid, block):
    blk = storage.get((bid, block))
    return None if blk is None else str(to_numpy_dtype(blk.dtype))


def _ref_sig(ref, canon: _Canon, storage):
    kind = ref[0]
    if kind == "b":
        _, bid, frag = ref
        return ("b", canon.base(bid), _frag_sig(frag),
                _block_dtype(storage, bid, frag.block))
    if kind == "s":
        return ("s", canon.scr(ref[1]))
    if kind == "c":
        return ("c", _const_sig(ref[1]))
    raise _Uncacheable


def _payload_sig(p, canon: _Canon, storage):
    if isinstance(p, MapPayload):
        return ("map", _ufunc_sig(p.ufunc), canon.base(p.out_base),
                _frag_sig(p.out_frag),
                _block_dtype(storage, p.out_base, p.out_frag.block),
                str(p.out_dtype),
                tuple(_ref_sig(r, canon, storage) for r in p.args))
    if isinstance(p, TransferPayload):
        return ("xfer", _ref_sig(p.src, canon, storage),
                canon.scr(p.dst_scratch))
    if isinstance(p, ReducePartialPayload):
        return ("rpart", p.ufunc_name, _ref_sig(p.src, canon, storage),
                p.axes, canon.scr(p.dst_scratch), p.keepdims)
    if isinstance(p, CombinePayload):
        return ("comb", p.ufunc_name, canon.base(p.out_base),
                _frag_sig(p.out_frag),
                _block_dtype(storage, p.out_base, p.out_frag.block),
                canon.scr(p.src_scratch), p.init)
    if isinstance(p, MatmulPayload):
        return ("mm", canon.base(p.out_base), _frag_sig(p.out_frag),
                _block_dtype(storage, p.out_base, p.out_frag.block),
                _ref_sig(p.a, canon, storage),
                _ref_sig(p.b, canon, storage),
                p.trans_a, p.trans_b, p.init)
    if isinstance(p, FillPayload):
        return ("fill", canon.base(p.out_base), _frag_sig(p.out_frag),
                _block_dtype(storage, p.out_base, p.out_frag.block),
                _const_sig(p.value))
    # plan-produced payloads (coalesced / fused) are never *recorded*,
    # and anything else is a payload kind this module does not know
    raise _Uncacheable


def _access_key_sig(key, canon: _Canon):
    if isinstance(key, tuple) and key and key[0] == "s":
        return ("s", canon.scr(key[1]))
    bid, block = key
    return ("b", canon.base(bid), block)


def _op_sig(op, canon: _Canon, storage):
    return (
        op.kind,
        op.procs,
        _payload_sig(op.payload, canon, storage),
        tuple(
            (_access_key_sig(a.key, canon), a.region, a.write)
            for a in op.accesses
        ),
    )


def _args_patch(pre_args, post_args):
    """Diff a map's pre-plan argument tuple against its post-plan one
    into a ``((pos, const_value), …)`` patch — const folding is the only
    in-place arg rewrite the pipeline performs, so any other difference
    is unexpressible (raises)."""
    if len(pre_args) != len(post_args):
        raise _Uncacheable
    patch = []
    for k, (old, new) in enumerate(zip(pre_args, post_args)):
        if old is new or old == new:
            continue
        if new[0] != "c":
            raise _Uncacheable
        patch.append((k, new[1]))
    return tuple(patch)


def _apply_patch(op, patch) -> None:
    from .fusion import _rebuild_map_accesses

    p = op.payload
    args = list(p.args)
    for k, v in patch:
        args[k] = ("c", v)
    p.args = tuple(args)
    _rebuild_map_accesses(op, p)


@dataclass
class PlanCacheEntry:
    """One cached plan shape: the replay recipe plus everything needed
    to re-verify the plan on demand (`pre`/`post` footprint snapshots,
    rewrite provenance, drop records — the exact inputs of
    ``repro_torch.analysis.check(rules=("plan", "deadlock"))``)."""

    steps: tuple  # ("keep", i, patch) | ("coalesce", idxs) | ("fuse", mi, ri, patch)
    dirty: bool  # did the insert-time plan rebuild the dependency system
    hints: dict
    stats: object  # PlanStats of the insert-time plan
    n_ops: int  # pre-plan op count (sanity check on replay)
    pre_views: tuple  # immutable OpView snapshot of the pre-plan cone
    post_views: tuple  # …and of the planned op list
    provenance: dict
    dropped: dict
    dead_bases: frozenset
    scratch_available: frozenset


class PlanCache:
    """LRU of canonical cone shape → replayable plan recipe.

    Thread-safe: concurrent submitter threads (serving clients planning
    off the record lock) hit one internal lock for lookup/insert;
    signature computation and replay run lock-free on caller state."""

    def __init__(self, maxsize: int = _DEFAULT_MAXSIZE):
        self.maxsize = maxsize
        self._entries: "OrderedDict[tuple, PlanCacheEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.n_uncacheable = 0

    # -- keying -------------------------------------------------------------
    def signature(self, pending, dead_bases, pipeline, storage):
        """Canonical structural signature of a cone, or ``None`` when
        the cone (or the pipeline) is uncacheable."""
        if not _REPLAYABLE_PASSES.issuperset(pipeline):
            with self._lock:
                self.n_uncacheable += 1
            return None
        canon = _Canon()
        try:
            ops_sig = tuple(_op_sig(op, canon, storage) for op in pending)
            # only dead bases the cone actually touches can influence the
            # plan; canonical ids make the set renaming-stable
            dead_sig = tuple(sorted(
                canon.bases[b] for b in dead_bases if b in canon.bases
            ))
            sig = (tuple(pipeline), ops_sig, dead_sig)
            hash(sig)
        except (_Uncacheable, TypeError, ValueError):
            with self._lock:
                self.n_uncacheable += 1
            return None
        return sig

    def lookup(self, sig) -> Optional[PlanCacheEntry]:
        with self._lock:
            entry = self._entries.get(sig)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(sig)
            self.hits += 1
            return entry

    # -- recipe construction (cold path) ------------------------------------
    def insert(self, sig, pending, pre_args, planned, dead_bases, *,
               pre_views, scratch_available) -> Optional[PlanCacheEntry]:
        """Diff ``planned`` against the pre-plan op list into a replay
        recipe and cache it under ``sig``.  Returns ``None`` (without
        caching) when the rewrite is not expressible — every pre-plan
        operation must be accounted for as kept, merged, fused, or
        dropped, and every payload change must be a const-fold patch."""
        pre_index = {op.uid: i for i, op in enumerate(pending)}
        consumed: set = set()
        steps: list = []
        dirty = False
        try:
            for op in planned.ops:
                prov = planned.provenance.get(op.uid)
                if prov is not None:
                    pname, srcs = prov
                    if pname == "coalesce":
                        idxs = tuple(pre_index[u] for u in srcs)
                        consumed.update(srcs)
                        steps.append(("coalesce", idxs))
                        dirty = True
                    elif pname == "fuse":
                        mu, ru = srcs
                        mi, ri = pre_index[mu], pre_index[ru]
                        consumed.update(srcs)
                        # the fused payload references the (possibly
                        # const-folded) map payload; the patch replays
                        # the fold onto the fresh map before fusing
                        patch = _args_patch(
                            pre_args[mu], op.payload.map.args
                        )
                        steps.append(("fuse", mi, ri, patch))
                        dirty = True
                    else:
                        raise _Uncacheable
                    continue
                i = pre_index.get(op.uid)
                if i is None:
                    raise _Uncacheable  # a node from nowhere
                consumed.add(op.uid)
                patch = ()
                if isinstance(op.payload, MapPayload):
                    patch = _args_patch(pre_args[op.uid], op.payload.args)
                    if patch:
                        dirty = True
                steps.append(("keep", i, patch))
            for uid in planned.dropped:
                if uid not in pre_index:
                    raise _Uncacheable
                consumed.add(uid)
                dirty = True
            if consumed != set(pre_index):
                raise _Uncacheable  # an op vanished without provenance
        except (_Uncacheable, KeyError):
            with self._lock:
                self.n_uncacheable += 1
            return None
        from repro_torch.analysis import snapshot_ops

        entry = PlanCacheEntry(
            steps=tuple(steps),
            dirty=dirty,
            hints=dict(planned.hints),
            stats=replace(planned.stats),
            n_ops=len(pending),
            pre_views=tuple(pre_views) if pre_views is not None else (),
            post_views=tuple(snapshot_ops(list(planned.ops))),
            provenance=dict(planned.provenance),
            dropped=dict(planned.dropped),
            dead_bases=frozenset(dead_bases),
            scratch_available=frozenset(scratch_available),
        )
        with self._lock:
            self._entries[sig] = entry
            self._entries.move_to_end(sig)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
        return entry

    # -- replay (hit path) ---------------------------------------------------
    def replay(self, entry: PlanCacheEntry, deps, pending):
        """Apply a cached recipe to a fresh cone: returns
        ``(new_deps, hints, stats)`` exactly as a cold
        :func:`repro_torch.core.plan.plan` call would.  Merged/fused nodes are
        constructed the way the passes construct them — same payloads,
        same access lists, same program order — so the drained result is
        bit-identical to a cold plan of the same cone."""
        if len(pending) != entry.n_ops:
            raise RuntimeError(
                "plan-cache replay on a cone of different size "
                f"({len(pending)} ops, recipe expects {entry.n_ops})"
            )
        out: list = []
        for step in entry.steps:
            tag = step[0]
            if tag == "keep":
                _, i, patch = step
                op = pending[i]
                if patch:
                    _apply_patch(op, patch)
                out.append(op)
            elif tag == "coalesce":
                from .engine import CoalescedTransferPayload

                members = [pending[j] for j in step[1]]
                lead = members[0]
                merged = OperationNode(
                    COMM,
                    CoalescedTransferPayload(
                        tuple(m.payload for m in members)
                    ),
                    procs=lead.procs,
                    nbytes=sum(m.nbytes for m in members),
                    label=f"xfer-coalesced[{len(members)}]",
                )
                for m in members:
                    for acc in m.accesses:
                        merged.add_access(
                            AccessNode(acc.key, acc.region, acc.write)
                        )
                out.append(merged)
            else:  # "fuse"
                _, mi, ri, patch = step
                mop, rop = pending[mi], pending[ri]
                if patch:
                    _apply_patch(mop, patch)
                mp = mop.payload
                p = rop.payload
                node = OperationNode(
                    COMPUTE,
                    FusedMapReducePayload(
                        mp, p.ufunc_name, p.axes, p.dst_scratch, p.keepdims
                    ),
                    procs=mop.procs,
                    cost=mop.cost + rop.cost,
                    label=f"map+reduce:{p.ufunc_name}",
                )
                for a in mop.accesses:
                    if not a.write:
                        node.add_access(
                            AccessNode(a.key, a.region, write=False)
                        )
                node.add_access(
                    AccessNode(("s", p.dst_scratch), None, write=True)
                )
                out.append(node)
        new_deps = type(deps).rebuild(out) if entry.dirty else deps
        return new_deps, dict(entry.hints), replace(entry.stats)

    # -- introspection -------------------------------------------------------
    def entries(self) -> list:
        """Snapshot of resident entries (for on-demand re-verification)."""
        with self._lock:
            return list(self._entries.values())

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __repr__(self):
        return (
            f"PlanCache(n={len(self)}, hits={self.hits}, "
            f"misses={self.misses}, uncacheable={self.n_uncacheable})"
        )
