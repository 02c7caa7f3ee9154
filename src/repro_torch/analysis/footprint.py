"""Region-precise access footprints for the static analyses.

The plan verifier compares *pre-plan* against *post-plan* footprints.
Pre-plan operation objects are NOT a stable snapshot: passes like the
fill→map constant folder mutate payload argument lists and rebuild
access lists in place, so the verifier snapshots every op into plain
immutable :class:`OpView` records **before** the pipeline runs.

A snapshot reconstructs the op's full §5.7 footprint, including the
*implicit* read of non-initializing combines/matmuls (their access
lists only carry the write, but the executor reads the block first —
the same reconstruction :func:`repro_torch.core.plan.op_reads` does).
"""
from __future__ import annotations

from typing import Iterable, Optional

__all__ = ["OpView", "snapshot_ops", "resolve_positions"]


class OpView:
    """Immutable footprint snapshot of one operation-node.

    ``accesses`` is a tuple of ``(key, region, write)`` triples; regions
    are the recorded per-dimension ``(lo, hi)`` tuples (``None`` = whole
    block).  Implicit read-modify-write reads are materialized as
    explicit read triples.
    """

    __slots__ = ("uid", "kind", "label", "accesses")

    def __init__(self, uid, kind, label, accesses):
        self.uid = uid
        self.kind = kind
        self.label = label
        self.accesses = accesses

    def __repr__(self):
        return f"OpView(uid={self.uid}, label={self.label!r})"

    @property
    def writes(self) -> Iterable[tuple]:
        return ((k, r) for k, r, w in self.accesses if w)

    @property
    def reads(self) -> Iterable[tuple]:
        return ((k, r) for k, r, w in self.accesses if not w)


def snapshot_ops(ops) -> list[OpView]:
    """Snapshot operation-nodes (or pass through ready-made
    :class:`OpView` lists) into immutable footprint records."""
    if ops and isinstance(ops[0], OpView):
        return list(ops)
    from repro_torch.core.engine import CombinePayload, MatmulPayload

    out = []
    for op in ops:
        acc = [(a.key, a.region, bool(a.write)) for a in op.accesses]
        p = op.payload
        if isinstance(p, (CombinePayload, MatmulPayload)) and not p.init:
            # non-initializing accumulation: the write target is also read
            acc.extend(
                (a.key, a.region, False) for a in op.accesses if a.write
            )
        out.append(OpView(op.uid, op.kind, op.label, tuple(acc)))
    return out


def resolve_positions(
    pre: list[OpView],
    post: list[OpView],
    provenance: Optional[dict] = None,
) -> dict:
    """Map every *pre*-plan uid to the index of the post-plan node that
    carries it: itself when it survived verbatim, the merged node when a
    pass recorded ``provenance[new_uid] = (pass_name, (src_uid, ...))``
    for it (chains of rewrites are followed), or absent when it was
    dropped entirely."""
    post_index = {op.uid: j for j, op in enumerate(post)}
    rewritten_into: dict = {}
    for new_uid, (_pass, srcs) in (provenance or {}).items():
        for src in srcs:
            rewritten_into[src] = new_uid
    positions: dict = {}
    for op in pre:
        v, hops = op.uid, 0
        while v not in post_index and v in rewritten_into and hops < len(pre) + 1:
            v = rewritten_into[v]
            hops += 1
        if v in post_index:
            positions[op.uid] = post_index[v]
    return positions
