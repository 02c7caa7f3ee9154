"""The built-in static-analysis rules.

Three rules, registered under the same plugin registry pattern as
passes/backends (``repro_torch.register_rule``):

* ``"plan"`` — the happens-before plan verifier.  Reconstructs the
  region-precise read/write footprint of every pre-plan and post-plan
  operation and proves that each conflicting access pair of the
  original program survives planning **in order** (§5.7: insertion
  order is the total order of conflicting accesses).  Catches
  dependence-inverting rewrites, dead-store elimination of live
  stores, stores a rewrite silently elided, and merged payloads whose
  combined footprint hoists a read past a conflicting write.  Findings
  carry pass provenance from the obs ``rewritten``/``dropped`` events.
* ``"races"`` — region-level race detector for concurrent cone drains:
  every pair of cones assumed concurrent is re-checked at ``Region``
  granularity — a soundness oracle for the key-granular
  :func:`~repro_torch.core.graph.cones_conflict` — and key-level conflicts
  that are region-level false positives are counted as the precision
  report.
* ``"deadlock"`` — static deadlock detection: cycles in the cross-rank
  rendezvous message schedule (the paper's fig. 6 pattern, rejected at
  plan time instead of the runtime refusal), plus dangling scratch
  reads in a planned op list (a consumer whose producer a broken pass
  dropped would stall the drain).

Every rule no-ops when its inputs are absent from the
:class:`AnalysisContext`, so :func:`repro_torch.analysis.check` can run any
subset over whatever the caller has.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.api.registry import register_rule

from .diagnostics import ERROR, INFO, AnalysisReport, Diagnostic
from .footprint import OpView, resolve_positions, snapshot_ops

__all__ = ["AnalysisContext", "check_plan", "check_races", "check_deadlock"]


@dataclass
class AnalysisContext:
    """Everything a rule may inspect.  All inputs optional — a rule
    skips silently when what it needs is missing."""

    pre: Optional[list] = None  # pre-plan OpViews, program order
    post: Optional[list] = None  # post-plan OpViews, planned order
    dead_bases: set = field(default_factory=set)
    provenance: dict = field(default_factory=dict)  # new uid -> (pass, srcs)
    dropped: dict = field(default_factory=dict)  # dropped uid -> pass
    scratch_available: set = field(default_factory=set)  # delivered sids
    cones: Optional[list] = None  # [(label, [OpView])] assumed concurrent
    schedule: Optional[list] = None  # per-rank rendezvous programs
    report: AnalysisReport = field(default_factory=AnalysisReport)
    _positions: Optional[dict] = None

    @property
    def positions(self) -> dict:
        """pre uid -> post index (absent = dropped), provenance-chased."""
        if self._positions is None:
            self._positions = resolve_positions(
                self.pre or [], self.post or [], self.provenance
            )
        return self._positions

    def emit(self, rule, severity, message, ops=(), key=None, pass_name=None):
        self.report.diagnostics.append(
            Diagnostic(rule, severity, message, tuple(ops), key, pass_name)
        )


def _name(op: OpView) -> str:
    return f"{op.label or 'op'}#{op.uid}"


def _is_scratch(key) -> bool:
    return isinstance(key, tuple) and len(key) == 2 and key[0] == "s"


# ---------------------------------------------------------------------------
# rule "plan": happens-before plan verifier
# ---------------------------------------------------------------------------


@register_rule("plan")
def check_plan(ctx: AnalysisContext) -> None:
    if ctx.pre is None or ctx.post is None:
        return
    from repro_torch.core.graph import regions_overlap
    from repro_torch.core.plan import region_covers

    pre, post = ctx.pre, ctx.post
    positions = ctx.positions
    dead = ctx.dead_bases or set()

    def blame(post_idx: Optional[int]) -> Optional[str]:
        if post_idx is None:
            return None
        entry = ctx.provenance.get(post[post_idx].uid)
        return entry[0] if entry else None

    # one forward walk builds the per-key access history (for the order
    # check) and the read index (for the store-liveness checks)
    hist: dict = {}  # key -> [(pre_pos, region, write, uid, post_pos)]
    reads_by_key: dict = {}  # key -> [(pre_pos, region, uid)]
    maxw: dict = {}  # key -> max post position over earlier writes
    maxr: dict = {}  # key -> max post position over earlier reads
    seen_pairs: set = set()
    for i, op in enumerate(pre):
        pos = positions.get(op.uid)
        for key, region, write in op.accesses:
            if not write:
                reads_by_key.setdefault(key, []).append((i, region, op.uid))
            if pos is not None:
                # fast path: the §5.7 common case is that nothing moved —
                # a surviving access at post position >= every earlier
                # conflicting access's position proves the pair order
                # survived without enumerating pairs (O(1) per access)
                ok = pos >= maxw.get(key, -1)
                if ok and write:
                    ok = pos >= maxr.get(key, -1)
                if not ok:
                    # precise scan: only a *conflicting* earlier access
                    # now placed after us is a real inversion (merged
                    # nodes share a position and are exempt)
                    for ppos, pregion, pwrite, puid, ppost in hist.get(key, ()):
                        if ppost is None or ppost <= pos:
                            continue
                        if not (write or pwrite):
                            continue
                        if not regions_overlap(region, pregion):
                            continue
                        pair = (puid, op.uid, key)
                        if pair in seen_pairs:
                            continue
                        seen_pairs.add(pair)
                        ctx.emit(
                            "plan", ERROR,
                            f"conflicting access pair inverted: "
                            f"{_name(pre[ppos])} precedes {_name(op)} in "
                            f"program order but the plan executes it after",
                            ops=(puid, op.uid), key=key,
                            pass_name=blame(pos) or blame(ppost),
                        )
            hist.setdefault(key, []).append((i, region, write, op.uid, pos))
            if pos is not None:
                if write:
                    if pos > maxw.get(key, -1):
                        maxw[key] = pos
                else:
                    if pos > maxr.get(key, -1):
                        maxr[key] = pos

    # store liveness: a write may only vanish from the plan when its
    # base is dead *and* no surviving later operation reads the region
    post_writes = [
        [(k, r) for k, r, w in op.accesses if w] for op in post
    ]

    def _check_lost_store(i, op, key, region, node_pos, pname):
        """A write of pre op ``op`` (at pre position ``i``) is absent
        from the planned graph (``node_pos`` = the surviving node it
        merged into, or None when the whole op was dropped)."""
        base = key[0]
        live = not _is_scratch(key) and base not in dead
        readers = [
            uid for rpos, rregion, uid in reads_by_key.get(key, ())
            if rpos > i
            and uid in positions
            and positions[uid] != node_pos
            and regions_overlap(region, rregion)
        ]
        if live:
            ctx.emit(
                "plan", ERROR,
                f"store of {_name(op)} to live base {base} was "
                f"{'elided by a rewrite' if node_pos is not None else 'dropped'}"
                f" — the base is still gatherable",
                ops=(op.uid,), key=key, pass_name=pname,
            )
        elif readers:
            ctx.emit(
                "plan", ERROR,
                f"store of {_name(op)} was "
                f"{'elided' if node_pos is not None else 'dropped'} as dead "
                f"but {len(readers)} later surviving operation(s) still "
                f"read the stored region",
                ops=(op.uid, *readers), key=key, pass_name=pname,
            )

    for i, op in enumerate(pre):
        pos = positions.get(op.uid)
        if pos is None:
            pname = ctx.dropped.get(op.uid)
            for key, region, write in op.accesses:
                if write:
                    _check_lost_store(i, op, key, region, None, pname)
            continue
        for key, region, write in op.accesses:
            if not write:
                continue
            covered = any(
                k == key and region_covers(r, region)
                for k, r in post_writes[pos]
            )
            if not covered:
                _check_lost_store(i, op, key, region, pos, blame(pos))


# ---------------------------------------------------------------------------
# rule "races": region-level race detector for concurrent cones
# ---------------------------------------------------------------------------


def _view_key_footprint(views) -> tuple[set, set]:
    reads: set = set()
    writes: set = set()
    for op in views:
        for key, _region, write in op.accesses:
            (writes if write else reads).add(key)
    return reads, writes


def view_region_footprint(views) -> dict:
    """Region-precise footprint of a cone of :class:`OpView` snapshots:
    ``key -> ([read regions], [write regions])``, with a whole-block
    access collapsing its list to ``[None]``."""
    fp: dict = {}
    for op in views:
        for key, region, write in op.accesses:
            entry = fp.get(key)
            if entry is None:
                entry = fp[key] = ([], [])
            lst = entry[1] if write else entry[0]
            if lst and lst[0] is None:
                continue
            if region is None:
                lst[:] = [None]
            else:
                lst.append(region)
    return fp


@register_rule("races")
def check_races(ctx: AnalysisContext) -> None:
    if not ctx.cones:
        return
    # key-granular verdicts come from the *current* cones_conflict (the
    # function under test when this rule is used as a soundness oracle)
    from repro_torch.core import graph as _graph
    from repro_torch.core.graph import region_footprints_conflict

    cones = []
    for entry in ctx.cones:
        label, ops = entry if isinstance(entry, tuple) else (None, entry)
        views = snapshot_ops(list(ops))
        cones.append((
            label if label is not None else f"cone{len(cones)}",
            _view_key_footprint(views),
            view_region_footprint(views),
        ))
    for i in range(len(cones)):
        for j in range(i + 1, len(cones)):
            la, ka, ra = cones[i]
            lb, kb, rb = cones[j]
            kc = _graph.cones_conflict(ka, kb)
            rk = region_footprints_conflict(ra, rb)
            if kc:
                ctx.report.n_key_conflicts += 1
                if rk is None:
                    ctx.report.n_region_false_positives += 1
                    ctx.emit(
                        "races", INFO,
                        f"cones {la!r} and {lb!r} conflict at key "
                        f"granularity but their regions are disjoint "
                        f"(serialization is a precision loss, not a "
                        f"correctness need)",
                    )
            elif rk is not None:
                ctx.emit(
                    "races", ERROR,
                    f"cones {la!r} and {lb!r} race: their region-level "
                    f"footprints overlap with a write, but the key-granular "
                    f"conflict check lets them drain concurrently",
                    key=rk,
                )


# ---------------------------------------------------------------------------
# rule "deadlock": message-schedule cycles + dangling scratch reads
# ---------------------------------------------------------------------------


def _format_msg_op(rank, step, kind, tag, peer) -> str:
    # same line format as the runtime refusal in
    # repro_torch.exec.backend.run_rendezvous_bsp_async — tooling keys on it
    return f"p{rank}@step{step}: {kind} tag={tag!r} peer=p{peer}"


def _check_schedule(ctx: AnalysisContext) -> None:
    """Static fig. 6 analysis: match the k-th send p→q with tag t to
    the k-th recv at q from p with tag t (the canonical rendezvous
    matching of a deterministic program), collapse each matched pair
    into one node (both sides block until both arrive), add each rank's
    program-order edges, and look for a cycle."""
    schedule = ctx.schedule
    occ: dict = {}
    members: dict = {}  # pair key -> [(rank, step, kind, tag, peer)]
    rank_chains: list = []  # per rank: [pair key, ...] in program order
    for rank, prog in enumerate(schedule):
        chain = []
        for step, op in enumerate(prog):
            kind = op.get("kind")
            if kind not in ("send", "recv"):
                continue  # compute never blocks
            peer, tag = op["peer"], op["tag"]
            src, dst = (rank, peer) if kind == "send" else (peer, rank)
            k = occ.get((src, dst, tag, kind), 0)
            occ[(src, dst, tag, kind)] = k + 1
            pair = (src, dst, tag, k)
            members.setdefault(pair, []).append((rank, step, kind, tag, peer))
            chain.append(pair)
        rank_chains.append(chain)
    for pair, ops in members.items():
        if len(ops) != 2:
            rank, step, kind, tag, peer = ops[0]
            ctx.emit(
                "deadlock", ERROR,
                f"unmatched two-sided message — "
                f"{_format_msg_op(rank, step, kind, tag, peer)} has no "
                f"rendezvous partner and blocks forever once reached",
                key=pair[:3],
            )
    edges: dict = {}
    for chain in rank_chains:
        for a, b in zip(chain, chain[1:]):
            edges.setdefault(a, set()).add(b)
    # iterative DFS cycle detection over the pair-node graph
    WHITE, GREY, BLACK = 0, 1, 2
    color = {p: WHITE for p in members}
    for start in members:
        if color[start] != WHITE:
            continue
        stack = [(start, iter(edges.get(start, ())))]
        color[start] = GREY
        path = [start]
        while stack:
            node, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                color[node] = BLACK
                stack.pop()
                path.pop()
                continue
            if color[nxt] == GREY:
                cycle = path[path.index(nxt):]
                lines = sorted(
                    _format_msg_op(*op) for p in cycle for op in members[p]
                )
                ctx.emit(
                    "deadlock", ERROR,
                    "rendezvous cycle across ranks (paper fig. 6) — every "
                    "participant waits on a partner later in another "
                    "rank's program.\nstuck operation-nodes:\n  "
                    + "\n  ".join(lines),
                    key=None,
                )
                return
            if color[nxt] == WHITE:
                color[nxt] = GREY
                path.append(nxt)
                stack.append((nxt, iter(edges.get(nxt, ()))))


def _check_dangling_scratch(ctx: AnalysisContext) -> None:
    """A planned op reading a scratch buffer no earlier planned op
    writes (and that previous drains did not already deliver) can never
    become ready — the drain stalls (or the executor crashes on the
    missing buffer).  This is the planned-graph liveness complement of
    the message-schedule cycle check."""
    avail = set(ctx.scratch_available or ())
    drop_blame: dict = {}
    for op in ctx.pre or ():
        if op.uid in ctx.dropped:
            for key, _region, write in op.accesses:
                if write and _is_scratch(key):
                    drop_blame[key[1]] = ctx.dropped[op.uid]
    for op in ctx.post:
        for key, _region, write in op.accesses:
            if write or not _is_scratch(key):
                continue
            sid = key[1]
            if sid not in avail:
                ctx.emit(
                    "deadlock", ERROR,
                    f"{_name(op)} reads scratch buffer {sid} that no "
                    f"earlier planned operation writes and no previous "
                    f"drain delivered — the drain would stall",
                    ops=(op.uid,), key=key,
                    pass_name=drop_blame.get(sid),
                )
        for key, _region, write in op.accesses:
            if write and _is_scratch(key):
                avail.add(key[1])


@register_rule("deadlock")
def check_deadlock(ctx: AnalysisContext) -> None:
    if ctx.schedule is not None:
        _check_schedule(ctx)
    if ctx.post is not None:
        _check_dangling_scratch(ctx)
