"""Static analysis over recorded graphs and planned op lists.

The pass pipeline, the dependency-cone extraction, and the
concurrent-drain conflict checks all rewrite or partition the recorded
graph on one invariant: every conflicting access pair of the original
program keeps its program order (§5.7).  This package *proves* that
invariant statically instead of trusting it:

* on demand — :func:`check` runs registered rules over whatever you
  hand it (pre/post plan op lists, concurrent cone footprints, a
  cross-rank message schedule) and returns an
  :class:`AnalysisReport` of :class:`Diagnostic` findings;
* automatically — ``ExecutionPolicy(verify="plan")`` verifies every
  flush's plan before it executes, ``verify="full"`` additionally runs
  the region-level race oracle over in-flight concurrent drains
  (:class:`~repro_torch.core.engine.Runtime` raises
  :class:`VerificationError` on an error-severity finding and aborts
  the flush);
* from the command line — ``python -m repro_torch.analysis`` runs the
  port's own programs (the Jacobi stencil, the overlap probe and the
  other paper apps) under ``verify="full"`` and exits non-zero on any
  diagnostic (the graph lint).

New rules plug in through :func:`repro_torch.register_rule`, mirroring the
pass/backend/channel registries.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.api.registry import (  # noqa: F401  (re-export)
    available_rules,
    get_rule,
    register_rule,
)

from .diagnostics import (  # noqa: F401
    ERROR,
    INFO,
    WARNING,
    AnalysisReport,
    Diagnostic,
    VerificationError,
    VerifyStats,
)
from .footprint import OpView, resolve_positions, snapshot_ops  # noqa: F401
from .rules import AnalysisContext, view_region_footprint  # noqa: F401

__all__ = [
    "check",
    "check_cached_plans",
    "AnalysisContext",
    "AnalysisReport",
    "Diagnostic",
    "VerificationError",
    "VerifyStats",
    "OpView",
    "snapshot_ops",
    "register_rule",
    "get_rule",
    "available_rules",
    "ERROR",
    "WARNING",
    "INFO",
]


def check(
    *,
    pre=None,
    post=None,
    dead_bases=(),
    provenance: Optional[dict] = None,
    dropped: Optional[dict] = None,
    scratch_available=(),
    cones=None,
    schedule=None,
    rules: Optional[Sequence[str]] = None,
) -> AnalysisReport:
    """Run static-analysis rules and return their findings.

    All inputs are optional; each rule silently skips what it cannot
    check from what was provided:

    ``pre`` / ``post``
        The operation list before and after planning (operation-nodes
        or ready-made :class:`OpView` snapshots, program order) — the
        ``"plan"`` rule's happens-before input, and the ``"deadlock"``
        rule's dangling-scratch input.
    ``dead_bases`` / ``provenance`` / ``dropped`` / ``scratch_available``
        Plan-stage context: GC'd base ids licensing dead-store
        elimination, the pass rewrite map (``new uid -> (pass_name,
        source uids)``) and drop map (``uid -> pass_name``) from
        :class:`~repro_torch.core.plan.PlanResult`, and scratch ids already
        delivered by earlier drains.
    ``cones``
        Cones assumed concurrent — a list of op lists (or ``(label,
        ops)`` pairs) — for the ``"races"`` region-level oracle.
    ``schedule``
        Per-rank rendezvous programs (lists of ``{"kind":
        "send"|"recv"|"compute", "tag": ..., "peer": ...}`` dicts) for
        the ``"deadlock"`` rule's static fig. 6 cycle detection.
    ``rules``
        Names to run (default: every registered rule).

    Returns an :class:`AnalysisReport`; call
    :meth:`~AnalysisReport.raise_if_errors` to turn error findings into
    :class:`VerificationError`.
    """
    ctx = AnalysisContext(
        pre=snapshot_ops(list(pre)) if pre is not None else None,
        post=snapshot_ops(list(post)) if post is not None else None,
        dead_bases=set(dead_bases or ()),
        provenance=dict(provenance or {}),
        dropped=dict(dropped or {}),
        scratch_available=set(scratch_available or ()),
        cones=list(cones) if cones is not None else None,
        schedule=list(schedule) if schedule is not None else None,
    )
    names = tuple(rules) if rules is not None else tuple(available_rules())
    for name in names:
        get_rule(name)(ctx)
    ctx.report.rules_run = names
    return ctx.report


def check_cached_plans(cache, rules: Sequence[str] = ("plan", "deadlock")):
    """Re-verify every resident plan-shape-cache entry
    (:class:`repro_torch.core.plan_cache.PlanCache`) — each entry retains the
    pre/post footprint snapshots, rewrite provenance, and drop records
    of its insert-time plan, so the static plan verifier can re-prove
    the cached recipe sound on demand (the ``graph-lint`` story for
    cached plans).  Returns one :class:`AnalysisReport` per entry, in
    cache order; callers decide whether errors raise
    (:meth:`AnalysisReport.raise_if_errors`)."""
    reports = []
    for entry in cache.entries():
        reports.append(check(
            pre=entry.pre_views,
            post=entry.post_views,
            dead_bases=entry.dead_bases,
            provenance=entry.provenance,
            dropped=entry.dropped,
            scratch_available=entry.scratch_available,
            rules=rules,
        ))
    return reports
