"""Diagnostic objects shared by every analysis rule.

A :class:`Diagnostic` is one finding: which rule fired, how severe it
is, a human-readable message, and — when known — the operation uids,
the access key, and the plan pass whose rewrite is to blame (recovered
from the obs ``rewritten``/``dropped`` provenance events the passes
emit through :meth:`~repro_torch.core.plan.PlanContext.note_rewrite`).

:class:`AnalysisReport` is the result of one :func:`repro_torch.analysis.check`
run; :meth:`AnalysisReport.raise_if_errors` turns error-severity
findings into a :class:`VerificationError` — what
``ExecutionPolicy(verify=...)`` raises from inside ``Runtime.flush``
*before* an unsound plan reaches the executor.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

__all__ = [
    "Diagnostic",
    "AnalysisReport",
    "VerificationError",
    "VerifyStats",
    "ERROR",
    "WARNING",
    "INFO",
]

ERROR = "error"
WARNING = "warning"
INFO = "info"
_SEVERITIES = (ERROR, WARNING, INFO)


@dataclass(frozen=True)
class Diagnostic:
    """One static-analysis finding."""

    rule: str  # registered rule name ("plan", "races", "deadlock", ...)
    severity: str  # "error" | "warning" | "info"
    message: str
    ops: tuple = ()  # operation uids (or drain tags) involved
    key: Optional[tuple] = None  # the access key the finding anchors on
    pass_name: Optional[str] = None  # blamed plan pass, when known

    def __post_init__(self):
        if self.severity not in _SEVERITIES:
            raise ValueError(
                f"severity must be one of {_SEVERITIES}, got {self.severity!r}"
            )

    def __str__(self) -> str:
        where = ""
        if self.key is not None:
            where = f" [key={self.key!r}]"
        blame = f" (pass: {self.pass_name})" if self.pass_name else ""
        return f"{self.rule}/{self.severity}: {self.message}{where}{blame}"


@dataclass
class AnalysisReport:
    """All diagnostics from one :func:`repro_torch.analysis.check` run, plus
    the precision counters the region race detector accumulates."""

    diagnostics: list[Diagnostic] = field(default_factory=list)
    # region-precision accounting (the carried-over sub-block cone
    # precision roadmap item feeds on this): how often the key-granular
    # cones_conflict over-approximated the region-precise answer
    n_key_conflicts: int = 0
    n_region_false_positives: int = 0
    rules_run: tuple = ()

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def ok(self) -> bool:
        return not self.errors

    def extend(self, other: "AnalysisReport") -> "AnalysisReport":
        self.diagnostics.extend(other.diagnostics)
        self.n_key_conflicts += other.n_key_conflicts
        self.n_region_false_positives += other.n_region_false_positives
        return self

    def raise_if_errors(self) -> None:
        if self.errors:
            raise VerificationError(self)

    def format(self) -> str:
        if not self.diagnostics:
            return "no diagnostics"
        return "\n".join(str(d) for d in self.diagnostics)

    def __str__(self) -> str:
        return self.format()


class VerificationError(RuntimeError):
    """An error-severity diagnostic was found — the plan (or the
    concurrent-drain schedule) is provably unsound; the flush that
    produced it is aborted before anything executes."""

    def __init__(self, report: AnalysisReport):
        self.report = report
        errs = report.errors
        lines = "\n".join(f"  {d}" for d in errs)
        super().__init__(
            f"static verification failed with {len(errs)} error(s):\n{lines}"
        )


@dataclass
class VerifyStats:
    """Counters a verifying :class:`~repro_torch.core.engine.Runtime`
    accumulates across flushes (``Runtime.verify_stats``)."""

    n_flushes_verified: int = 0
    n_race_checks: int = 0  # in-flight ticket pairs examined (verify=full)
    n_diagnostics: int = 0
    n_key_conflicts: int = 0
    n_region_false_positives: int = 0
    verify_seconds: float = 0.0  # wall time inside the verifier itself

    @property
    def precision(self) -> Optional[float]:
        """Fraction of key-level cone conflicts that were real at
        region granularity (``None`` until a conflict was observed)."""
        if self.n_key_conflicts == 0:
            return None
        return 1.0 - self.n_region_false_positives / self.n_key_conflicts
