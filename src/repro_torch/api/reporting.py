"""Unified statistics rendering for simulated and measured runs.

``Runtime.stats()`` returns a
:class:`~repro_torch.core.timeline.TimelineResult` (discrete-event model) or a
:class:`~repro_torch.exec.stats.WaitStats` (wall-clock measurement).  Both
expose the same metric properties, but their ad-hoc ``summary()``
strings drifted apart; :func:`format_stats` renders any mix of the two
as one table with identical columns, units, and labels, tagging each
row ``simulated`` or ``measured`` — the single renderer used by the
benchmark driver's real-overlap section and the stencil example.
"""
from __future__ import annotations

__all__ = ["format_stats"]

_HEADER = (
    f"{'variant':<26s} {'source':>9s} {'makespan ms':>12s} {'wait%':>7s} "
    f"{'speedup':>8s} {'comm MB':>8s} {'ops c/m':>12s}"
)


def _source_of(stats) -> str:
    from repro_torch.exec.stats import WaitStats

    # serve.TenantStats wraps a WaitStats in .wait (plus a latency
    # histogram); it renders as a measured row
    inner = getattr(stats, "wait", stats)
    return "measured" if isinstance(inner, WaitStats) else "simulated"


def format_stats(
    rows, header: bool = True, dispatch: bool = True, per_worker: bool = False
) -> str:
    """Render stats as an aligned table.

    ``rows`` is an iterable of ``(label, stats)`` pairs (a single pair
    also works), where each ``stats`` is a ``TimelineResult`` or a
    ``WaitStats``.  Columns: makespan in ms, waiting-on-communication
    share in %, speedup vs. sequential, communicated MB, and
    compute/comm operation counts — the paper's two metrics plus the
    volume columns, identical for both sources.

    With ``dispatch=True`` (default) a ``dispatch:`` line per row shows
    the dispatch-overhead counters: drained ops per second, ops drained
    per flush (= per readback under demand-driven sync, where every
    readback is one cone flush), worker handoffs per flush, and channel
    messages per flush — measured rows only carry the last two (the
    simulator has no worker queues), shown as ``-`` otherwise.

    With ``per_worker=True``, each measured row is followed by an
    indented per-worker breakdown (compute / comm-wait / idle per rank)
    so skew between workers is visible without a full trace; simulated
    rows have no worker threads and are skipped.
    """
    if isinstance(rows, tuple) and len(rows) == 2 and isinstance(rows[0], str):
        rows = [rows]
    rows = list(rows)
    lines = [_HEADER] if header else []
    for label, st in rows:
        lines.append(
            f"{label:<26s} {_source_of(st):>9s} {st.makespan * 1e3:12.1f} "
            f"{st.wait_fraction * 100:6.1f}% {st.speedup:8.2f} "
            f"{st.comm_bytes / 1e6:8.2f} "
            f"{st.n_compute_ops:>7d}/{st.n_comm_ops:<4d}"
        )
    if dispatch:
        for label, st in rows:
            # the stats objects own the arithmetic; the simulator has no
            # worker queues or channel, so those columns render as "-"
            ops_s = f"{st.ops_per_sec:,.0f}" if st.makespan > 0 else "-"
            nfl = getattr(st, "n_flushes", 0)
            opf = (
                f"{(st.n_compute_ops + st.n_comm_ops) / nfl:,.0f}"
                if nfl else "-"
            )
            nh = getattr(st, "handoffs_per_flush", None)
            nm = getattr(st, "messages_per_flush", None)
            hand = "-" if nh is None else f"{nh:,.0f}"
            msgs = "-" if nm is None else f"{nm:,.0f}"
            lines.append(
                f"dispatch: {label:<26s} ops/s={ops_s:>12s} "
                f"ops/flush={opf:>9s} "
                f"handoffs/flush={hand:>8s} msgs/flush={msgs:>8s}"
            )
    # request-latency quantiles: rows carrying a latency histogram
    # (serve.TenantStats) get a latency: line with p50/p95/p99 and the
    # admission counters — absent for plain stats objects
    for label, st in rows:
        hist = getattr(st, "latency", None)
        if hist is None or not getattr(hist, "count", 0):
            continue
        extra = ""
        n_rej = getattr(st, "n_rejected", 0)
        n_fail = getattr(st, "n_failed", 0)
        if n_rej or n_fail:
            extra = f" rejected={n_rej} failed={n_fail}"
        lines.append(
            f"latency:  {label:<26s} n={hist.count:<7d} "
            f"p50={hist.p50 * 1e3:8.2f}ms p95={hist.p95 * 1e3:8.2f}ms "
            f"p99={hist.p99 * 1e3:8.2f}ms max={hist.max * 1e3:8.2f}ms"
            + extra
        )
    if per_worker:
        for label, st in rows:
            table = getattr(st, "per_worker_table", None)
            if table is None:  # simulated stats: no worker threads
                continue
            lines.append(f"per-worker: {label}")
            lines.extend("  " + ln for ln in table().splitlines())
    return "\n".join(lines)
