"""Wait attribution: charge every worker wait span to its cause.

The paper's metric — the fraction of worker time spent waiting on
communication — is a single number.  This module decomposes it: every
``wait-start``/``wait-end`` span in a trace is charged back to the
op or message that *ended* it, so "wait% = 9%" becomes "7% is the
halo-exchange transfers".

Charging rules per wait reason:

* ``empty-queue`` — the worker's ready queue was empty; the span ends
  when a newly-ready op arrives.  The charge goes to the op whose
  completion made the ender ready (the ``ready`` causality event), so a
  compute op that only became ready when its transfer delivered charges
  the *transfer*, not itself.  With no recorded cause the ender itself
  is charged.
* ``channel`` — the worker was blocked inside a synchronous channel
  post; the charge is the comm op itself.
* ``barrier`` — the main thread blocked in ``FlushTicket.wait``; the
  charge is the flush (reported separately from worker waits — it is
  not part of the per-worker wait fraction).

Spans are clipped to the union of the trace's drain segments
(``drain-begin``/``drain-end``): workers park on empty queues *between*
drains while the main thread records, and that parked time is not
latency — the clipping mirrors the ``Worker._idle_floor`` accounting of
:class:`~repro_torch.exec.stats.WaitStats`, which is why the report's
``wait_fraction`` agrees with the measured one.

Compute is charged from the clock ``WaitStats.compute_busy`` reads:

* blocks on the CPU — each compute slice's per-thread CPU delta (the
  ``compute-start``/``compute-end`` samples of ``time.thread_time()``),
  scaled by the clipped share of its wall extent;
* blocks on a CUDA device — each unit's (payload's or grouped
  launch's) device seconds from its gated event pair, which the
  executor emits as a ``compute-device`` event when the drain settles.
  A slice with device time is charged that and never its CPU delta, so
  no host launch time counts as compute.  The drain segment ends after
  the device has finished (as the makespan does), so device seconds
  need no clipping.

Offenders aggregate by *label group*: the op label up to its first
space / ``[`` (so ``xfer b3(0, 1)->p2`` and ``xfer b7(1, 1)->p3`` both
charge the group ``xfer``, while ``map:add`` and ``map+reduce:sum``
stay distinct).  Message traffic (count, bytes, mean post→deliver
latency) is attached per group from the ``msg-*`` events.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

__all__ = ["attribution", "AttributionReport", "WaitSpan"]


@dataclass
class WaitSpan:
    worker: object  # int rank, or "main" for barrier waits
    reason: str
    t0: float
    t1: float
    ender: Optional[int]  # uid of the op/message/flush that ended the wait

    @property
    def duration(self) -> float:
        return max(0.0, self.t1 - self.t0)


def _label_group(label: str, kind: str, uid) -> str:
    """Strip per-block/per-proc detail so spans aggregate by op family."""
    g = label.split(" ", 1)[0].split("[", 1)[0] if label else ""
    return g or f"{kind}#{uid}"


@dataclass
class AttributionReport:
    """Structured result of :func:`attribution`."""

    nworkers: int
    elapsed: float  # summed drain-segment wall-clock (trace-derived)
    total_compute: float  # summed compute-slice durations, clipped
    total_wait: float  # summed wait-span durations, clipped
    barrier_wait: float  # main-thread barrier time (not in total_wait)
    offenders: list = field(default_factory=list)  # dicts, sorted desc
    per_worker: dict = field(default_factory=dict)
    n_spans: int = 0
    dropped_events: int = 0

    @property
    def wait_fraction(self) -> float:
        """1 - compute/(nworkers*elapsed) — the same construction as
        :attr:`repro_torch.exec.stats.WaitStats.wait_fraction`, from trace
        spans instead of worker accounting."""
        total = self.nworkers * self.elapsed
        if total <= 0:
            return 0.0
        return max(0.0, 1.0 - self.total_compute / total)

    @property
    def span_wait_fraction(self) -> float:
        """Share of worker time covered by explicit wait spans."""
        total = self.nworkers * self.elapsed
        return self.total_wait / total if total > 0 else 0.0

    def top(self, k: int = 10) -> list:
        return self.offenders[:k]

    def format(self, k: int = 10) -> str:
        lines = [
            f"wait attribution — {self.nworkers} workers, "
            f"{self.elapsed * 1e3:.1f} ms traced drain time, "
            f"{self.n_spans} wait spans"
            + (f" ({self.dropped_events} events dropped)" if self.dropped_events else ""),
            f"  worker wait {self.total_wait * 1e3:.1f} worker-ms "
            f"({self.span_wait_fraction * 100:.1f}% of worker time; "
            f"compute {self.total_compute * 1e3:.1f} worker-ms, "
            f"wait_fraction {self.wait_fraction * 100:.1f}%)"
            + (f"; main-thread barrier {self.barrier_wait * 1e3:.1f} ms"
               if self.barrier_wait else ""),
        ]
        if not self.offenders:
            lines.append("  no wait spans to attribute")
            return "\n".join(lines)
        lines.append(
            f"  {'#':>2s}  {'offender':<24s} {'wait ms':>10s} {'share%':>7s} "
            f"{'spans':>6s}  detail"
        )
        denom = self.nworkers * self.elapsed
        for i, off in enumerate(self.offenders[:k], 1):
            detail = ""
            if off.get("n_msgs"):
                detail = (
                    f"{off['n_msgs']} msgs, {off['msg_bytes'] / 1e6:.2f} MB"
                )
                if off.get("msg_latency") is not None:
                    detail += f", mean post→deliver {off['msg_latency'] * 1e3:.2f} ms"
            if off.get("example"):
                detail = (detail + ", " if detail else "") + f"e.g. {off['example']!r}"
            share = off["seconds"] / denom * 100 if denom > 0 else 0.0
            lines.append(
                f"  {i:>2d}  {off['group']:<24s} {off['seconds'] * 1e3:10.2f} "
                f"{share:6.1f}% {off['n_spans']:>6d}  {detail}"
            )
        if len(self.offenders) > k:
            lines.append(f"  ... {len(self.offenders) - k} more sources")
        return "\n".join(lines)


def _clip(t0: float, t1: float, segments) -> float:
    """Overlap of [t0, t1] with the union of (sorted, disjoint) segments.
    With no segments recorded the span counts in full."""
    if not segments:
        return max(0.0, t1 - t0)
    total = 0.0
    for s0, s1 in segments:
        lo, hi = max(t0, s0), min(t1, s1)
        if hi > lo:
            total += hi - lo
    return total


def attribution(collector, k: Optional[int] = None) -> AttributionReport:
    """Build an :class:`AttributionReport` from a collector (``k`` is
    accepted for symmetry with ``report.top(k)`` but does not truncate
    the stored offender list)."""
    events = list(collector.events)
    ops = dict(collector.ops)
    last_ts = events[-1][0] if events else 0.0

    segments: list = []
    seg_open: dict = {}  # tag -> t0
    nworkers = 0
    ready_cause: dict = {}
    wait_open: dict = {}  # worker -> (t0, reason)
    spans: list[WaitSpan] = []
    comp_open: dict = {}  # worker -> (t0, cpu0)
    comp_spans: list = []  # (worker, t0, t1, cpu seconds or None)
    msg_posted: dict = {}  # uid -> ts
    msg_latency: dict = {}  # uid -> post->deliver seconds
    device: list = []  # (worker, unit's first uid, device seconds)

    for ts, et, uid, worker, extra in events:
        if et == "ready":
            if extra is not None:
                ready_cause[uid] = extra
        elif et == "wait-start":
            wait_open[worker] = (ts, extra)
        elif et == "wait-end":
            opened = wait_open.pop(worker, None)
            reason, ender = extra
            if opened is not None:
                spans.append(WaitSpan(worker, reason, opened[0], ts, ender))
        elif et == "compute-start":
            comp_open[worker] = (ts, extra)
        elif et == "compute-end":
            opened = comp_open.pop(worker, None)
            if opened is not None:
                t0, cpu0 = opened
                cpu = (
                    extra - cpu0
                    if isinstance(extra, float) and isinstance(cpu0, float)
                    else None
                )
                comp_spans.append((worker, t0, ts, cpu, uid))
        elif et == "compute-device":
            device.append((worker, uid, extra))
        elif et == "drain-begin":
            seg_open[uid] = ts
            nworkers = max(nworkers, extra[1])
        elif et == "drain-end":
            t0 = seg_open.pop(uid, None)
            if t0 is not None:
                segments.append((t0, ts))
        elif et == "msg-posted":
            msg_posted[uid] = ts
        elif et == "msg-delivered":
            t0 = msg_posted.get(uid)
            if t0 is not None:
                msg_latency[uid] = ts - t0

    # close anything still open at the end of the traced window
    for worker, (t0, reason) in wait_open.items():
        spans.append(WaitSpan(worker, reason, t0, last_ts, None))
    for tag, t0 in seg_open.items():
        segments.append((t0, last_ts))
    # merge overlapping drain segments into a disjoint union: concurrent
    # cone drains overlap in time, and clipping against raw overlapping
    # intervals would double-charge every span under them (and inflate
    # the traced elapsed, deflating wait_fraction)
    segments.sort()
    merged: list = []
    for s0, s1 in segments:
        if merged and s0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s1)
        else:
            merged.append([s0, s1])
    segments = [(s0, s1) for s0, s1 in merged]

    int_workers = {w for w in comp_open if isinstance(w, int)} | {
        s.worker for s in spans if isinstance(s.worker, int)
    } | {w for w, *_ in comp_spans if isinstance(w, int)} | {
        w for w, *_ in device if isinstance(w, int)
    }
    nworkers = max(nworkers, (max(int_workers) + 1) if int_workers else 0, 1)
    elapsed = sum(s1 - s0 for s0, s1 in segments)
    if elapsed <= 0.0 and events:
        elapsed = last_ts - events[0][0]

    per_worker: dict = {
        w: {"compute": 0.0, "empty-queue": 0.0, "channel": 0.0, "other": 0.0}
        for w in range(nworkers)
    }
    # compute charges use the slice's CPU-clock delta (what
    # WaitStats.compute_busy measures on the CPU) scaled by the clipped
    # share of its wall extent — the wall slice includes GIL preemption,
    # which the measured wait_fraction counts as *waiting*, not
    # computing; a device-timed slice is charged its device seconds
    total_compute = 0.0
    device_timed = set()
    for w, uid, seconds in device:
        device_timed.add(uid)
        total_compute += seconds
        if w in per_worker:
            per_worker[w]["compute"] += seconds
    for w, t0, t1, cpu, uid in comp_spans:
        if uid in device_timed:
            continue
        wall = max(0.0, t1 - t0)
        d = _clip(t0, t1, segments)
        if cpu is not None:
            d = cpu * (d / wall) if wall > 0 else 0.0
        total_compute += d
        if w in per_worker:
            per_worker[w]["compute"] += d

    def charge_of(span: WaitSpan):
        """(group, example label, msg uid or None) for one span."""
        if span.reason == "barrier":
            return (f"flush#{span.ender} barrier", "", None)
        ender = span.ender
        if ender is None:
            return ("(end of trace)", "", None)
        uid = ready_cause.get(ender, ender)
        kind, label, _ = ops.get(uid, ("?", "", 0))
        group = _label_group(label, kind, uid)
        return (group, label, uid if uid in msg_posted or kind == "comm" else None)

    agg: dict = {}
    total_wait = barrier_wait = 0.0
    n_spans = 0
    for span in spans:
        d = _clip(span.t0, span.t1, segments)
        if d <= 0.0:
            continue
        n_spans += 1
        group, example, msg_uid = charge_of(span)
        rec = agg.setdefault(
            group,
            {"group": group, "seconds": 0.0, "n_spans": 0, "example": "",
             "n_msgs": 0, "msg_bytes": 0, "msg_uids": set(), "latencies": []},
        )
        rec["seconds"] += d
        rec["n_spans"] += 1
        if example and not rec["example"]:
            rec["example"] = example
        if msg_uid is not None and msg_uid not in rec["msg_uids"]:
            rec["msg_uids"].add(msg_uid)
            rec["n_msgs"] += 1
            rec["msg_bytes"] += ops.get(msg_uid, ("?", "", 0))[2]
            if msg_uid in msg_latency:
                rec["latencies"].append(msg_latency[msg_uid])
        if span.reason == "barrier" or span.worker == "main":
            barrier_wait += d
        else:
            total_wait += d
            if span.worker in per_worker:
                key = span.reason if span.reason in ("empty-queue", "channel") else "other"
                per_worker[span.worker][key] += d

    offenders = []
    for rec in agg.values():
        lat = rec.pop("latencies")
        rec.pop("msg_uids")
        rec["msg_latency"] = sum(lat) / len(lat) if lat else None
        offenders.append(rec)
    offenders.sort(key=lambda r: r["seconds"], reverse=True)

    return AttributionReport(
        nworkers=nworkers,
        elapsed=elapsed,
        total_compute=total_compute,
        total_wait=total_wait,
        barrier_wait=barrier_wait,
        offenders=offenders,
        per_worker=per_worker,
        n_spans=n_spans,
        dropped_events=collector.dropped,
    )
