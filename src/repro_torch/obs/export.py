"""Chrome-trace / Perfetto JSON export of a :class:`TraceCollector`.

:func:`export_trace` converts the collector's raw event tuples into the
Chrome Trace Event format (the JSON flavour Perfetto's UI loads
directly — open https://ui.perfetto.dev and drop the file in):

* **pid 1 "runtime (main)"** — flush instants, ``drain#N`` slices
  bracketing each executor drain segment, plan-pass instants, rewrite
  provenance instants, and main-thread barrier waits;
* **pid 2 "workers"** — one thread row per worker rank, with ``X``
  slices for every compute payload (named by the op label) and for
  every wait span (``wait:empty-queue`` / ``wait:channel``);
* **pid 10+** — one process per channel, with async ``b``/``n``/``e``
  events per message (post → progress → deliver), so in-flight message
  latency is a visible horizontal bar;
* **pid 4 "counters"** — ``C`` events for every sampled gauge (queue
  depths, in-flight ops/messages, batch occupancy, cone sizes);
* **flow arrows** — a ``s``→``f`` flow from each message's delivery to
  the compute slice it unblocked (derived from the ``ready`` causality
  events), which is the latency-hiding picture itself: arrows that land
  on already-busy workers are hidden latency, arrows that land on
  waiting workers are exposed latency.

:func:`validate_trace` is the schema check used by the tests and by
``chip_smoke.py``: structural validation of the emitted JSON (known
phase types, numeric timestamps, balanced async begin/end, named
complete events) without any external dependency.
"""
from __future__ import annotations

import json
from typing import Optional, Union

__all__ = ["export_trace", "validate_trace"]

PID_RUNTIME = 1
PID_WORKERS = 2
PID_COUNTERS = 4
PID_CHANNEL0 = 10  # one pid per channel name, counting up from here

_KNOWN_PH = {"X", "B", "E", "b", "n", "e", "i", "I", "s", "t", "f", "C", "M"}


def _us(ts: float) -> float:
    return round(ts * 1e6, 3)


def export_trace(collector, path: Optional[str] = None, full: bool = False) -> dict:
    """Render ``collector`` as a Chrome-trace dict; write JSON to
    ``path`` when given.  ``full=True`` additionally emits one instant
    per ``recorded``/``enqueued``/``dequeued``/``ready`` event (off by
    default — they dominate the file size on large graphs without
    changing the timeline picture)."""
    events = list(collector.events)
    ops = collector.ops
    te: list[dict] = []

    def meta(pid: int, name: str) -> None:
        te.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                   "args": {"name": name}})

    meta(PID_RUNTIME, "runtime (main)")
    meta(PID_WORKERS, "workers")
    meta(PID_COUNTERS, "counters")

    def label_of(uid) -> str:
        kind, label, _ = ops.get(uid, ("?", "", 0))
        return label or f"{kind}#{uid}"

    chan_pids: dict[str, int] = {}

    def chan_pid(chan: str) -> int:
        pid = chan_pids.get(chan)
        if pid is None:
            pid = PID_CHANNEL0 + len(chan_pids)
            chan_pids[chan] = pid
            meta(pid, f"channel:{chan}")
        return pid

    worker_tids: set = set()
    # device seconds of a compute unit, keyed by its first op's uid (CUDA
    # blocks: emitted when the drain settles, after the slice closed)
    device_s = {uid: extra for _ts, et, uid, _w, extra in events
                if et == "compute-device"}
    comp_open: dict = {}  # worker -> (ts, uid)
    wait_open: dict = {}  # worker -> (ts, reason)
    comp_start: dict = {}  # uid -> (ts, worker) — flow targets
    delivered: dict = {}  # msg uid -> (ts, chan)
    cause: dict = {}  # uid -> cause uid
    posted: set = set()  # msg uids whose "b" survived the ring buffer
    open_drains: set = set()  # drain tags whose "b" survived the buffer
    flush_of = getattr(collector, "flush_of", {})  # uid -> drain tag

    # non-worker wait spans (main thread, serve client threads) render as
    # enumerated rows on the runtime process; "main" is always tid 0
    runtime_tids: dict = {"main": 0}

    def runtime_tid(label) -> int:
        tid = runtime_tids.get(label)
        if tid is None:
            tid = len(runtime_tids)
            runtime_tids[label] = tid
        return tid

    for ts, et, uid, worker, extra in events:
        t = _us(ts)
        if et == "compute-start":
            comp_open[worker] = (ts, uid, extra)
            if uid not in comp_start:
                comp_start[uid] = (ts, worker)
        elif et == "compute-end":
            opened = comp_open.pop(worker, None)
            if opened is not None:
                worker_tids.add(worker)
                args = {"uid": uid}
                fid = flush_of.get(uid)
                if fid is not None:
                    args["flush"] = fid
                if isinstance(extra, float) and isinstance(opened[2], float):
                    # CPU time of the slice; the wall extent additionally
                    # contains GIL/scheduler preemption
                    args["cpu_us"] = _us(max(0.0, extra - opened[2]))
                if uid in device_s:
                    # the unit's device time (its gated event pair)
                    args["device_us"] = _us(device_s[uid])
                te.append({"ph": "X", "cat": "compute", "name": label_of(uid),
                           "pid": PID_WORKERS, "tid": worker,
                           "ts": _us(opened[0]), "dur": max(0.0, t - _us(opened[0])),
                           "args": args})
        elif et == "wait-start":
            wait_open[worker] = (ts, extra)
        elif et == "wait-end":
            opened = wait_open.pop(worker, None)
            if opened is not None:
                reason, ender = extra
                if isinstance(worker, int):
                    pid, tid = PID_WORKERS, worker
                    worker_tids.add(worker)
                else:  # "main", "client-<tid>", ... — runtime-side waits
                    pid, tid = PID_RUNTIME, runtime_tid(worker)
                te.append({"ph": "X", "cat": "wait", "name": f"wait:{reason}",
                           "pid": pid, "tid": tid,
                           "ts": _us(opened[0]), "dur": max(0.0, t - _us(opened[0])),
                           "args": {"ender": ender}})
        elif et == "msg-posted":
            chan, src, dst, nbytes = extra
            posted.add(uid)
            te.append({"ph": "b", "cat": "msg", "name": label_of(uid),
                       "id": uid, "pid": chan_pid(chan), "tid": 0, "ts": t,
                       "args": {"src": src, "dst": dst, "nbytes": nbytes}})
        elif et == "msg-progressed":
            if uid in posted:
                te.append({"ph": "n", "cat": "msg", "name": "progressed",
                           "id": uid, "pid": chan_pid(extra), "tid": 0, "ts": t})
        elif et == "msg-delivered":
            delivered[uid] = (ts, extra)
            if uid in posted:
                posted.discard(uid)
                te.append({"ph": "e", "cat": "msg", "name": label_of(uid),
                           "id": uid, "pid": chan_pid(extra), "tid": 0, "ts": t})
        elif et == "drain-begin":
            # async ("b"/"e", keyed by tag) rather than nested ("B"/"E"):
            # concurrent cone drains interleave, and a stack-based E would
            # close the wrong segment
            open_drains.add(uid)
            te.append({"ph": "b", "cat": "drain", "name": f"drain#{uid}",
                       "id": str(uid), "pid": PID_RUNTIME, "tid": 0, "ts": t,
                       "args": {"n_pending": extra[0], "nworkers": extra[1]}})
        elif et == "drain-end":
            if uid in open_drains:  # an end whose begin fell off the ring
                open_drains.discard(uid)  # buffer has no segment to close
                te.append({"ph": "e", "cat": "drain", "name": f"drain#{uid}",
                           "id": str(uid), "pid": PID_RUNTIME, "tid": 0,
                           "ts": t})
        elif et == "flush-begin":
            n_total, n_cone, sync, backend = extra
            te.append({"ph": "i", "s": "p", "cat": "flush",
                       "name": f"flush#{uid}", "pid": PID_RUNTIME, "tid": 0,
                       "ts": t, "args": {"n_pending": n_total, "n_cone": n_cone,
                                         "sync": sync, "backend": backend}})
        elif et == "plan-pass":
            name, n_in, n_out = extra
            te.append({"ph": "i", "s": "t", "cat": "plan",
                       "name": f"pass:{name}", "pid": PID_RUNTIME, "tid": 0,
                       "ts": t, "args": {"ops_in": n_in, "ops_out": n_out}})
        elif et == "rewritten":
            pass_name, srcs = extra
            te.append({"ph": "i", "s": "t", "cat": "plan",
                       "name": f"rewrite:{pass_name}", "pid": PID_RUNTIME,
                       "tid": 0, "ts": t,
                       "args": {"uid": uid, "label": label_of(uid),
                                "sources": list(srcs)}})
        elif et == "dropped":
            te.append({"ph": "i", "s": "t", "cat": "plan",
                       "name": f"drop:{extra}", "pid": PID_RUNTIME,
                       "tid": 0, "ts": t,
                       "args": {"uid": uid, "label": label_of(uid),
                                "pass": extra}})
        elif et == "plan-cache":
            hit, n_ops = extra
            te.append({"ph": "i", "s": "t", "cat": "plan",
                       "name": f"plan-cache:{'hit' if hit else 'miss'}",
                       "pid": PID_RUNTIME, "tid": 0, "ts": t,
                       "args": {"flush": uid, "ops": n_ops}})
        elif et == "lock-held":
            te.append({"ph": "i", "s": "t", "cat": "serve",
                       "name": f"lock:{uid}", "pid": PID_RUNTIME, "tid": 0,
                       "ts": t, "args": {"held_ms": extra * 1e3}})
        elif et == "counter":
            te.append({"ph": "C", "cat": "gauge", "name": uid,
                       "pid": PID_COUNTERS, "tid": 0, "ts": t,
                       "args": {"value": extra}})
        elif et == "ready":
            if extra is not None:
                cause[uid] = extra
            if full:
                te.append({"ph": "i", "s": "t", "cat": "lifecycle",
                           "name": f"ready:{label_of(uid)}", "pid": PID_RUNTIME,
                           "tid": 0, "ts": t, "args": {"uid": uid, "cause": extra}})
        elif full and et in ("recorded", "enqueued", "dequeued"):
            pid, tid = (PID_RUNTIME, 0)
            if et != "recorded" and worker is not None:
                pid, tid = PID_WORKERS, worker
                worker_tids.add(worker)
            te.append({"ph": "i", "s": "t", "cat": "lifecycle",
                       "name": f"{et}:{label_of(uid)}", "pid": pid, "tid": tid,
                       "ts": t, "args": {"uid": uid}})

    # close still-in-flight messages and drains at the end of the traced
    # window so every async "b" has its "e" (bars extend to the edge)
    if events:
        t_end = _us(events[-1][0])
        for uid in sorted(posted, key=str):
            chan = next(iter(chan_pids)) if chan_pids else "channel"
            te.append({"ph": "e", "cat": "msg", "name": label_of(uid),
                       "id": uid, "pid": chan_pid(chan), "tid": 0,
                       "ts": t_end, "args": {"in_flight_at_end": True}})
        for tag in sorted(open_drains, key=str):
            te.append({"ph": "e", "cat": "drain", "name": f"drain#{tag}",
                       "id": str(tag), "pid": PID_RUNTIME, "tid": 0,
                       "ts": t_end, "args": {"in_flight_at_end": True}})

    # flow arrows: message delivery -> the compute slice it unblocked
    flow_id = 0
    for uid, c in cause.items():
        if c in delivered and uid in comp_start:
            d_ts, chan = delivered[c]
            c_ts, w = comp_start[uid]
            flow_id += 1
            te.append({"ph": "s", "cat": "unblocks", "name": "unblocks",
                       "id": flow_id, "pid": chan_pid(chan), "tid": 0,
                       "ts": _us(d_ts)})
            te.append({"ph": "f", "bp": "e", "cat": "unblocks", "name": "unblocks",
                       "id": flow_id, "pid": PID_WORKERS, "tid": w,
                       "ts": _us(c_ts)})

    for tid in sorted(worker_tids, key=str):
        te.append({"ph": "M", "pid": PID_WORKERS, "tid": tid,
                   "name": "thread_name", "args": {"name": f"worker-{tid}"}})
    for label, tid in runtime_tids.items():
        if tid == 0:
            continue  # tid 0 is the runtime (main) row itself
        te.append({"ph": "M", "pid": PID_RUNTIME, "tid": tid,
                   "name": "thread_name", "args": {"name": label}})

    doc = {
        "traceEvents": te,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "repro_torch.obs",
            "n_events": collector.n_emitted,
            "dropped_events": collector.dropped,
        },
    }
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
    return doc


def validate_trace(trace: Union[str, dict]) -> dict:
    """Structural schema check of a Chrome-trace document (a dict or a
    path to a JSON file).  Raises :class:`ValueError` on the first
    violation; returns a summary ``{"n_events": ..., "per_phase": ...,
    "pids": ...}`` on success."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    evs = trace["traceEvents"]
    if not isinstance(evs, list) or not evs:
        raise ValueError("'traceEvents' must be a non-empty list")
    per_phase: dict = {}
    pids: set = set()
    async_balance: dict = {}
    async_open: dict = {}  # (cat, id) -> open depth (b before e, no double-open)
    flow_starts: dict = {}  # (cat, id) -> ts of the "s" endpoint
    flow_finishes: dict = {}  # (cat, id) -> ts of the "f" endpoint
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"event #{i} is not an object")
        ph = ev.get("ph")
        if ph not in _KNOWN_PH:
            raise ValueError(f"event #{i}: unknown phase {ph!r}")
        per_phase[ph] = per_phase.get(ph, 0) + 1
        if "pid" not in ev:
            raise ValueError(f"event #{i} ({ph}): missing pid")
        pids.add(ev["pid"])
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                raise ValueError(f"event #{i} ({ph}): non-numeric ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event #{i}: X slice with bad dur {dur!r}")
            if not ev.get("name"):
                raise ValueError(f"event #{i}: X slice without a name")
        if ph == "C":
            val = (ev.get("args") or {}).get("value")
            if not isinstance(val, (int, float)):
                raise ValueError(f"event #{i}: counter without numeric value")
        if ph in ("b", "e"):
            key = (ev.get("cat"), ev.get("id"))
            if key[1] is None:
                raise ValueError(f"event #{i}: async {ph} without an id")
            async_balance[key] = async_balance.get(key, 0) + (1 if ph == "b" else -1)
            # nesting: segments (drain/msg) must open before they close
            # and must not double-open the same (cat, id)
            depth = async_open.get(key, 0)
            if ph == "b":
                if depth > 0:
                    raise ValueError(
                        f"event #{i}: async b for {key} opened twice "
                        f"without an intervening e"
                    )
                async_open[key] = depth + 1
            else:
                if depth <= 0:
                    raise ValueError(
                        f"event #{i}: async e for {key} closes a segment "
                        f"that was never opened"
                    )
                async_open[key] = depth - 1
        if ph in ("s", "f"):
            key = (ev.get("cat"), ev.get("id"))
            if key[1] is None:
                raise ValueError(f"event #{i}: flow {ph} without an id")
            side = flow_starts if ph == "s" else flow_finishes
            side[key] = ev.get("ts")
    unbalanced = {k: v for k, v in async_balance.items() if v != 0}
    if unbalanced:
        raise ValueError(
            f"{len(unbalanced)} async event id(s) with unbalanced b/e pairs "
            f"(first: {next(iter(unbalanced))})"
        )
    # flow arrows: every id needs both endpoints, and the arrow must not
    # point backwards in time (delivery happens before the unblocked slice)
    for key in flow_starts.keys() | flow_finishes.keys():
        s_ts = flow_starts.get(key)
        f_ts = flow_finishes.get(key)
        if s_ts is None or f_ts is None:
            missing = "f" if f_ts is None else "s"
            raise ValueError(
                f"flow id {key} is missing its {missing!r} endpoint"
            )
        if s_ts > f_ts:
            raise ValueError(
                f"flow id {key} points backwards in time "
                f"(s at {s_ts} > f at {f_ts})"
            )
    return {"n_events": len(evs), "per_phase": per_phase, "pids": sorted(pids)}
