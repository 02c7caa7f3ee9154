"""The port's observability (``repro_torch.obs``: the trace collector,
the Chrome-trace export and wait attribution) against the JAX package's
(``repro.obs``), on the CPU.

The programs are seeded and run on both packages: the port with its
blocks on ``device="cpu"``, the reference on its NumPy interpreter.
Under ``flush="sim"`` the event stream is deterministic, so the two
exports must agree exactly in their track names and in the count of
each event kind.  Under the async executor the timings differ run to
run; there attribution's ``wait_fraction`` must agree with the measured
``WaitStats.wait_fraction`` within the gap the reference shows on the
same program, plus 0.02.  Results are held to host NumPy at rtol 1e-12
(the program sums a column, which torch orders otherwise than NumPy).
"""
import json
import types
from collections import Counter

import numpy as np
import pytest

import repro_torch
from repro_torch.obs import (
    AttributionReport,
    TraceCollector,
    attribution,
    export_trace,
    trace,
    validate_trace,
)
from repro_torch.obs import collector as obs_collector
from repro_torch.obs.collector import activate, current_tracer, deactivate

pytest.importorskip("jax")

import repro  # noqa: E402
import repro.obs  # noqa: E402
from repro.obs import collector as ref_collector  # noqa: E402

HOST = np.arange(16384.0).reshape(128, 128)
WANT = np.sum(np.roll(np.sqrt(HOST * HOST + 1.0), 1, axis=0) + np.sqrt(HOST * HOST + 1.0),
              axis=0)
# attribution's wait_fraction against the measured one: the reference's
# own gap on the same program, plus this
ATTRIBUTION_SLACK = 0.02


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    """Tracing never leaks across tests (or from a crashed one)."""
    obs_collector.CURRENT = None
    ref_collector.CURRENT = None
    yield
    obs_collector.CURRENT = None
    ref_collector.CURRENT = None


def _program(pkg=repro_torch, **rt_kwargs):
    """tests/test_obs.py's program: a small pipeline with genuine
    inter-process transfers (the roll)."""
    if pkg is repro_torch:
        rt_kwargs.setdefault("device", "cpu")
    with pkg.runtime(block_size=32, **rt_kwargs) as rt:
        a = pkg.array(HOST)
        b = np.sqrt(a * a + 1.0)
        c = np.roll(b, 1, axis=0) + b
        out = np.asarray(np.sum(c, axis=0))
        st = rt.stats()
    return out, st, rt


def _tracks(doc) -> set:
    return {(e["name"], e["pid"], e["args"]["name"]) for e in doc["traceEvents"]
            if e["ph"] == "M"}


# ---------------------------------------------------------------------------
# the export against the reference's
# ---------------------------------------------------------------------------


def test_sim_trace_export_matches_the_reference():
    """flush="sim": the same program records, plans and drains the same
    operations in both packages, so the exports carry the same tracks
    and the same count of each event kind."""
    with trace() as tr:
        got, _, _ = _program(nprocs=4, flush="sim")
    with repro.obs.trace() as ref_tr:
        want, _, _ = _program(repro, nprocs=4, flush="sim")
    np.testing.assert_allclose(got, WANT, rtol=1e-12)
    np.testing.assert_allclose(want, WANT, rtol=1e-12)
    doc, ref_doc = export_trace(tr), repro.obs.export_trace(ref_tr)
    info, ref_info = validate_trace(doc), repro.obs.validate_trace(ref_doc)
    assert tr.dropped == ref_tr.dropped == 0
    assert Counter(e[1] for e in tr.events) == Counter(e[1] for e in ref_tr.events)
    assert info["per_phase"] == ref_info["per_phase"]
    assert info["pids"] == ref_info["pids"]
    assert _tracks(doc) == _tracks(ref_doc)
    assert repro.obs.validate_trace(doc) == info  # the reference accepts it too


def test_event_completeness_async():
    """Every recorded compute op starts and ends once, passes through a
    worker queue once, and every posted message is delivered."""
    from repro_torch.core import COMM, COMPUTE

    with trace() as tr:
        out, _, _ = _program(nprocs=4, flush="async", passes=())
    np.testing.assert_allclose(out, WANT, rtol=1e-12)
    ev = list(tr.events)
    assert tr.dropped == 0
    recorded = sorted(uid for _, et, uid, _, _ in ev
                      if et == "recorded" and tr.ops[uid][0] == COMPUTE)
    assert sorted(uid for _, et, uid, _, _ in ev if et == "compute-start") == recorded
    assert sorted(uid for _, et, uid, _, _ in ev if et == "compute-end") == recorded
    enq = Counter(uid for _, et, uid, _, _ in ev if et == "enqueued")
    deq = Counter(uid for _, et, uid, _, _ in ev if et == "dequeued")
    assert all(enq[uid] == 1 and deq[uid] == 1 for uid in recorded)
    posted = sorted(uid for _, et, uid, _, _ in ev if et == "msg-posted")
    assert posted and posted == sorted(uid for _, et, uid, _, _ in ev
                                       if et == "msg-delivered")
    assert all(tr.ops[uid][0] == COMM for uid in posted)
    drain_b = [uid for _, et, uid, _, _ in ev if et == "drain-begin"]
    assert sorted(drain_b) == sorted(uid for _, et, uid, _, _ in ev if et == "drain-end")
    # on the CPU nothing is device-timed
    assert not any(et == "compute-device" for _, et, _, _, _ in ev)


@pytest.mark.parametrize("flush", ["async", "sim"])
def test_traced_bit_identical(flush):
    base, _, _ = _program(nprocs=4, flush=flush)
    with trace():
        traced, _, _ = _program(nprocs=4, flush=flush)
    np.testing.assert_array_equal(base, traced)


def test_disabled_no_collector_no_tracer():
    _, _, rt = _program(nprocs=4, flush="async")
    assert obs_collector.CURRENT is None and rt.tracer is None
    assert current_tracer() is None


def test_trace_cm_nesting_and_ambient_adoption():
    outer = TraceCollector()
    prev = activate(outer)
    with trace() as inner:
        assert current_tracer() is inner and inner is not outer
        _, _, rt = _program(nprocs=2, flush="async")
        assert rt.tracer is inner  # adopted, not owned
    assert current_tracer() is outer
    deactivate(prev)
    assert current_tracer() is None


# ---------------------------------------------------------------------------
# the three ways to name an export path
# ---------------------------------------------------------------------------


def _via_context(path, monkeypatch):
    with trace(str(path)):
        _program(nprocs=2, flush="async")


def _via_policy(path, monkeypatch):
    with repro_torch.runtime(nprocs=2, flush="async", trace=str(path), device="cpu") as rt:
        np.asarray(repro_torch.array(np.ones((32, 32))) + 1.0)
        assert rt.tracer is not None and current_tracer() is rt.tracer
        assert rt.trace_path == str(path)
    assert current_tracer() is None


def _via_env(path, monkeypatch):
    monkeypatch.setenv("REPRO_TRACE", str(path))
    _, _, rt = _program(nprocs=2, flush="async")
    assert rt.trace_path == str(path)


@pytest.mark.parametrize("how", [_via_context, _via_policy, _via_env],
                         ids=["trace(path)", "trace=path", "REPRO_TRACE=path"])
def test_trace_path_writes_a_valid_file(how, tmp_path, monkeypatch):
    path = tmp_path / "trace.json"
    how(path, monkeypatch)
    doc = json.loads(path.read_text())
    info = validate_trace(doc)
    assert info["n_events"] > 0 and info["per_phase"].get("X", 0) > 0
    assert doc["otherData"]["generator"] == "repro_torch.obs"


def test_repro_trace_env_switches(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE", "1")
    _, _, rt = _program(nprocs=2, flush="async")
    assert rt.tracer is not None and rt.trace_path is None
    monkeypatch.setenv("REPRO_TRACE", "0")
    _, _, rt = _program(nprocs=2, flush="async")
    assert rt.tracer is None
    with pytest.raises(ValueError):
        repro_torch.ExecutionPolicy(trace=3)


# ---------------------------------------------------------------------------
# exporter schema
# ---------------------------------------------------------------------------


def test_export_schema_and_tracks():
    with trace() as tr:
        _program(nprocs=4, flush="async", latency=2e-4)
    doc = export_trace(tr)
    info = validate_trace(doc)
    assert doc["displayTimeUnit"] == "ms"
    assert {1, 2, 4} <= set(info["pids"]) and any(p >= 10 for p in info["pids"])
    per_phase = info["per_phase"]
    assert per_phase.get("X", 0) > 0 and per_phase.get("C", 0) > 0
    assert per_phase.get("b", 0) == per_phase.get("e", 0)
    assert per_phase.get("s", 0) == per_phase.get("f", 0)
    assert any(e["args"]["name"].startswith("worker") for e in doc["traceEvents"]
               if e["ph"] == "M" and e["name"] == "thread_name")


def test_validate_trace_rejects_what_the_reference_rejects():
    s = {"ph": "s", "pid": 10, "tid": 0, "ts": 1.0, "cat": "unblocks", "id": 1,
         "name": "unblocks"}
    f = {"ph": "f", "bp": "e", "pid": 2, "tid": 0, "ts": 2.0, "cat": "unblocks", "id": 1,
         "name": "unblocks"}
    b = {"ph": "b", "pid": 1, "tid": 0, "ts": 0.0, "cat": "drain", "id": "1",
         "name": "drain#1"}
    e = dict(b, ph="e", ts=5.0)
    bad = [
        [{"ph": "Z", "pid": 1, "ts": 0.0, "name": "x"}],
        [{"ph": "X", "pid": 1, "ts": 0.0, "name": "x"}],
        [dict(b, cat="msg")],
        [s], [f], [dict(s, ts=3.0), f],
        [{k: v for k, v in s.items() if k != "id"}],
        [e, b], [b, b, e, e],
    ]
    for evs in bad:
        with pytest.raises(ValueError):
            repro.obs.validate_trace({"traceEvents": evs})
        with pytest.raises(ValueError):
            validate_trace({"traceEvents": evs})
    for evs in ([s, f], [b, e], [b, dict(b, id="2"), e, dict(e, id="2")]):
        assert validate_trace({"traceEvents": evs}) == repro.obs.validate_trace(
            {"traceEvents": evs})


def test_concurrent_overlapping_drains_trace_valid_and_tagged():
    """Two disjoint cones in flight at once: the trace stays valid, the
    drain segments balance, and every executed op carries its own flush
    id."""
    ha = np.arange(4096.0).reshape(64, 64)
    hb = ha * 2.0 - 7.0
    with trace() as tr:
        with repro_torch.runtime(nprocs=4, block_size=32, flush="async", sync="demand",
                                 latency=2e-3, passes=(), device="cpu") as rt:
            a, b = repro_torch.array(ha), repro_torch.array(hb)
            x = np.roll(a, 1, axis=0) + a
            y = np.roll(b, 1, axis=0) + b
            t1 = rt.flush(wait=False, targets=[x])
            t2 = rt.flush(wait=False, targets=[y])  # overlaps t1's drain
            t1.wait()
            t2.wait()
            np.testing.assert_array_equal(np.asarray(x), np.roll(ha, 1, axis=0) + ha)
            np.testing.assert_array_equal(np.asarray(y), np.roll(hb, 1, axis=0) + hb)
    ev = list(tr.events)
    drain_b = [uid for _, et, uid, _, _ in ev if et == "drain-begin"]
    assert len(drain_b) >= 2 and len(set(drain_b)) == len(drain_b)
    assert sorted(drain_b) == sorted(uid for _, et, uid, _, _ in ev if et == "drain-end")
    executed = {uid for _, et, uid, _, _ in ev if et == "compute-start"}
    assert executed and executed <= set(tr.flush_of)
    assert len({tr.flush_of[uid] for uid in executed}) >= 2
    validate_trace(export_trace(tr))
    rep = attribution(tr)
    assert rep.elapsed > 0 and rep.n_spans > 0


# ---------------------------------------------------------------------------
# wait attribution
# ---------------------------------------------------------------------------


def test_attribution_charges_transfers_under_latency():
    """With injected wire latency the roll's halo transfers dominate:
    attribution names the transfer group among the top offenders, with
    its message traffic."""
    with trace() as tr:
        _program(nprocs=4, flush="async", latency=2e-3)
    rep = attribution(tr)
    assert isinstance(rep, AttributionReport) and rep.nworkers == 4
    assert set(rep.per_worker) == set(range(4))
    workers = [o for o in rep.offenders if not o["group"].startswith("flush#")]
    xfer = [o for o in workers if o["group"].startswith("xfer")]
    assert xfer, [o["group"] for o in rep.offenders]
    assert xfer[0]["n_msgs"] >= 1 and xfer[0]["msg_bytes"] > 0
    assert "wait attribution" in rep.format(5)


def test_attribution_wait_fraction_agrees_as_the_reference():
    """On the CPU attribution charges each slice's thread time, as
    WaitStats.compute_busy counts it: its wait_fraction is the measured
    one within the reference's own gap on the same program, plus 0.02."""
    with trace() as tr:
        got, st, _ = _program(nprocs=4, flush="async", latency=1e-3)
    with repro.obs.trace() as ref_tr:
        want, ref_st, _ = _program(repro, nprocs=4, flush="async", latency=1e-3)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    ref_gap = abs(repro.obs.attribution(ref_tr).wait_fraction - ref_st.wait_fraction)
    rep = attribution(tr)
    assert 0.0 <= rep.wait_fraction <= 1.0
    assert abs(rep.wait_fraction - st.wait_fraction) <= ref_gap + ATTRIBUTION_SLACK


def _device_timed_collector():
    """A collector as a drain with blocks on a CUDA device leaves it: two
    compute units on worker 0 (the second a grouped launch of two ops)
    whose slices took 10 ms of host thread time each, and the device
    seconds of each unit, emitted when the drain settled."""
    col = TraceCollector()
    col.t0 = 0.0
    col.ops.update({1: ("compute", "map:fused", 8), 2: ("compute", "map:fused", 8),
                    3: ("compute", "map:fused", 8)})
    col.events.extend([
        (0.000, "drain-begin", "d1", None, (3, 2)),
        (0.001, "compute-start", 1, 0, 1.000),
        (0.012, "compute-end", 1, 0, 1.010),
        (0.013, "compute-start", 2, 0, 1.011),
        (0.013, "compute-start", 3, 0, 1.011),
        (0.024, "compute-end", 2, 0, 1.021),
        (0.024, "compute-end", 3, 0, 1.021),
        (0.030, "compute-device", 1, 0, 0.0005),
        (0.030, "compute-device", 2, 0, 0.0003),
        (0.031, "drain-end", "d1", None, None),
    ])
    return col


def test_attribution_charges_device_seconds_not_host_time():
    """A slice with device time is charged its device seconds, never its
    host thread time: no host launch time counts as compute."""
    rep = attribution(_device_timed_collector())
    assert rep.nworkers == 2 and rep.elapsed == pytest.approx(0.031)
    assert rep.total_compute == pytest.approx(0.0008)
    assert rep.per_worker[0]["compute"] == pytest.approx(0.0008)
    assert rep.wait_fraction == pytest.approx(1 - 0.0008 / (2 * 0.031))
    # the same slices without their device events: the thread time
    cpu = _device_timed_collector()
    cpu.events = type(cpu.events)(e for e in cpu.events if e[1] != "compute-device")
    assert attribution(cpu).total_compute == pytest.approx(0.020)


def test_export_carries_device_time_and_stays_valid():
    doc = export_trace(_device_timed_collector())
    validate_trace(doc)
    slices = {e["args"]["uid"]: e["args"] for e in doc["traceEvents"]
              if e["ph"] == "X" and e.get("cat") == "compute"}
    assert slices[1]["device_us"] == pytest.approx(500.0)
    assert slices[2]["device_us"] == pytest.approx(300.0)
    assert slices[1]["cpu_us"] == pytest.approx(10000.0)


def test_device_clock_emits_each_units_device_seconds():
    """_DeviceClock hands a resolved pair's time to the collector that
    saw its unit launch, keyed by the unit's first op."""
    import torch

    from repro_torch.exec.backend import _DeviceClock
    from repro_torch.exec.stats import WorkerStats

    class Event:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    clock = _DeviceClock(torch.device("cuda"), 2)
    clock._gate = types.SimpleNamespace(timeouts=lambda: 0)
    col = TraceCollector()
    ops = (types.SimpleNamespace(uid=7, payload=None),
           types.SimpleNamespace(uid=8, payload=None))
    w, d = WorkerStats(), WorkerStats()
    with clock._lock:
        clock._resolve((Event(0.0), Event(0.002), 1, (ops, 1e-4, 2e-4), w,
                        [(d, 0.5), (d, 0.5)], 1, col))
        clock._resolve((Event(0.0), Event(0.001), 2, (ops[:1], 1e-4, 2e-4), w,
                        [(d, 1.0)], 0, None))
    assert [(et, uid, worker, s) for _, et, uid, worker, s in col.events] == [
        ("compute-device", 7, 1, pytest.approx(0.002))]
    assert w.compute_busy == pytest.approx(0.003)
