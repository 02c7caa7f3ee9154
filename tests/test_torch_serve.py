"""The port's serving runtime (``repro_torch.serve``: the Server, its
admission control and latency histograms, ``ServeConfig``) against the
JAX package's (``repro.serve``), on the CPU.

The Server runs with its blocks on ``device="cpu"``; the reference runs
its NumPy interpreter.  Tenants' inputs are made with numpy from their
seeds, and every served result must equal the NumPy closed form and the
reference Server's result for the same seed bit for bit (the requests
are elementwise: IEEE-exact in both).  Histograms must equal the
reference's bit for bit on the same samples.  Threads are ordered by
observed state (a queue length, an event), never by a sleep, and every
join has its own timeout.
"""
import math
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import repro_torch
from repro_torch.api.config import ExecutionPolicy, ServeConfig
from repro_torch.serve import AdmissionController, AdmissionError, LatencyHistogram, Server

pytest.importorskip("jax")

import repro  # noqa: E402
import repro.api.config  # noqa: E402
import repro.serve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 30.0  # a generous bound on any join: a stranded thread fails, not hangs


def _until(cond, timeout=10.0):
    """Wait until ``cond()`` holds (an observed state), or fail."""
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "state not reached"
        time.sleep(1e-3)


def _server(**kw):
    return Server(device="cpu", **kw)


# ---------------------------------------------------------------------------
# latency histogram: the reference's, bit for bit
# ---------------------------------------------------------------------------


def _samples(seed):
    rng = np.random.default_rng(seed)
    return list(rng.lognormal(-5.0, 1.5, 200)) + [0.0, -1.0, 1e-9, 1e4, float("nan"),
                                                  float("inf")]


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_quantiles_and_merge_equal_the_reference(seed):
    a, b = LatencyHistogram(), LatencyHistogram()
    ra, rb = repro.serve.LatencyHistogram(), repro.serve.LatencyHistogram()
    xs = _samples(seed)
    for x in xs[:120]:
        a.record(x)
        ra.record(x)
    for x in xs[120:]:
        b.record(x)
        rb.record(x)
    a.merge(b)
    ra.merge(rb)
    assert a.count == ra.count == len(xs)
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert a.quantile(q) == ra.quantile(q), q
    assert (a.p50, a.p95, a.p99, a.max, a.sum, a.mean) == (
        ra.p50, ra.p95, ra.p99, ra.max, ra.sum, ra.mean)
    assert math.isfinite(a.max) and a.p50 <= a.p95 <= a.p99 <= a.max


def test_histogram_uniform_quantiles():
    h = LatencyHistogram()
    for ms in range(1, 101):
        h.record(ms * 1e-3)
    # log-spaced buckets: quantiles accurate to the bucket ratio (~12%)
    assert h.p50 == pytest.approx(0.050, rel=0.15)
    assert h.p99 == pytest.approx(0.100, rel=0.15)


# ---------------------------------------------------------------------------
# ServeConfig: the reference's validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"max_inflight": 2}, {"max_inflight": 0}, {"max_queue": -1}, {"max_queue": 0},
    {"admission_timeout": 0.0}, {"admission_timeout": -1.0}, {"admission_timeout": 0.5},
])
def test_serve_config_validation_matches_the_reference(kw):
    def outcome(cls):
        try:
            cfg = cls(**kw)
        except ValueError as exc:
            return ("ValueError", str(exc))
        return (cfg.max_inflight, cfg.max_queue, cfg.admission_timeout)

    assert outcome(ServeConfig) == outcome(repro.api.config.ServeConfig)
    assert ServeConfig().replace(max_inflight=3).max_inflight == 3


# ---------------------------------------------------------------------------
# admission control: the reference's scenarios
# ---------------------------------------------------------------------------


def test_admission_queue_full_rejects_immediately():
    adm = AdmissionController(max_inflight=1, max_queue=0)
    adm.admit()
    with pytest.raises(AdmissionError) as ei:
        adm.admit()
    assert ei.value.reason == "queue-full"
    assert adm.n_admitted == 1 and adm.n_rejected == 1
    adm.release()
    adm.admit()
    assert adm.n_admitted == 2


def test_admission_timeout_rejects_queued_request():
    adm = AdmissionController(max_inflight=1, max_queue=4, admission_timeout=0.05)
    adm.admit()
    with pytest.raises(AdmissionError) as ei:
        adm.admit()
    assert ei.value.reason == "timeout" and adm.queued == 0


def test_admission_release_unblocks_queued_waiter():
    adm = AdmissionController(max_inflight=1, max_queue=4)
    adm.admit()
    admitted = threading.Event()
    t = threading.Thread(target=lambda: (adm.admit(), admitted.set()))
    t.start()
    _until(lambda: adm.queued == 1)
    assert not admitted.is_set()
    adm.release()
    assert admitted.wait(JOIN_S)
    t.join(JOIN_S)
    assert not t.is_alive()
    assert adm.peak_queued == 1 and adm.peak_inflight == 1


def test_admission_close_rejects_queued_and_future():
    adm = AdmissionController(max_inflight=1, max_queue=4)
    adm.admit()
    errors = []

    def waiter():
        try:
            adm.admit()
        except AdmissionError as e:
            errors.append(e.reason)

    t = threading.Thread(target=waiter)
    t.start()
    _until(lambda: adm.queued == 1)
    adm.close()
    t.join(JOIN_S)
    assert not t.is_alive() and errors == ["closed"]
    with pytest.raises(AdmissionError, match="closed"):
        adm.admit()


def test_admission_release_never_lost_with_two_queued_waiters():
    """The lost-wakeup regression: a queued waiter with a deadline and a
    patient one; one release lands near the first's deadline (before it
    in some rounds, after it in others).  Whichever way the race goes,
    the freed slot is taken: exactly one waiter is admitted, promptly.
    (A notify consumed by a waiter that then sheds itself would leave
    neither admitted.)  Both waiters are seen queued before the
    release."""
    timeout = 0.03
    for round_ in range(15):
        adm = AdmissionController(max_inflight=1, max_queue=4, admission_timeout=timeout)
        adm.admit()  # slot taken
        results = {}
        admitted = threading.Event()

        def waiter(name):
            try:
                adm.admit()
                results[name] = "admitted"
                admitted.set()
            except AdmissionError as e:
                results[name] = e.reason

        ta = threading.Thread(target=waiter, args=("timed",))
        ta.start()
        _until(lambda: adm.queued == 1)
        t_queued = time.monotonic()
        adm.admission_timeout = None  # read per admit(): "patient" waits forever
        tb = threading.Thread(target=waiter, args=("patient",))
        tb.start()
        _until(lambda: adm.queued == 2 or "timed" in results)
        # place the release around the timed waiter's deadline: from 7 ms
        # before it to 7 ms after, across the rounds
        release_at = t_queued + timeout + (round_ - 7) * 1e-3
        time.sleep(max(0.0, release_at - time.monotonic()))
        adm.release()
        assert admitted.wait(JOIN_S), f"round {round_}: the release was lost ({results})"
        assert list(results.values()).count("admitted") == 1, (round_, results)
        assert adm.inflight == 1
        adm.close()  # a still-queued patient waiter leaves with "closed"
        ta.join(JOIN_S)
        tb.join(JOIN_S)
        assert not ta.is_alive() and not tb.is_alive()
        assert set(results.values()) <= {"admitted", "timeout", "closed"}


def test_admission_release_overrelease_clamped_and_counted():
    adm = AdmissionController(max_inflight=2, max_queue=0)
    adm.admit()
    adm.release()
    adm.release()
    adm.release()
    assert adm.inflight == 0 and adm.n_over_released == 2
    adm.admit()
    adm.admit()
    with pytest.raises(AdmissionError, match="queue full"):
        adm.admit()
    assert adm.inflight == 2


def test_admission_stress_window_and_no_starvation():
    adm = AdmissionController(max_inflight=4, max_queue=64, admission_timeout=10.0)
    violations, outcomes = [], []
    lock = threading.Lock()

    def client(seed):
        rng = random.Random(seed)
        for _ in range(25):
            try:
                adm.admit()
            except AdmissionError as e:
                with lock:
                    outcomes.append(e.reason)
                continue
            if adm.inflight > adm.max_inflight:
                with lock:
                    violations.append(adm.inflight)
            time.sleep(rng.random() * 0.002)  # holds the slot: work, not ordering
            adm.release()
            with lock:
                outcomes.append("ok")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert not any(t.is_alive() for t in threads), "a waiter starved"
    assert not violations and outcomes.count("timeout") == 0
    assert adm.inflight == 0 and adm.queued == 0
    assert adm.n_admitted == outcomes.count("ok") == 12 * 25


# ---------------------------------------------------------------------------
# the Server on device="cpu"
# ---------------------------------------------------------------------------


def test_server_requires_async_flush_demand_sync_and_a_device():
    with pytest.raises(ValueError, match="flush='async'"):
        Server(policy=ExecutionPolicy(flush="sim"), device="cpu")
    with pytest.raises(ValueError, match="demand"):
        Server(policy=ExecutionPolicy(flush="async", sync="barrier"), device="cpu")
    with pytest.raises(TypeError, match="unknown server option"):
        Server(bogus_knob=1)
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Server()  # the card is the default, with no fallback
    with _server(nprocs=2, block_size=8) as srv:
        assert srv.runtime.device.type == "cpu"
        assert srv.config.device == "cpu"


def _tenant_fn(pkg, h):
    """One tenant's request: a halo-exchange stencil step over its array."""
    def fn():
        a = pkg.array(h)
        return np.roll(a, 1, axis=1) * 3.0 - a
    return fn


def _serve(pkg, seeds, requests, **kw):
    """Closed-loop tenants, one thread each, against one Server of
    ``pkg``; returns {tenant: [results]} and the server's stats."""
    results, errors = {}, []
    srv_cls = Server if pkg is repro_torch else repro.serve.Server
    extra = {"device": "cpu"} if pkg is repro_torch else {}
    with srv_cls(nprocs=4, block_size=16, **extra, **kw) as srv:
        def client(name, seed):
            h = np.random.default_rng(seed).standard_normal((32, 32))
            sess = srv.session(name)
            try:
                results[name] = [sess.request(_tenant_fn(pkg, h)).result()
                                 for _ in range(requests)]
            except BaseException as exc:  # noqa: BLE001 - asserted below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(f"c{i}", s))
                   for i, s in enumerate(seeds)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        stats = srv.stats()
        peak = srv.admission.peak_inflight
        cache = srv.runtime._plan_cache
        batcher = srv.runtime._batcher
        info = dict(peak=peak, hits=cache.hits if cache is not None else None,
                    batches=batcher.n_batches if batcher is not None else None)
    return results, stats, info


@pytest.mark.parametrize("kw", [
    dict(latency=1e-3, max_inflight=8, max_queue=64),
    dict(latency=1e-3, max_inflight=8, max_queue=64, batch_cones=True),
    dict(max_inflight=8, max_queue=64, verify="full"),
], ids=["concurrent", "batch-cones", "verify-full"])
def test_concurrent_tenants_bit_identical_to_numpy_and_the_reference(kw):
    seeds = [11, 12, 13, 14, 15, 16]
    got, stats, info = _serve(repro_torch, seeds, 3, **kw)
    want, _, _ = _serve(repro, seeds, 3, **kw)
    for i, seed in enumerate(seeds):
        h = np.random.default_rng(seed).standard_normal((32, 32))
        closed = np.roll(h, 1, axis=1) * 3.0 - h
        name = f"c{i}"
        assert len(got[name]) == 3
        for g, w in zip(got[name], want[name]):
            assert np.array_equal(g, closed) and np.array_equal(g, w), name
        st = stats[name]
        assert st.n_requests == 3 and st.n_failed == 0 and st.latency.count == 3
        assert st.gate_timeouts == 0  # nothing is gated on the CPU
        assert st.wait.total_host == pytest.approx(st.wait.total_compute)
    assert info["peak"] >= 1
    if kw.get("batch_cones"):
        assert info["batches"] >= 1


def test_per_tenant_stats_isolation():
    with _server(nprocs=2, block_size=8) as srv:
        sa, sb = srv.session("a"), srv.session("b")
        ha, hb = np.arange(16.0), np.arange(16.0) * 3.0
        for _ in range(3):
            np.testing.assert_array_equal(
                sa.request(lambda: repro_torch.array(ha) + 1.0).result(), ha + 1.0)
        np.testing.assert_array_equal(
            sb.request(lambda: repro_torch.array(hb) * 2.0).result(), hb * 2.0)
        assert sa.stats.n_requests == 3 and sa.stats.latency.count == 3
        assert sb.stats.n_requests == 1 and sb.stats.latency.count == 1
        assert sa.stats.n_flushes == 3 and sb.stats.n_flushes == 1
        assert sa.stats.wait.n_compute_ops > sb.stats.wait.n_compute_ops
        assert sa.stats.wait.total_host > 0.0  # the port's host_busy merges too
        assert list(srv.stats()) == ["a", "b"]
        assert "latency:" in srv.format_stats()


def test_server_repeated_shape_hits_plan_cache():
    with _server(nprocs=2, block_size=8, plan_cache=True) as srv:
        sess = srv.session("t")
        h = np.arange(32.0)

        def fn():
            a = repro_torch.array(h)
            return np.roll(a, 1, axis=0) + a * 2.0

        for _ in range(5):
            np.testing.assert_array_equal(sess.request(fn).result(),
                                          np.roll(h, 1, axis=0) + h * 2.0)
        cache = srv.runtime._plan_cache
        assert cache.hits >= 3 and cache.misses >= 1
        assert all(r.ok for r in srv.runtime.verify_cached_plans())
        assert srv.lock_hold.count == 5 and srv.lock_hold.quantile(0.5) > 0.0


def test_server_sheds_when_queue_full_under_slow_drain():
    host = np.arange(64.0).reshape(8, 8)
    # 0.25 s of injected wire latency a message: the first drain holds
    # the only slot far longer than the next request takes to arrive
    with _server(nprocs=2, block_size=4, latency=0.25, max_inflight=1, max_queue=0) as srv:
        sess = srv.session("t")

        def fn():
            a = repro_torch.array(host)
            return np.roll(a, 1, axis=0) + a

        r1 = sess.request(fn)
        assert srv.admission.inflight == 1
        with pytest.raises(AdmissionError) as ei:
            sess.request(fn)
        assert ei.value.reason == "queue-full"
        assert sess.stats.n_rejected == 1 and srv.admission.n_rejected == 1
        np.testing.assert_array_equal(r1.result(), np.roll(host, 1, axis=0) + host)


def test_request_errors_release_the_admission_slot():
    with _server(nprocs=2, block_size=8, max_inflight=1) as srv:
        sess = srv.session("t")
        with pytest.raises(ValueError, match="boom"):
            sess.request(lambda: (_ for _ in ()).throw(ValueError("boom")))
        assert sess.stats.n_failed == 1 and srv.admission.inflight == 0
        with pytest.raises(TypeError, match="must return DistArrays"):
            sess.request(lambda: 42)
        assert srv.admission.inflight == 0
        h = np.arange(16.0)
        np.testing.assert_array_equal(
            sess.request(lambda: repro_torch.array(h) * 2.0).result(), h * 2.0)


def test_server_rejects_requests_after_close_and_double_close():
    srv = _server(nprocs=2, block_size=8)
    sess = srv.session("t")
    h = np.arange(16.0)
    np.testing.assert_array_equal(
        sess.request(lambda: repro_torch.array(h) + 1.0).result(), h + 1.0)
    srv.close()
    srv.close()  # no-op
    with pytest.raises(AdmissionError, match="closed"):
        sess.request(lambda: repro_torch.array(h) + 1.0)
    assert sess.stats.n_rejected == 1
    with pytest.raises(AdmissionError, match="closed"):
        srv.session("new-tenant")


def test_launch_serve_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--tenants", "2", "--requests", "3"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 tenants x 3 requests" in proc.stdout and "0 rejected" in proc.stdout


# ---------------------------------------------------------------------------
# device work the recording side issues queues under the stream lock
# ---------------------------------------------------------------------------


class _CountingLock:
    """A lock that counts its acquisitions."""

    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def __enter__(self):
        self._lock.acquire()
        self.n += 1
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


def test_scatter_fill_and_gather_take_the_stream_lock():
    """Each block a tenant's thread scatters, fills or gathers is copied
    under the runtime's stream lock (on the card, the executor's gated
    pairs hold the same lock), and the result is unchanged."""
    host = np.arange(64.0 * 64).reshape(64, 64)
    with repro_torch.runtime(nprocs=2, block_size=32, flush="async", device="cpu") as rt:
        assert rt._stream_lock is None  # nothing is gated on the CPU
        rt._stream_lock = lock = _CountingLock()
        a = repro_torch.array(host)
        assert lock.n == 4  # one per block
        z = repro_torch.zeros((64, 32))
        assert lock.n == 6
        b = a * 2.0 + 1.0  # its result blocks are allocated under the lock too
        n0 = lock.n
        out = np.asarray(b)
        assert lock.n - n0 == 4  # the gather's four blocks
        np.testing.assert_array_equal(out, host * 2.0 + 1.0)
        np.testing.assert_array_equal(np.asarray(z), np.zeros((64, 32)))


def test_runtime_hands_its_stream_lock_to_the_device_clock():
    from repro_torch.exec import AsyncExecutor

    lock = threading.Lock()
    ex = AsyncExecutor(2, {}, {}, device="cuda", stream_lock=lock)
    try:
        assert ex._clock.stream_lock is lock
    finally:
        ex.close()
    ex = AsyncExecutor(2, {}, {}, device="cuda")
    try:
        assert ex._clock.stream_lock is not lock  # its own, when none is given
    finally:
        ex.close()
