"""The port's runtime (repro_torch) against the JAX package's runtime
(repro) on the paper's eight applications, on the CPU.

Both packages run the same programs (``repro_torch.apps`` and
``benchmarks.paper_apps``) at the sizes and blocks of
tests/test_exec.py, 4 processes.  The port runs its torch backend with
blocks on ``device="cpu"``, so fused stencil payloads take the plain
version of the ``stencil5_block`` kernel; the reference is the NumPy
interpreter.

Tolerances: programs of elementwise + - * / and comparisons only are
bit-identical (IEEE-exact operations in the same order and dtype).
Reductions, transcendentals and matmul agree at rtol 1e-12, because
torch sums and evaluates exp/log/pow in another order or with another
libm than NumPy.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import apps
from repro_torch.api import ExecutionPolicy, RuntimeConfig
from repro_torch.core.engine import export_storage, import_storage

pytest.importorskip("jax")

import repro  # noqa: E402
from benchmarks.paper_apps import run_app as run_ref  # noqa: E402

SMALL = dict(
    fractal=dict(n=128, iters=4),
    black_scholes=dict(n=50_000, iters=3),
    nbody=dict(n=192, steps=2),
    knn=dict(n=512, d=16),
    lbm2d=dict(h=128, w=128, steps=2),
    lbm3d=dict(d=16, h=16, w=16, steps=2),
    jacobi=dict(n=256, nrhs=256, iters=3),
    jacobi_stencil=dict(n=256, iters=3),
)
SMALL_BLOCKS = dict(
    fractal=32, black_scholes=8192, nbody=64, knn=128,
    lbm2d=32, lbm3d=8, jacobi=64, jacobi_stencil=64,
)
# only IEEE-exact elementwise ops: must be bit-identical
EXACT = {"fractal", "lbm2d", "lbm3d", "jacobi_stencil"}

ASYNC = ExecutionPolicy(flush="async", backend="torch")


def _port(app, policy=ASYNC, fusion=False):
    cfg = RuntimeConfig(nprocs=4, block_size=SMALL_BLOCKS[app], fusion=fusion,
                        device="cpu")
    return apps.run_app(app, cfg, policy, **SMALL[app])


def _ref(app, **kw):
    return run_ref(app, nprocs=4, block_size=SMALL_BLOCKS[app], **kw,
                   **SMALL[app])


def _assert_matches(app, got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if app in EXACT:
        assert np.array_equal(got, want, equal_nan=True)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("app", list(SMALL))
def test_port_matches_numpy_backend(app):
    st, got = _port(app)
    _, want = _ref(app, flush_backend="async", exec_backend="numpy")
    _assert_matches(app, got, want)
    assert st.n_compute_ops > 0 and 0.0 <= st.wait_fraction <= 1.0


def _spy_stencil5_group(monkeypatch) -> list:
    """Record each stencil5_group call of the backend as (fragment
    shapes, weight), and let it run."""
    import repro_torch.exec.backend as backend

    calls = []
    real = backend.stencil5_group

    def spy(frags, *, weight):
        calls.append(([out.shape for _, out in frags], weight))
        return real(frags, weight=weight)

    monkeypatch.setattr(backend, "stencil5_group", spy)
    return calls


def test_fused_stencil_bit_identical_through_stencil5(monkeypatch):
    """Fused sweeps route through the stencil5_group wrapper (its plain
    version on the CPU) and stay bit-identical to the interpreter."""
    calls = _spy_stencil5_group(monkeypatch)
    _, got = _port("jacobi_stencil", fusion=True)
    _, want = _ref("jacobi_stencil", flush_backend="async",
                   exec_backend="numpy", fusion=True)
    assert np.array_equal(got, want)
    assert calls and all(w == 0.2 for _, w in calls)


def test_stencil_fragments_grouped_per_worker_batch(monkeypatch):
    """A worker batch's stencil fragments go to the kernel in one call
    (several fragments a call, fewer calls than fragments), written in
    place, and the run stays bit-identical to the NumPy interpreter; an
    op run on its own (``execute``) is a group of one."""
    from repro_torch.exec import TorchBackend

    calls = _spy_stencil5_group(monkeypatch)
    _, got = _port("jacobi_stencil", fusion=True)
    sizes = [len(shapes) for shapes, _ in calls]
    assert max(sizes) > 1 and len(calls) < sum(sizes), sizes
    _, want = _ref("jacobi_stencil", flush_backend="async",
                   exec_backend="numpy", fusion=True)
    assert np.array_equal(got, want)
    monkeypatch.setattr(TorchBackend, "split_batch", lambda self, ops: ([], list(ops)))
    calls.clear()
    _, single = _port("jacobi_stencil", fusion=True)
    assert calls and all(len(shapes) == 1 for shapes, _ in calls)
    assert np.array_equal(single, want)


def test_cpu_compute_busy_is_thread_time():
    """On the CPU compute_busy is the thread-time reading, as in the
    reference: it equals host_busy, worker by worker."""
    st, _ = _port("jacobi_stencil", fusion=True)
    assert st.total_compute > 0
    for p in st.procs:
        assert p.compute_busy == p.host_busy


def test_cpu_runs_are_not_gated():
    """Blocks on the CPU: no stream gate is built or launched, and no
    payload counts a gate timeout."""
    from repro_torch.kernels import stream_gate

    before = stream_gate.launches["gate_wait"]
    st, _ = _port("jacobi_stencil", fusion=True)
    assert st.gate_timeouts == 0 and all(p.gate_timeouts == 0 for p in st.procs)
    assert stream_gate.launches["gate_wait"] == before


def test_device_clock_accounts_gate_timeouts():
    """The device clock's accounting, with stand-ins for the events and
    the gate: each pair's time goes to its worker and, by share, to its
    drains; a pair whose epoch the gate reports timed out counts one
    timeout for the worker and for each drain it served, and is logged
    with its kind and cause (the payload blocked past the limit: it
    synchronised; else the host was slower than the limit)."""
    from repro_torch.exec.backend import _DeviceClock
    from repro_torch.exec.stats import WaitStats, WorkerStats

    class Event:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):  # ms, as torch.cuda.Event's
            return (other.t - self.t) * 1e3

    class Gate:  # epochs 2 and 3 timed out
        def timeouts(self):
            return 2

        def timed_out_epoch(self, n):
            return (2, 3)[n]

    class Map:  # payloads, as the log names them
        ufunc = types.SimpleNamespace(name="add")

    class Fill:
        pass

    def ops(payload, n):
        return tuple(types.SimpleNamespace(payload=payload) for _ in range(n))

    clock = _DeviceClock(torch.device("cuda"), 2)
    clock._gate = Gate()
    limit = clock.GATE_TIMEOUT_S
    w0, w1, d1, d2 = WorkerStats(), WorkerStats(), WorkerStats(), WorkerStats()
    # (start, end, epoch, (ops, fn s, held s), worker stats, shares, rank,
    # trace collector): no collector, so nothing is emitted
    recs = [
        (Event(0.0), Event(0.001), 1, (ops(Map(), 1), 1e-4, 2e-4), w0, [(d1, 1.0)], 0, None),
        (Event(0.0), Event(0.004), 2, (ops(Map(), 2), 2 * limit, 2.1 * limit),
         w0, [(d1, 0.5), (d2, 0.5)], 0, None),
        (Event(0.0), Event(0.002), 3, (ops(Fill(), 1), 1e-4, 1.5 * limit), w1, [(d2, 1.0)],
         1, None),
    ]
    with clock._lock:
        for rec in recs:
            clock._resolve(rec)
    assert w0.compute_busy == pytest.approx(0.005) and w1.compute_busy == pytest.approx(0.002)
    assert d1.compute_busy == pytest.approx(0.003) and d2.compute_busy == pytest.approx(0.004)
    assert (w0.gate_timeouts, w1.gate_timeouts, d1.gate_timeouts, d2.gate_timeouts) == (1, 1, 1, 2)
    assert clock.timeout_log == [
        ("Map(add) x2 in one launch", "it synchronised", 2.1 * limit),
        ("Fill", "the host took longer than the timeout", 1.5 * limit),
    ]
    assert not clock._timed_out
    st = WaitStats(mode="async", nworkers=2, procs=[w0, w1])
    assert st.gate_timeouts == 2
    assert st.merge(WaitStats(mode="async", nworkers=2, procs=[d1, d2])).gate_timeouts == 5


@pytest.mark.parametrize("app", ["jacobi_stencil", "black_scholes", "lbm3d"])
def test_simulated_flush_matches_reference_simulator(app):
    st, got = _port(app, ExecutionPolicy(flush="sim"))
    _, want = _ref(app)
    _assert_matches(app, got, want)
    assert st.makespan > 0


@pytest.mark.parametrize("sync", ["demand", "barrier"])
@pytest.mark.parametrize("app", ["jacobi_stencil", "knn"])
def test_sync_modes(app, sync):
    _, got = _port(app, ASYNC.replace(sync=sync))
    _, want = _ref(app, flush_backend="async", exec_backend="numpy")
    _assert_matches(app, got, want)


def test_blocking_channel_matches():
    st, got = _port("jacobi_stencil", ASYNC.replace(channel="blocking"))
    _, want = _ref("jacobi_stencil")
    assert st.mode == "blocking-channel"
    assert np.array_equal(got, want)


def test_jacobi_sweeps_equals_runtime_stencil():
    """The compiled-sweep form (whole-grid jacobi_sweep) equals the
    runtime's fused stencil bit for bit in float64."""
    _, got = _port("jacobi_stencil", fusion=True)
    swept = apps.jacobi_sweeps(256, 3, device="cpu")
    assert np.array_equal(swept.numpy(), got)


def test_storage_parity_and_round_trip():
    """The same seeded array scattered by both packages gives the same
    layout and, exported, the same blocks."""
    x = np.random.default_rng(7).standard_normal((37, 50))
    with repro.runtime(nprocs=4, block_size=16) as rt_ref:
        a = repro.array(x)
        want = {k[1]: v for k, v in rt_ref.storage.items() if k[0] == a._base.id}
        want_layout = dataclasses.astuple(a._base.layout)
        round_trip = export_storage(import_storage(rt_ref.storage, "cpu"))
        assert round_trip.keys() == rt_ref.storage.keys()
        for k, v in rt_ref.storage.items():
            assert round_trip[k].dtype == v.dtype
            assert np.array_equal(round_trip[k], v)
    with repro_torch.runtime(nprocs=4, block_size=16, device="cpu") as rt:
        b = repro_torch.array(x)
        assert all(isinstance(t, torch.Tensor) and t.device == rt.device
                   for t in rt.storage.values())
        got = {k[1]: v for k, v in export_storage(rt.storage).items()
               if k[0] == b._base.id}
        assert dataclasses.astuple(b._base.layout) == want_layout
    assert got.keys() == want.keys()
    for coord in want:
        assert got[coord].dtype == want[coord].dtype
        assert np.array_equal(got[coord], want[coord])


def test_float32_program_follows_numpy_promotion():
    """A float32 block times a constant that the fuse pass folded in as
    an np.float64 scalar computes the way NumPy does — in float64,
    stored back into float32 — not in float32 as torch would."""
    x = np.random.default_rng(8).random((40, 40)).astype(np.float32)

    def program(mod):
        a = mod.array(x)
        d = mod.zeros((40, 40))
        d[...] = 0.1  # a fill the fuse pass folds into the map below
        c = mod.zeros((40, 40), dtype=np.float32)
        c[...] = a * d
        return np.asarray(c)

    kw = dict(nprocs=4, block_size=16, flush="async", fusion=True)
    with repro.runtime(**kw):
        want = program(repro)
    with repro_torch.runtime(**kw, device="cpu") as rt:
        got = program(repro_torch)
        assert rt.plan_stats.n_const_folded > 0
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert not np.array_equal(got, x * np.float32(0.1))
