"""The port's gradient compression and fault tolerance against the JAX
package's, on the CPU.

The deterministic int8 path (round to nearest, no generator) and top-k
with error feedback equal ``repro.resilience.compression`` bit for bit
on the same gradients.  Stochastic rounding is unbiased: over 4096
seeded draws of the same tensor the mean of the dequantized values lies
within 5 standard errors of the tensor (the noise of one draw is at
most half a step, so its standard deviation is at most step/√12).
``fault_tolerance.py`` is a copy; the port's copies of
``tests/test_fault_tolerance.py``'s cases follow.
"""
import numpy as np
import pytest
import torch

from repro_torch.resilience import (
    ClusterMonitor,
    ElasticPlan,
    StragglerTracker,
    TrainSupervisor,
    int8_compress_transform,
    topk_ef_transform,
)
from repro_torch.resilience.compression import int8_dequantize, int8_quantize


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    g = {"a": (rng.standard_normal((32, 16)) * 3).astype(np.float32),
         "b": rng.standard_normal(100).astype(np.float32)}
    g["b"][7] = 0.0
    g["a"][0, :4] = [2.5, -2.5, 0.5, 1.5]  # ties at half a step after scaling
    return g


def test_int8_deterministic_path_equals_the_reference():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.resilience.compression import int8_quantize as jq

    for name, g in _grads().items():
        q, s = int8_quantize(torch.from_numpy(g))
        wq, ws = jq(jnp.asarray(g))
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        assert float(s) == float(ws)
        assert q.dtype == torch.int8 and s.dtype == torch.float32


def test_topk_error_feedback_equals_the_reference():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.resilience import topk_ef_transform as jtopk

    tt, ti = topk_ef_transform(k_frac=0.05)
    jt, ji = jtopk(k_frac=0.05)
    g0 = _grads(1)
    tres, jres = ti({k: torch.from_numpy(v) for k, v in g0.items()}), ji(
        {k: jnp.asarray(v) for k, v in g0.items()})
    for step in range(4):
        g = _grads(10 + step)
        ts, tres = tt({k: torch.from_numpy(v) for k, v in g.items()}, tres)
        js, jres = jt({k: jnp.asarray(v) for k, v in g.items()}, jres)
        for k in g:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
            np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]))


def test_int8_transform_keeps_names_and_dtypes():
    g = {"w": torch.linspace(-1, 1, 64).reshape(8, 8).to(torch.bfloat16),
         "b": torch.ones(3)}
    out = int8_compress_transform(0)(g)
    assert out.keys() == g.keys()
    assert out["w"].dtype == torch.bfloat16 and out["b"].dtype == torch.float32


def test_int8_transform_same_seed_same_noise():
    g = {"a": torch.from_numpy(_grads()["a"])}
    a, b = int8_compress_transform(3)(g), int8_compress_transform(3)(g)
    c = int8_compress_transform(4)(g)
    assert torch.equal(a["a"], b["a"])
    assert not torch.equal(a["a"], c["a"])


def test_stochastic_rounding_is_unbiased():
    x = torch.from_numpy(_grads(2)["b"])
    gen = torch.Generator().manual_seed(0)
    n = 4096
    total = torch.zeros_like(x, dtype=torch.float64)
    for _ in range(n):
        q, s = int8_quantize(x, gen)
        total += int8_dequantize(q, s).double()
    step = float(x.abs().max()) / 127
    bound = 5 * step / np.sqrt(12) / np.sqrt(n)  # 5 standard errors of the mean
    err = float((total / n - x.double()).abs().max())
    assert err <= bound, (err, bound)
    # and round to nearest alone is biased on these values
    q, s = int8_quantize(x)
    assert float((int8_dequantize(q, s).double() - x.double()).abs().max()) > bound


# ---------------------------------------------------------------------------
# the port's copies of tests/test_fault_tolerance.py
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_monitor_detects_missed_heartbeats():
    clk = FakeClock()
    mon = ClusterMonitor(4, deadline=10.0, clock=clk)
    clk.t = 5.0
    for h in range(4):
        mon.heartbeat(h)
    clk.t = 12.0
    mon.heartbeat(1)
    mon.heartbeat(3)
    clk.t = 16.0
    assert mon.failed() == [0, 2]
    assert mon.alive() == [1, 3]


def test_elastic_plan_rebalances():
    plan = ElasticPlan.make([0, 1, 2, 3, 5, 6, 7, 9], global_batch=256)
    assert plan.n_hosts == 8
    assert plan.rows_per_host == 32
    assert plan.rank_of[5] == 4
    plan2 = ElasticPlan.make(plan.hosts[:-1], 256)
    assert plan2.rows_per_host == 36
    assert plan2.global_batch == 252
    assert plan2.mesh_shape(model_parallel=7) == (1, 7)
    assert plan2.mesh_shape(model_parallel=4) == (7, 1)


def test_elastic_data_pipeline_consistency():
    from repro_torch.data.pipeline import DataConfig, TokenPipeline

    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=8)
    before = TokenPipeline(cfg, host_id=0, n_hosts=1).batch_at(3)
    shards = [TokenPipeline(cfg, host_id=h, n_hosts=2).batch_at(3, host_id=h)
              for h in range(2)]
    again = TokenPipeline(cfg, host_id=1, n_hosts=2).batch_at(3)
    np.testing.assert_array_equal(shards[1]["tokens"], again["tokens"])
    assert before["tokens"].shape == (8, 8)
    assert shards[0]["tokens"].shape == (4, 8)


def test_straggler_eviction():
    tr = StragglerTracker(4, threshold=2.0, window=4, patience=2)
    for _ in range(6):
        for h in range(4):
            tr.record(h, 1.0 if h != 2 else 5.0)
        evict = tr.evaluate()
    assert evict == [2]


def test_supervisor_restart_and_rescale():
    saves = {}
    events = []

    def step_fn(st, step, plan):
        if step == 5 and 3 in plan.hosts:
            raise TrainSupervisor.HostFailure(3)
        return {"x": st["x"] + plan.n_hosts}

    def save_fn(st, step):
        saves["latest"] = (dict(st), step)

    def restore_fn():
        st, step = saves["latest"]
        events.append(("restore", step))
        return dict(st), step

    sup = TrainSupervisor(
        n_hosts=4, global_batch=64, step_fn=step_fn, save_fn=save_fn,
        restore_fn=restore_fn, checkpoint_every=2,
        on_rescale=lambda p: events.append(("rescale", p.n_hosts)),
    )
    _, step = sup.run({"x": 0}, 0, 10)
    assert step == 10
    assert ("rescale", 3) in events
    assert any(e[0] == "restore" for e in events)
    assert sup.plan.n_hosts == 3


def test_supervisor_gives_up_after_max_restarts():
    def step_fn(st, step, plan):
        raise TrainSupervisor.HostFailure(plan.hosts[0])

    sup = TrainSupervisor(n_hosts=4, global_batch=64, step_fn=step_fn,
                          save_fn=lambda s, t: None, restore_fn=lambda: ({}, 0),
                          max_restarts=2)
    with pytest.raises(TrainSupervisor.HostFailure):
        sup.run({}, 0, 5)


def test_int8_compression_roundtrip_error_small():
    g = {"a": torch.linspace(-3, 3, 1024).reshape(32, 32)}
    out = int8_compress_transform(0)(g)
    assert float((out["a"] - g["a"]).abs().max()) < 3.0 / 127 * 2
    assert out["a"].dtype == g["a"].dtype


def test_topk_error_feedback_accumulates():
    transform, init = topk_ef_transform(k_frac=0.25)
    g = {"a": torch.tensor([1.0, -2.0, 0.1, 0.05])}
    res = init(g)
    sent1, res = transform(g, res)
    assert int(torch.count_nonzero(sent1["a"])) == 1
    assert float(sent1["a"][1]) == -2.0
    sent2, res = transform(g, res)
    assert float(sent2["a"][0]) != 0.0


def test_supervisor_drives_the_port_train_step_through_a_failure(tmp_path):
    """The supervisor around the port's train step and checkpoints: a
    host failure rolls back to the last checkpoint and the run resumes
    to the same final state as an uninterrupted one."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_state_tree
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW

    cfg = get_reduced("h2o-danube-3-4b", n_layers=2)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    opt = AdamW(lr=1e-3)
    train_step = make_train_step(cfg, opt)

    def fresh():
        model = init_params(cfg, 0, device="cpu")
        return model, opt.init(model)

    def run(fail_at):
        mgr = CheckpointManager(tmp_path / f"ck{fail_at}", keep=2)
        failed = []

        def step_fn(state, step, plan):
            if step == fail_at and not failed:
                failed.append(step)
                raise TrainSupervisor.HostFailure(plan.hosts[-1])
            batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(step).items()}
            model, st, _ = train_step(*state, batch)
            return model, st

        def restore_fn():
            model, st = fresh()
            _, step = mgr.restore(train_state_tree(model, st))
            return (model, st), step

        sup = TrainSupervisor(n_hosts=2, global_batch=4, step_fn=step_fn,
                              save_fn=lambda s, step: mgr.save(step, train_state_tree(*s)),
                              restore_fn=restore_fn, checkpoint_every=2)
        (model, st), step = sup.run(fresh(), 0, 5)
        mgr.wait()
        return model, st, step

    a, sa, _ = run(fail_at=-1)
    b, sb, _ = run(fail_at=3)
    assert int(sa.step) == int(sb.step) == 5
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
