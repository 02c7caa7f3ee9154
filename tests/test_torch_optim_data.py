"""The port's token pipeline and AdamW against the JAX package's, on the CPU.

Batches are bit-identical to ``repro.data.pipeline``'s (NumPy on both
sides).  One AdamW update equals ``repro.optim.AdamW``'s within 1e-6
relative in f32 (the two frameworks may round a sum or a fused step
differently), and within one bf16 ulp of the largest value where the
moments or the parameters are bf16; clipping, decay on matrices only
and both schedules (at 0, inside the warm-up, at its end and past the
end) are held to the reference the same way.  The port's copies of
``tests/test_data_optim.py``'s cases follow.
"""
import numpy as np
import pytest
import torch

from repro_torch.data import DataConfig, TokenPipeline, make_batch_specs
from repro_torch.optim import AdamW, cosine_schedule, linear_warmup_cosine

REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_pipeline_batches_equal_the_reference_bit_for_bit(n_hosts):
    pytest.importorskip("jax")
    from repro.data.pipeline import DataConfig as JConfig, TokenPipeline as JPipeline

    kw = dict(vocab_size=1000, seq_len=48, global_batch=4, seed=3)
    for host in range(n_hosts):
        got = TokenPipeline(DataConfig(**kw), host_id=host, n_hosts=n_hosts)
        want = JPipeline(JConfig(**kw), host_id=host, n_hosts=n_hosts)
        np.testing.assert_array_equal(got._motifs, want._motifs)
        for step in range(8):
            a, b = got.batch_at(step), want.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])


def test_pipeline_prefetch_equals_the_reference_bit_for_bit():
    pytest.importorskip("jax")
    from repro.data.pipeline import DataConfig as JConfig, TokenPipeline as JPipeline

    kw = dict(vocab_size=500, seq_len=16, global_batch=2, seed=11)
    pipe = TokenPipeline(DataConfig(**kw), prefetch=3)
    it = iter(pipe)
    got = [next(it) for _ in range(8)]
    pipe.close()
    want = JPipeline(JConfig(**kw))
    for step, b in enumerate(got):
        for k in b:
            np.testing.assert_array_equal(b[k], want.batch_at(step)[k])


@pytest.mark.parametrize("arch,shape", [("h2o-danube-3-4b", "train_4k"),
                                        ("whisper-small", "train_4k"),
                                        ("internvl2-2b", "prefill_32k"),
                                        ("granite-3-8b", "decode_32k")])
def test_batch_specs_match_the_reference(arch, shape):
    pytest.importorskip("jax")
    import repro.configs as jcfg
    from repro.data.pipeline import make_batch_specs as jspecs

    import repro_torch.configs as tcfg

    got = make_batch_specs(tcfg.get_config(arch), tcfg.SHAPES[shape])
    want = jspecs(jcfg.get_config(arch), jcfg.SHAPES[shape])
    assert got.keys() == want.keys()
    for k, (shp, dt) in got.items():
        assert shp == want[k].shape
        assert str(dt).replace("torch.", "") == str(want[k].dtype)


# ---------------------------------------------------------------------------
# AdamW against the reference
# ---------------------------------------------------------------------------


def _draws(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    params = {"mat": rng.standard_normal((6, 5)).astype(np.float32),
              "vec": rng.standard_normal(7).astype(np.float32),
              "cube": rng.standard_normal((2, 3, 4)).astype(np.float32)}
    grads = [{k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


def _run_both(opt_kw, params, grads, param_dtype="float32"):
    """Three updates by each package; returns the (params, state,
    metrics) of each, as numpy in f32."""
    jax, jnp = _jax()
    from repro.optim import AdamW as JAdamW, linear_warmup_cosine as jwarm

    jkw, tkw = dict(opt_kw), dict(opt_kw)
    if "warmup" in opt_kw:  # (base_lr, warmup, total): each package's own schedule
        for kw, sched in ((jkw, jwarm), (tkw, linear_warmup_cosine)):
            kw["lr"] = sched(*kw.pop("warmup"))
    jopt, topt = JAdamW(**jkw), AdamW(**tkw)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    jp = {k: jnp.asarray(v, param_dtype) for k, v in params.items()}
    tp = {k: torch.tensor(v).to(tdt) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js, jm = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts, tm = topt.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
    f32 = lambda t: np.asarray(t.float() if isinstance(t, torch.Tensor) else
                               np.asarray(t, np.float32), np.float32)
    pack = lambda p, s, m: ({k: f32(v) for k, v in p.items()},
                            {k: f32(v) for k, v in s.mu.items()},
                            {k: f32(v) for k, v in s.nu.items()},
                            {k: float(f32(v)) for k, v in m.items()}, int(s.step))
    return pack(tp, ts, tm), pack(jp, js, jm)


def _close(got: dict, want: dict, tol_of) -> None:
    for k in want:
        tol = tol_of(want[k])
        err = np.abs(got[k] - want[k]).max()
        assert err <= tol, (k, err, tol)


@pytest.mark.parametrize("clip", [None, 1.0])
def test_adamw_update_matches_the_reference_in_f32(clip):
    params, grads = _draws(0, scale=3.0)
    kw = dict(warmup=(1e-2, 2, 10), weight_decay=0.1, clip_norm=clip)
    got, want = _run_both(kw, params, grads)
    rel = lambda w: REL * max(float(np.abs(w).max()), 1e-30)
    for a, b in zip(got[:3], want[:3]):
        _close(a, b, rel)
    for k in want[3]:
        assert got[3][k] == pytest.approx(want[3][k], rel=REL), k
    assert got[4] == want[4] == 3


def test_adamw_bf16_moments_within_one_ulp():
    params, grads = _draws(1)
    kw = dict(lr=1e-3, moment_dtype="bfloat16")
    got, want = _run_both(kw, params, grads)
    ulp = lambda w: 2.0 ** -7 * float(np.abs(w).max())  # one bf16 ulp of the largest
    for a, b in zip(got[:3], want[:3]):
        _close(a, b, ulp)


def test_adamw_bf16_params_within_one_ulp():
    params, grads = _draws(2)
    got, want = _run_both(dict(lr=1e-2), params, grads, param_dtype="bfloat16")
    _close(got[0], want[0], lambda w: 2.0 ** -7 * float(np.abs(w).max()))


def test_adamw_clipping_scales_as_the_reference():
    params, grads = _draws(3, scale=100.0)
    got, want = _run_both(dict(lr=1e-3, clip_norm=0.5), params, grads[:1])
    assert got[3]["grad_norm"] > 100 and got[3]["grad_norm"] == pytest.approx(
        want[3]["grad_norm"], rel=REL)
    _close(got[1], want[1], lambda w: REL * float(np.abs(w).max()))


def test_adamw_decays_matrices_only_as_the_reference():
    params, _ = _draws(4)
    zero = [{k: np.zeros_like(v) for k, v in params.items()}]
    got, want = _run_both(dict(lr=0.1, weight_decay=1.0, clip_norm=None), params, zero)
    _close(got[0], want[0], lambda w: REL * float(np.abs(w).max()))
    np.testing.assert_array_equal(got[0]["vec"], params["vec"])
    assert not np.array_equal(got[0]["mat"], params["mat"])


@pytest.mark.parametrize("warmup,total", [(5, 50), (1, 7), (20, 21)])
def test_schedules_match_the_reference(warmup, total):
    jax, jnp = _jax()
    from repro.optim import cosine_schedule as jcos, linear_warmup_cosine as jwarm

    for got, want in ((linear_warmup_cosine(3e-4, warmup, total), jwarm(3e-4, warmup, total)),
                      (cosine_schedule(2.0, total, 0.2), jcos(2.0, total, 0.2))):
        for step in (0, warmup // 2, warmup - 1, warmup, (warmup + total) // 2, total,
                     total + 5):
            g = float(got(torch.tensor(step, dtype=torch.int32)))
            w = float(want(jnp.int32(step)))
            assert g == pytest.approx(w, rel=REL, abs=1e-12), (step, g, w)


def test_opt_state_layout():
    params = {"a": torch.ones(3, 2), "b": torch.ones(4, dtype=torch.bfloat16)}
    st = AdamW(moment_dtype="bfloat16").init(params)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert st.mu.keys() == st.nu.keys() == params.keys()
    assert all(m.dtype == torch.bfloat16 for m in st.mu.values())
    assert st.mu["a"].shape == (3, 2)


def test_update_writes_params_and_moments_in_place():
    params = {"w": torch.ones(3, 3)}
    opt = AdamW(lr=0.1)
    st = opt.init(params)
    w, mu = params["w"], st.mu["w"]
    out, st2, _ = opt.update({"w": torch.ones(3, 3)}, st, params)
    assert out["w"] is w and st2.mu["w"] is mu
    assert float(w[0, 0]) < 1.0 and float(mu[0, 0]) > 0


def test_update_takes_a_module():
    lin = torch.nn.Linear(3, 2)
    opt = AdamW(lr=0.1)
    st = opt.init(lin)
    assert set(st.mu) == {"weight", "bias"}
    before = lin.weight.detach().clone()
    opt.update({"weight": torch.ones(2, 3), "bias": torch.ones(2)}, st, lin)
    assert not torch.equal(before, lin.weight.detach())


# ---------------------------------------------------------------------------
# the port's copies of tests/test_data_optim.py
# ---------------------------------------------------------------------------


def test_pipeline_deterministic():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=7)
    a = TokenPipeline(cfg).batch_at(5)
    b = TokenPipeline(cfg).batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = TokenPipeline(cfg).batch_at(6)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_pipeline_labels_are_shifted_tokens():
    b = TokenPipeline(DataConfig(vocab_size=100, seq_len=16, global_batch=2)).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_host_shards_disjoint_rows():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=8)
    s0 = TokenPipeline(cfg, host_id=0, n_hosts=4).batch_at(2)
    s1 = TokenPipeline(cfg, host_id=1, n_hosts=4).batch_at(2)
    assert s0["tokens"].shape == (2, 8)
    assert not np.array_equal(s0["tokens"], s1["tokens"])


def test_token_range():
    b = TokenPipeline(DataConfig(vocab_size=37, seq_len=64, global_batch=4)).batch_at(0)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 37


def test_adamw_converges_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, clip_norm=None)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state, _ = opt.update({"x": 2 * params["x"]}, state, params)
    assert float(params["x"].abs().max()) < 1e-2


def test_adamw_clipping():
    opt = AdamW(lr=0.0, clip_norm=1.0)
    params = {"x": torch.zeros(3)}
    _, _, m = opt.update({"x": torch.tensor([3.0, 4.0, 0.0])}, opt.init(params), params)
    assert float(m["grad_norm"]) == pytest.approx(5.0)


def test_cosine_schedule_endpoints():
    lr = cosine_schedule(1.0, 100, final_frac=0.1)
    assert float(lr(0)) == pytest.approx(1.0)
    assert float(lr(100)) == pytest.approx(0.1)


def test_schedule_monotone_warmup_then_decay():
    for warmup, total in ((1, 60), (10, 100), (50, 500)):
        lr = linear_warmup_cosine(1e-3, warmup, total)
        vals = [float(lr(s)) for s in range(0, total, max(1, total // 50))]
        assert max(vals) <= 1e-3 * 1.01
        assert float(lr(total)) < max(vals)
