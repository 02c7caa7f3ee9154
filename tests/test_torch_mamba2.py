"""The port's Mamba2 path against the JAX package's, on the CPU.

``ssd_scan_plain`` (what the SSD wrapper runs for CPU tensors, and what
the CUDA kernel is held to on the card) against the Pallas kernel in
interpret mode and the ``ref.py`` oracle, on tests/test_kernels.py's
shapes and tolerance (2e-3); the torch twins ``ssd_chunked`` and
``ssd_step`` and the mixer (``mamba2_apply``/``mamba2_step``) against
their JAX originals; then zamba2-2.7b reduced to 12 layers of
``MMMMMH`` × 2 (the full config's segment, two reps, the shared
attention block used twice: ``get_reduced`` alone gives the
non-periodic ``MMMMMHMMMM``), with the JAX package's weights carried
over by ``params_from_jax`` and seeded numpy tokens.  The whole-model
tolerance is tests/test_torch_models.py's, 1e-4 on logits of magnitude
~1; a state leaf is held to 1e-4 of its largest magnitude where that
exceeds 1.
Inputs come from seeded numpy and cross as numpy arrays.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models as jm
from repro.kernels.mamba2_scan import ssd_scan as jax_ssd_scan
from repro.kernels.mamba2_scan import ssd_scan_ref
from repro.models import mamba2 as jmamba
import repro_torch.configs as tcfg
from repro_torch.kernels.mamba2_scan import launches, ssd_scan, ssd_scan_plain
from repro_torch.kernels.mamba2_scan.ops import TC_CHUNK
from repro_torch.launch import steps as tsteps
from repro_torch.models import decode_step, forward, mamba2 as tmamba, model as tmodel
from repro_torch.models import prefill
from repro_torch.models.convert import params_from_jax

KERNEL_TOL = 2e-3  # tests/test_kernels.py's
TOL = 1e-4
BF16_REL = 2.0 ** -7  # one bf16 ulp of the largest output
N_DECODE = 4
ZAMBA = dict(n_layers=12, layer_pattern="MMMMMH" * 2)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores; torch's
    default of one thread per core in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())


def _rel(got: torch.Tensor, want) -> float:
    """max |got - want|, over the largest |want| where that exceeds 1."""
    return _err(got, want) / max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))


def _ssd_inputs(seed, b, s, h, p, n, with_state):
    """x, dt (softplus'd), A (< 0), B, C and an optional initial state,
    as numpy f32, the way tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    x, dt = f(b, s, h, p), np.logaddexp(f(b, s, h), 0).astype(np.float32)
    A = (-np.exp(f(h) * 0.5)).astype(np.float32)
    B, C = f(b, s, n), f(b, s, n)
    s0 = f(b, h, p, n) if with_state else None
    return x, dt, A, B, C, s0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 3, 16, 8, 16),
    (1, 100, 2, 32, 16, 32),   # ragged: the Pallas wrapper pads, the port does not
    (1, 256, 1, 64, 64, 128),
])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_matches_pallas_kernel_and_ref(b, s, h, p, n, chunk, with_state):
    ins = _ssd_inputs(2, b, s, h, p, n, with_state)
    before = launches["ssd_scan"]
    y, fin = ssd_scan(*map(_t, ins))
    assert launches["ssd_scan"] == before  # CPU tensors: the plain version
    assert y.shape == (b, s, h, p) and y.dtype == torch.float32
    assert fin.shape == (b, h, p, n) and fin.dtype == torch.float32
    x, dt, A, B, C, s0 = map(_j, ins)
    yk, fk = jax_ssd_scan(x, dt, A, B, C, s0, chunk=chunk)
    yr, fr = ssd_scan_ref(x, dt, A, B, C, init_state=s0)
    for want_y, want_f in ((yk, fk), (yr, fr)):
        assert _err(y, want_y) < KERNEL_TOL
        assert _err(fin, want_f) < KERNEL_TOL


def test_plain_takes_the_paths_bf16_activations():
    """x, B and C in bf16 with an f32 dt, as the model passes them: the
    state stays f32, y comes back in bf16 within one ulp of the f32
    oracle on the same rounded inputs."""
    x, dt, A, B, C, s0 = _ssd_inputs(3, 2, 70, 3, 16, 16, True)
    xb, Bb, Cb = (torch.from_numpy(a).bfloat16() for a in (x, B, C))
    y, fin = ssd_scan(xb, _t(dt), _t(A), Bb, Cb, _t(s0))
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    yr, fr = ssd_scan_ref(*(jnp.asarray(t.float().numpy()) for t in (xb,)),
                          jnp.asarray(dt), jnp.asarray(A),
                          jnp.asarray(Bb.float().numpy()), jnp.asarray(Cb.float().numpy()),
                          init_state=jnp.asarray(s0))
    assert _err(y, yr) <= BF16_REL * float(jnp.abs(yr).max())
    assert _err(fin, fr) < KERNEL_TOL


def test_wrapper_checks_its_inputs():
    x, dt, A, B, C, _ = map(_t, _ssd_inputs(4, 1, 8, 2, 4, 8, False))
    with pytest.raises(TypeError, match="dt"):
        ssd_scan(x, dt.bfloat16(), A, B, C)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        ssd_scan(x, dt, A, B.bfloat16(), C)
    with pytest.raises(ValueError, match="init_state"):
        ssd_scan(x, dt, A, B, C, torch.zeros(1, 2, 4, 7))
    with pytest.raises(ValueError, match="C"):
        ssd_scan(x, dt, A, B, C[:, :5])


# ---------------------------------------------------------------------------
# the tensor-core kernel's precision scheme, emulated
# ---------------------------------------------------------------------------


def _dual_form(x, dt, A, B, C, s0, *, split, chunk=TC_CHUNK):
    """The bf16 kernel's arithmetic (``ssd_scan_tc_kernel``), emulated on
    the CPU: per chunk of ``chunk`` tokens, cum = cumsum(dt A) and

        S = C Bᵀ;  P = (t >= l) exp(cum_t - cum_l) dt_l S
        y = P x + exp(cum_t) (C stateᵀ)
        state = exp(cum_Q) state + (x w)ᵀ B,  w_l = exp(cum_Q - cum_l) dt_l

    x, B and C enter as their bf16 values; each factor the kernel computes
    in f32 (P, the state for C stateᵀ, x w) enters its product as a bf16
    pair hi + lo with lo = bf16(v - hi) (``split``, the kernel's scheme),
    or rounded once to bf16.  Products of bf16 values are exact in f32,
    and every sum is f32, as on the tensor cores."""
    xf, Bf, Cf = x.float(), B.float(), C.float()
    b, s, h, p = x.shape
    state = (torch.zeros(b, h, p, B.shape[-1]) if s0 is None else s0.clone())
    y = torch.empty(b, s, h, p)

    def operand(v):
        hi = v.bfloat16().float()
        return (hi, (v - hi).bfloat16().float()) if split else (hi,)

    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)  # the last chunk may be shorter
        d = dt[:, sl]  # [b, Q, h]
        q = d.shape[1]
        cum = torch.cumsum(d * A, dim=1)
        S = Cf[:, sl] @ Bf[:, sl].transpose(1, 2)  # [b, t, l]
        below = torch.ones(q, q, dtype=torch.bool).tril()[None, :, :, None]
        decay = torch.where(below, torch.exp(cum[:, :, None] - cum[:, None]), 0.0)
        P = decay * d[:, None] * S[..., None]  # [b, t, l, h]
        y_diag = sum(torch.einsum("btlh,blhp->bthp", f, xf[:, sl]) for f in operand(P))
        y_off = sum(torch.einsum("btn,bhpn->bthp", Cf[:, sl], f) for f in operand(state))
        y[:, sl] = y_diag + torch.exp(cum)[..., None] * y_off
        w = torch.exp(cum[:, -1:] - cum) * d  # [b, Q, h]
        xw = xf[:, sl] * w[..., None]
        state = state * torch.exp(cum[:, -1])[..., None, None] + sum(
            torch.einsum("blhp,bln->bhpn", f, Bf[:, sl]) for f in operand(xw))
    return y.to(x.dtype), state


# chip_smoke.ssd_inputs's draw at a quarter of zamba2's heads and an
# eighth of its prompt, with the path's p 64 and n 64; then a ragged last
# chunk (1000 = 15 x 64 + 40) with an initial state
@pytest.mark.parametrize("s,with_state", [(1024, False), (1000, True)])
def test_tc_kernel_precision_scheme_holds_the_tolerances(s, with_state):
    """The hi/lo split keeps the final state within SSD_TOL (2e-3, the
    card's kernel-vs-plain bound) and y within 2^-7 of its largest value
    of the f32 recurrence; rounding each computed factor once to bf16
    puts the state more than five times over that bound."""
    x, dt, A, B, C, s0 = map(_t, _ssd_inputs(9, 1, s, 4, 64, 64, with_state))
    x, B, C = x.bfloat16(), B.bfloat16(), C.bfloat16()
    y_ref, fin_ref = ssd_scan_plain(x, dt, A, B, C, s0)
    tol_y = BF16_REL * float(y_ref.float().abs().max())
    y, fin = _dual_form(x, dt, A, B, C, s0, split=True)
    assert float((y.float() - y_ref.float()).abs().max()) <= tol_y
    assert float((fin - fin_ref).abs().max()) <= KERNEL_TOL
    _, fin1 = _dual_form(x, dt, A, B, C, s0, split=False)
    assert float((fin1 - fin_ref).abs().max()) > 5 * KERNEL_TOL


# ---------------------------------------------------------------------------
# the torch twins and the mixer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk,with_state", [(64, 16, False), (50, 16, True)])
def test_ssd_chunked_matches_repro(s, chunk, with_state):
    ins = _ssd_inputs(5, 2, s, 3, 16, 8, with_state)
    y, fin = tmamba.ssd_chunked(*map(_t, ins[:5]), chunk=chunk, init_state=_t(ins[5]))
    yj, fj = jmamba.ssd_chunked(*map(_j, ins[:5]), chunk=chunk, init_state=_j(ins[5]))
    assert y.shape == yj.shape and fin.shape == fj.shape
    assert _err(y, yj) < TOL and _err(fin, fj) < TOL
    # the chunked twin and the recurrence compute one function
    yp, fp = ssd_scan_plain(*map(_t, ins))
    assert _err(y, yp.numpy()) < KERNEL_TOL and _err(fin, fp.numpy()) < KERNEL_TOL


def test_ssd_step_matches_repro():
    x, dt, A, B, C, s0 = _ssd_inputs(6, 2, 1, 3, 16, 8, True)
    y, new = tmamba.ssd_step(_t(s0), _t(x[:, 0]), _t(dt[:, 0]), _t(A), _t(B[:, 0]),
                             _t(C[:, 0]))
    yj, nj = jmamba.ssd_step(_j(s0), _j(x[:, 0]), _j(dt[:, 0]), _j(A), _j(B[:, 0]),
                             _j(C[:, 0]))
    assert _err(y, yj) < TOL and _err(new, nj) < TOL


@pytest.mark.parametrize("use_flash", [True, False])
def test_mixer_prefill_then_steps_match_repro(use_flash):
    """``mamba2_apply`` on a prompt with a carried-in state, then two
    ``mamba2_step`` tokens, against the JAX mixer on its own weights."""
    jc = jcfg.get_reduced("zamba2-2.7b", **ZAMBA)
    tc = tcfg.get_reduced("zamba2-2.7b", use_flash=use_flash, **ZAMBA)
    p = jax.tree.map(np.asarray, jmamba.mamba2_init(jax.random.PRNGKey(1), jc))
    m = tmamba.Mamba2(tc, device="cpu")
    for name, w in m.named_parameters():
        w.copy_(torch.from_numpy(np.array(p[name])))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 37, jc.d_model), dtype=np.float32)
    st0 = {k: v[0] for k, v in jmamba.init_mamba2_state(jc, 2, 1).items()}
    st0 = {k: np.asarray(v) + rng.standard_normal(v.shape, dtype=np.float32)
           for k, v in st0.items()}
    japply = jax.jit(lambda p, x, st: jmamba.mamba2_apply(jc, p, x, init_state=st))
    jstep = jax.jit(functools.partial(jmamba.mamba2_step, jc))
    yj, sj = japply(p, jnp.asarray(x[:, :35]), jax.tree.map(jnp.asarray, st0))
    y, st = tmamba.mamba2_apply(tc, m, torch.from_numpy(x[:, :35]),
                                init_state={k: torch.from_numpy(v) for k, v in st0.items()})
    assert _err(y, yj) < TOL
    for t in (35, 36):
        yj, sj = jstep(p, jnp.asarray(x[:, t:t + 1]), sj)
        y, st = tmamba.mamba2_step(tc, m, torch.from_numpy(x[:, t:t + 1]), st)
        assert _err(y, yj) < TOL
    assert sorted(st) == sorted(sj)
    for k in st:
        assert st[k].shape == sj[k].shape and _rel(st[k], sj[k]) < TOL, k


# ---------------------------------------------------------------------------
# zamba2 through the serving entry points on identical weights
# ---------------------------------------------------------------------------

PROMPT, MAX_LEN = 40, 48  # 40 tokens: more than one SSM chunk of 32, not a multiple


@functools.lru_cache(maxsize=None)
def _reference():
    """The JAX package's numbers (computed once per process)."""
    cfg = jcfg.get_reduced("zamba2-2.7b", **ZAMBA)
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, PROMPT), dtype=np.int32)
    feed = rng.integers(0, cfg.vocab_size, (N_DECODE, 2), dtype=np.int32)
    logits, _ = jax.jit(functools.partial(jm.forward, cfg))(params, {"tokens": tokens})
    pre = jax.jit(functools.partial(jm.prefill, cfg), static_argnames="max_len")
    last, state = pre(params, {"tokens": tokens}, max_len=MAX_LEN)
    segs = jax.tree.map(np.asarray, state["segs"])
    step = jax.jit(functools.partial(jm.decode_step, cfg))
    steps = []
    for t in range(N_DECODE):
        lg, state = step(params, jnp.asarray(feed[t]), state)
        steps.append(np.asarray(lg))
    return dict(params=jax.tree.map(np.asarray, params), tokens=tokens, feed=feed,
                logits=np.asarray(logits), last=np.asarray(last), segs=segs,
                steps=steps, pos=np.asarray(state["pos"]))


def _port(use_flash):
    cfg = tcfg.get_reduced("zamba2-2.7b", use_flash=use_flash, **ZAMBA)
    ref = _reference()
    return cfg, params_from_jax(cfg, ref["params"], device="cpu"), ref


def test_reduced_config_is_the_jax_packages_quirk():
    """``reduced`` computes the hybrid period as ``pat.index("H", 1)`` = 5,
    so ``get_reduced`` alone is ``MMMMMHMMMM`` in both packages; the tests
    here override it with the full config's periodic segment."""
    for cfg in (jcfg.get_reduced("zamba2-2.7b"), tcfg.get_reduced("zamba2-2.7b")):
        assert cfg.pattern == "MMMMMHMMMM"
    cfg = tcfg.get_reduced("zamba2-2.7b", **ZAMBA)
    assert tmodel.plan_segments(cfg) == (tmodel.Segment("MMMMMH", 2, False),)
    assert tmodel.plan_segments(tcfg.get_config("zamba2-2.7b")) == (
        tmodel.Segment("MMMMMH", 9, True),)


@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_matches_repro(use_flash):
    cfg, params, ref = _port(use_flash)
    logits, aux = forward(cfg, params, {"tokens": torch.from_numpy(ref["tokens"])})
    assert logits.shape == ref["logits"].shape and float(aux) == 0.0
    assert _rel(logits, ref["logits"]) < TOL


@pytest.mark.parametrize("use_flash", [True, False])
def test_prefill_state_and_decode_match_repro(use_flash):
    cfg, params, ref = _port(use_flash)
    last, state = prefill(cfg, params, {"tokens": torch.from_numpy(ref["tokens"])},
                          max_len=MAX_LEN)
    assert _rel(last, ref["last"]) < TOL
    seg = tmodel.plan_segments(cfg)[0]
    for r in range(seg.reps):
        for key, blk in state.segs[0][r].items():
            want = jax.tree.map(lambda a: a[r], ref["segs"][0][key])
            want_keys = {"conv_x", "conv_B", "conv_C", "ssm"} | (
                {"att"} if key.endswith("H") else set())
            assert set(blk) == set(want) == want_keys, key
            for name, got in blk.items():
                pairs = ([(got[kv], want[name][kv]) for kv in ("k", "v")]
                         if name == "att" else [(got, want[name])])
                for g, w in pairs:
                    assert g.shape == w.shape and g.dtype == getattr(torch, str(w.dtype))
                    assert _rel(g, w) < TOL, (r, key, name)
    for t in range(N_DECODE):
        lg, state = decode_step(cfg, params, torch.from_numpy(ref["feed"][t]), state)
        assert _rel(lg, ref["steps"][t]) < TOL, t
    assert state.pos.tolist() == ref["pos"].tolist() == [PROMPT + N_DECODE] * 2


def test_prefill_state_keeps_no_activation_alive():
    """Every decode-state tensor owns just its own bytes: a slice of a
    prompt-length activation kept as a view would hold the whole
    activation for as long as the state lives (JAX's slices are copies)."""
    cfg, params, ref = _port(True)
    _, state = prefill(cfg, params, {"tokens": torch.from_numpy(ref["tokens"])},
                       max_len=MAX_LEN)
    for rep in state.segs[0]:
        for blk in rep.values():
            for name, t in blk.items():
                for u in (t.values() if isinstance(t, dict) else (t,)):
                    assert u.untyped_storage().nbytes() == u.numel() * u.element_size(), name


def test_kernel_routes_are_taken_by_prefill_only(monkeypatch):
    """With ``use_flash`` prefill calls the SSD wrapper once per ``M``/``H``
    layer and the flash wrapper once per ``H`` layer; decode calls
    neither; ``use_flash=False`` calls neither at all."""
    calls = []

    def spy(name, real):
        def wrapped(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        return wrapped

    monkeypatch.setattr(tmamba, "ssd_scan", spy("ssd", tmamba.ssd_scan))
    monkeypatch.setattr(tmodel, "flash_attention", spy("flash", tmodel.flash_attention))
    cfg, params, ref = _port(True)
    _, state = prefill(cfg, params, {"tokens": torch.from_numpy(ref["tokens"])},
                       max_len=MAX_LEN)
    assert calls.count("ssd") == cfg.n_layers == 12
    assert calls.count("flash") == cfg.pattern.count("H") == 2
    calls.clear()
    decode_step(cfg, params, torch.from_numpy(ref["feed"][0]), state)
    assert calls == []
    cfg, params, ref = _port(False)
    prefill(cfg, params, {"tokens": torch.from_numpy(ref["tokens"])}, max_len=MAX_LEN)
    assert calls == []


def test_serve_steps_follow_greedy_decode():
    cfg, params, ref = _port(True)
    shape = tcfg.ShapeSpec("prefill_tiny", seq_len=MAX_LEN, global_batch=2, kind="prefill")
    last, state = tsteps.make_prefill_step(cfg, shape)(
        params, {"tokens": torch.from_numpy(ref["tokens"])})
    assert _rel(last, ref["last"]) < TOL
    serve = tsteps.make_serve_step(cfg)
    toks = last.argmax(-1).to(torch.int32)
    for _ in range(3):
        nxt, state = serve(params, state, toks)
        assert nxt.dtype == torch.int32 and nxt.shape == (2,)
        toks = nxt
    assert state.pos.tolist() == [PROMPT + 3] * 2


def test_init_params_draws_the_jax_packages_kinds():
    cfg = tcfg.get_reduced("zamba2-2.7b", **ZAMBA)
    model = tmodel.init_params(cfg, seed=0, device="cpu")
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg.get_reduced("zamba2-2.7b", **ZAMBA),
                                                   jax.random.PRNGKey(0)))
    mix = model.segs[0][1]["5H"].mamba
    for name, w in mix.named_parameters():
        want = tree["segs"][0]["5H"]["mamba"][name][1]
        assert w.shape == want.shape and w.dtype == getattr(torch, str(want.dtype)), name
        if name in tmamba.CONST_INIT:  # constants: equal to the JAX leaf
            assert np.array_equal(w.numpy(), want), name
        else:  # fan-in truncated normal: within 2/sqrt(fan_in), not constant
            bound = 2.0 / np.sqrt(w.shape[0] if w.ndim > 1 else w.shape[-1])
            assert float(w.abs().max()) <= bound + 1e-6 and float(w.std()) > 0, name
    assert mix.A_log.dtype == mix.D.dtype == mix.dt_bias.dtype == torch.float32
    assert torch.equal(model.segs[0][0]["0M"].ln, torch.ones(cfg.d_model))
    names = {n for n, _ in model.named_parameters()}
    assert {"shared_attn.attn.wq", "shared_attn.mlp.w_gate", "segs.0.1.5H.mamba.w_out",
            "segs.0.0.0M.mamba.conv_x_b"} <= names
    assert "unembed" not in names  # zamba2 ties its embeddings


def test_params_from_jax_carries_f32_leaves_bit_exact_in_bf16():
    kw = dict(ZAMBA, dtype="bfloat16", param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jm.init_params(
        jcfg.get_reduced("zamba2-2.7b", **kw), jax.random.PRNGKey(2)))
    model = params_from_jax(tcfg.get_reduced("zamba2-2.7b", **kw), tree, device="cpu")
    mix = model.segs[0][1]["2M"].mamba
    assert mix.w_x.dtype == torch.bfloat16 and mix.A_log.dtype == torch.float32
    assert np.array_equal(mix.w_x.view(torch.int16).numpy(),
                          tree["segs"][0]["2M"]["mamba"]["w_x"][1].view(np.int16))
    assert np.array_equal(mix.dt_bias.numpy(), tree["segs"][0]["2M"]["mamba"]["dt_bias"][1])
    wq = model.shared_attn.attn.wq
    assert np.array_equal(wq.view(torch.int16).numpy(),
                          tree["shared_attn"]["attn"]["wq"].view(np.int16))
    bad = dict(tree, shared_attn=dict(tree["shared_attn"], ln1=tree["shared_attn"]["ln1"][:3]))
    with pytest.raises(ValueError, match="shared_attn"):
        params_from_jax(tcfg.get_reduced("zamba2-2.7b", **kw), bad, device="cpu")


def test_decode_state_layout_matches_repro():
    jc = jcfg.get_reduced("zamba2-2.7b", **ZAMBA)
    want = jax.tree.map(lambda a: (a.shape[1:], str(a.dtype)),
                        jm.make_decode_state(jc, 3, 20)["segs"][0])
    state = tmodel.make_decode_state(tcfg.get_reduced("zamba2-2.7b", **ZAMBA), 3, 20,
                                     device="cpu")
    for r in range(2):
        got = {k: {n: ({kv: (tuple(t.shape), str(t.dtype).split(".")[1])
                        for kv, t in v.items()} if n == "att"
                       else (tuple(v.shape), str(v.dtype).split(".")[1]))
                   for n, v in blk.items()}
               for k, blk in state.segs[0][r].items()}
        assert got == want
    assert dataclasses.is_dataclass(state) and state.pos.tolist() == [0, 0, 0]
