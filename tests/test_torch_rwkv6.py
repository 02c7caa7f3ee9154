"""The port's RWKV6 path against the JAX package's, on the CPU.

``wkv6_plain`` (what the wkv wrapper runs for CPU tensors, and what the
CUDA kernels are held to on the card) against the Pallas kernel in
interpret mode and the ``ref.py`` oracle, on tests/test_kernels.py's
shapes and tolerance (1e-3); the bf16 tensor-core kernel's arithmetic
(``_tc_form``) against ``wkv6_plain``, with and without its hi/lo
splits; the torch twins ``wkv_chunked`` and
``wkv_step`` and the block (``rwkv6_apply``/``rwkv6_step``) against
their JAX originals; then the reduced rwkv6-3b (4 ``R`` layers, head
size 32) with the JAX package's weights carried over by
``params_from_jax`` and seeded numpy tokens.  Whole-model values are
held to 1e-4 of their largest magnitude where that exceeds 1, else to
1e-4 absolute (tests/test_torch_models.py's): its logits reach ~4 and
its wkv states ~50, and the two frameworks' f32 sums, taken in other
orders, differ in proportion (measured: 1.7e-4 on logits up to 3.7,
4.6e-5 of the magnitude).  Inputs come from seeded numpy and cross as numpy
arrays.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models as jm
from repro.kernels.rwkv6_wkv import wkv6 as jax_wkv6
from repro.kernels.rwkv6_wkv import wkv6_ref
from repro.models import rwkv6 as jrwkv
import repro_torch.configs as tcfg
from repro_torch.kernels.flash_attention import BF16_REL_TOL, bf16_rel_err
from repro_torch.kernels.rwkv6_wkv import launches, wkv6, wkv6_plain
from repro_torch.kernels.rwkv6_wkv.ops import TC_CHUNK
from repro_torch.launch import steps as tsteps
from repro_torch.models import decode_step, forward, model as tmodel, prefill
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.convert import params_from_jax

KERNEL_TOL = 1e-3  # tests/test_kernels.py's
TOL = 1e-4
BF16_REL = 2.0 ** -7  # one bf16 ulp of the largest output
N_DECODE = 4
ARCH = "rwkv6-3b"


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


def _wkv_inputs(seed, B, T, H, N, with_state):
    """r, k, v, the decay w in (0.4, 0.95), the bonus u and an optional
    initial state, as numpy f32, the way tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    r, k, v = f(B, T, H, N), f(B, T, H, N), f(B, T, H, N)
    w = (0.55 / (1.0 + np.exp(-f(B, T, H, N))) + 0.4).astype(np.float32)
    u = f(H, N)
    s0 = f(B, H, N, N) if with_state else None
    return r, k, v, w, u, s0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,T,H,N,chunk", [
    (2, 64, 3, 16, 16),
    (1, 100, 2, 32, 32),   # ragged: the Pallas wrapper pads, the port does not
    (1, 128, 2, 64, 64),
])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_matches_pallas_kernel_and_ref(B, T, H, N, chunk, with_state):
    ins = _wkv_inputs(3, B, T, H, N, with_state)
    before = launches["wkv6"]
    y, fin = wkv6(*map(_t, ins))
    assert launches["wkv6"] == before  # CPU tensors: the plain version
    assert y.shape == (B, T, H, N) and y.dtype == torch.float32
    assert fin.shape == (B, H, N, N) and fin.dtype == torch.float32
    r, k, v, w, u, s0 = map(_j, ins)
    yk, fk = jax_wkv6(r, k, v, w, u, s0, chunk=chunk)
    yr, fr = wkv6_ref(r, k, v, w, u, init_state=s0)
    for want_y, want_f in ((yk, fk), (yr, fr)):
        assert _err(y, want_y) < KERNEL_TOL
        assert _err(fin, want_f) < KERNEL_TOL


def test_plain_takes_the_paths_bf16_activations():
    """r, k, v in bf16 with an f32 decay, as the model passes them: the
    state stays f32, y comes back in bf16 within one ulp of the f32
    oracle on the same rounded inputs."""
    r, k, v, w, u, s0 = _wkv_inputs(4, 2, 45, 3, 16, True)
    rb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (r, k, v))
    y, fin = wkv6(rb, kb, vb, _t(w), _t(u), _t(s0))
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    yr, fr = wkv6_ref(*(jnp.asarray(t.float().numpy()) for t in (rb, kb, vb)),
                      jnp.asarray(w), jnp.asarray(u), init_state=jnp.asarray(s0))
    assert _err(y, yr) <= BF16_REL * float(jnp.abs(yr).max())
    assert _err(fin, fr) < KERNEL_TOL


def test_wrapper_checks_its_inputs():
    r, k, v, w, u, _ = map(_t, _wkv_inputs(5, 1, 8, 2, 4, False))
    with pytest.raises(TypeError, match="w is"):
        wkv6(r, k, v, w.bfloat16(), u)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        wkv6(r, k.bfloat16(), v, w, u)
    with pytest.raises(ValueError, match="init_state"):
        wkv6(r, k, v, w, u, torch.zeros(1, 2, 4, 5))
    with pytest.raises(ValueError, match="u is"):
        wkv6(r, k, v, w, u[:1])


# ---------------------------------------------------------------------------
# the tensor-core kernel's precision scheme, emulated
# ---------------------------------------------------------------------------


def _tc_form(r, k, v, w, u, s0, *, split, chunk=TC_CHUNK, sub=16):
    """The bf16 kernel's arithmetic (``wkv6_tc_kernel``), emulated on the
    CPU: per chunk of ``chunk`` tokens and sub-chunk a of ``sub``, with
    w' = max(w, 1e-12) (1 past T) and products taken within the sub-chunk,

        Rd_t = r_t prod(w' of a before t),  Kd_s = k_s prod(w' of a after s),
        T_a = prod(w' of a)
        att[t, s] = (Rd_t D_ab) . Kd_s for s in b < a, D_ab = T_b+1 .. T_a-1
        att[t, s] = sum_i r_t k_s prod_{s<σ<t} w'_σ (s < t in a, exact f32)
        att[t, t] = r_t . (u k_t)
        y = att v + (Rd E_a) S,   E_a = T_0 .. T_a-1
        S = (T_0 .. T_3) S + (Kd F_b)ᵀ v,   F_b = T_b+1 .. T_3

    (each decay is exp(cumprev_t - cum_s) of the recurrence, a product
    in (0, 1]).  r, k, v enter as their bf16 values; each factor computed
    in f32 enters its product as a bf16 pair hi + lo with lo = bf16(x -
    hi) (``split``, the kernel's scheme; a product of two computed factors
    takes hi hi + hi lo + lo hi), or rounded once to bf16.  Products of
    bf16 values are exact in f32 and every sum is f32, as on the tensor
    cores."""
    B, T, H, N = r.shape
    nsub = chunk // sub
    S = torch.zeros(B, H, N, N) if s0 is None else s0.clone()
    y = torch.empty(B, T, H, N)

    def parts(x):
        hi = x.bfloat16().float()
        return (hi, (x - hi).bfloat16().float()) if split else (hi,)

    def both(a, b, eq):  # two computed factors
        (ah, *al), (bh, *bl) = parts(a), parts(b)
        out = torch.einsum(eq, ah, bh)
        for x, z in zip(al, bl):
            out = out + torch.einsum(eq, ah, z) + torch.einsum(eq, x, bh)
        return out

    def one(a, b, eq):  # a computed factor and an input
        return sum(torch.einsum(eq, x, b) for x in parts(a))

    for t0 in range(0, T, chunk):
        nt = min(chunk, T - t0)

        def rows(x, fill):  # the chunk, padded to `chunk` tokens as the kernel's loads pad it
            c = x[:, t0:t0 + nt].float()
            pad = torch.full((B, chunk - nt, H, N), fill)
            return torch.cat([c, pad], 1).view(B, nsub, sub, H, N)

        rc, kc, vc = rows(r, 0.0), rows(k, 0.0), rows(v, 0.0)
        wf = torch.clamp(rows(w, 1.0), min=1e-12)
        one_row = torch.ones_like(wf[:, :, :1])
        before = torch.cumprod(torch.cat([one_row, wf[:, :, :-1]], 2), 2)
        after = torch.flip(torch.cumprod(torch.cat([one_row, torch.flip(wf, [2])[:, :, :-1]], 2), 2), [2])
        Ts = torch.prod(wf, 2)  # [B, nsub, H, N]
        Rd, Kd = rc * before, kc * after
        att = torch.zeros(B, H, chunk, chunk)
        for a in range(nsub):
            ta = slice(sub * a, sub * a + sub)
            for b in range(a):
                D = torch.prod(Ts[:, b + 1:a], 1)  # 1 where empty
                att[:, :, ta, sub * b:sub * b + sub] = both(
                    Rd[:, a] * D[:, None], Kd[:, b], "bthi,bshi->bhts")
            for t in range(sub):
                d = torch.ones(B, H, N)
                for s in range(t - 1, -1, -1):
                    att[:, :, sub * a + t, sub * a + s] = (rc[:, a, t] * d * kc[:, a, s]).sum(-1)
                    d = d * wf[:, a, s]
                att[:, :, sub * a + t, sub * a + t] = (rc[:, a, t] * u * kc[:, a, t]).sum(-1)
        vflat = vc.view(B, chunk, H, N)
        E = torch.stack([torch.prod(Ts[:, :a], 1) for a in range(nsub)], 1)[:, :, None]
        F = torch.stack([torch.prod(Ts[:, a + 1:], 1) for a in range(nsub)], 1)[:, :, None]
        yc = one(att, vflat.transpose(1, 2), "bhts,bhsj->bthj")
        yc = yc + both((Rd * E).view(B, chunk, H, N), S, "bthi,bhij->bthj")
        y[:, t0:t0 + nt] = yc[:, :nt]
        S = S * torch.prod(Ts, 1)[..., None] + one((Kd * F).view(B, chunk, H, N), vflat,
                                             "bshi,bshj->bhij")
    return y.to(r.dtype), S


def _strong_decay_inputs(seed, B, T, H, N, with_state):
    """``_wkv_inputs`` with w = exp(-exp(x)), x ~ N(1.5, 1) (most w near
    0.01, some near 1) and 2% of w exactly 0."""
    r, k, v, _, u, s0 = _wkv_inputs(seed, B, T, H, N, with_state)
    rng = np.random.default_rng(seed + 1)
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, N), dtype=np.float32) + 1.5))
    w[rng.random(w.shape) < 0.02] = 0.0
    return r, k, v, w.astype(np.float32), u, s0


# chip_smoke.wkv_inputs's draw at a tenth of rwkv6-3b's heads and an
# eighth of its prompt, with the path's head size 64; a ragged last chunk
# (1000 = 15 x 64 + 40) with an initial state; the strong-decay draw
@pytest.mark.parametrize("T,with_state,draw", [
    (1024, False, _wkv_inputs), (1000, True, _wkv_inputs), (512, True, _strong_decay_inputs),
])
def test_tc_kernel_precision_scheme_holds_the_tolerances(T, with_state, draw):
    """The hi/lo split keeps the final state within KERNEL_TOL (1e-3, the
    card's kernel-vs-plain bound) and y within 2^-7 of its largest value
    and within ``bf16_rel_err`` 2^-6 of the f32 recurrence; rounding each
    computed factor once to bf16 puts the state over KERNEL_TOL."""
    r, k, v, w, u, s0 = map(_t, draw(9, 1, T, 4, 64, with_state))
    r, k, v = r.bfloat16(), k.bfloat16(), v.bfloat16()
    y_ref, fin_ref = wkv6_plain(r.float(), k.float(), v.float(), w, u, s0)
    y, fin = _tc_form(r, k, v, w, u, s0, split=True)
    assert y.dtype == torch.bfloat16 and torch.isfinite(fin).all()
    assert float((y.float() - y_ref).abs().max()) <= BF16_REL * float(y_ref.abs().max())
    assert bf16_rel_err(y, y_ref) <= BF16_REL_TOL
    assert float((fin - fin_ref).abs().max()) <= KERNEL_TOL
    _, fin1 = _tc_form(r, k, v, w, u, s0, split=False)
    assert float((fin1 - fin_ref).abs().max()) > KERNEL_TOL


# ---------------------------------------------------------------------------
# the torch twins and the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,chunk,with_state", [(64, 16, False), (50, 16, True)])
def test_wkv_chunked_matches_repro(T, chunk, with_state):
    ins = _wkv_inputs(6, 2, T, 3, 16, with_state)
    y, fin = trwkv.wkv_chunked(*map(_t, ins[:5]), chunk=chunk, init_state=_t(ins[5]))
    yj, fj = jrwkv.wkv_chunked(*map(_j, ins[:5]), chunk=chunk, init_state=_j(ins[5]))
    assert y.shape == yj.shape and fin.shape == fj.shape
    assert _err(y, yj) < TOL and _err(fin, fj) < TOL
    # the chunked twin and the recurrence compute one function
    yp, fp = wkv6_plain(*map(_t, ins))
    assert _err(y, yp.numpy()) < KERNEL_TOL and _err(fin, fp.numpy()) < KERNEL_TOL


def test_wkv_step_matches_repro():
    r, k, v, w, u, s0 = _wkv_inputs(7, 2, 1, 3, 16, True)
    y, new = trwkv.wkv_step(*map(_t, (s0, r[:, 0], k[:, 0], v[:, 0], w[:, 0], u)))
    yj, nj = jrwkv.wkv_step(*map(_j, (s0, r[:, 0], k[:, 0], v[:, 0], w[:, 0], u)))
    assert _err(y, yj) < TOL and _err(new, nj) < TOL


@pytest.mark.parametrize("use_flash", [True, False])
def test_block_prefill_then_steps_match_repro(use_flash):
    """``rwkv6_apply`` on a prompt with a carried-in state, then two
    ``rwkv6_step`` tokens, against the JAX block on its own weights."""
    jc = jcfg.get_reduced(ARCH)
    tc = tcfg.get_reduced(ARCH, use_flash=use_flash)
    p = jax.tree.map(np.asarray, jrwkv.rwkv6_init(jax.random.PRNGKey(1), jc))
    m = trwkv.RWKV6(tc, device="cpu")
    for name, w in m.named_parameters():
        w.copy_(torch.from_numpy(np.array(p[name])))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 37, jc.d_model), dtype=np.float32)
    st0 = {k: np.asarray(v[0]) + rng.standard_normal(v.shape[1:], dtype=np.float32)
           for k, v in jrwkv.init_rwkv6_state(jc, 2, 1).items()}
    japply = jax.jit(lambda p, x, st: jrwkv.rwkv6_apply(jc, p, x, state=st))
    jstep = jax.jit(functools.partial(jrwkv.rwkv6_step, jc))
    yj, sj = japply(p, jnp.asarray(x[:, :35]), jax.tree.map(jnp.asarray, st0))
    y, st = trwkv.rwkv6_apply(tc, m, torch.from_numpy(x[:, :35]),
                              state={k: torch.from_numpy(v) for k, v in st0.items()})
    assert _rel(y, yj) < TOL
    for t in (35, 36):
        yj, sj = jstep(p, jnp.asarray(x[:, t:t + 1]), sj)
        y, st = trwkv.rwkv6_step(tc, m, torch.from_numpy(x[:, t:t + 1]), st)
        assert _rel(y, yj) < TOL
    assert sorted(st) == sorted(sj)
    for k in st:
        assert st[k].shape == sj[k].shape and _rel(st[k], sj[k]) < TOL, k


# ---------------------------------------------------------------------------
# rwkv6-3b through the serving entry points on identical weights
# ---------------------------------------------------------------------------

PROMPT, MAX_LEN = 40, 48  # 40 tokens: more than one wkv chunk of 32, not a multiple


@functools.lru_cache(maxsize=None)
def _reference():
    """The JAX package's numbers (computed once per process)."""
    cfg = jcfg.get_reduced(ARCH)
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
    cfg = tcfg.get_reduced(ARCH, use_flash=use_flash)
    ref = _reference()
    return cfg, params_from_jax(cfg, ref["params"], device="cpu"), ref


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
    assert (seg.body, seg.reps) == ("R", cfg.n_layers)
    for r in range(seg.reps):
        blk = state.segs[0][r]["0R"]
        want = jax.tree.map(lambda a: a[r], ref["segs"][0]["0R"])
        assert set(blk) == set(want) == {"shift_tm", "shift_cm", "wkv"}
        for name, got in blk.items():
            assert got.shape == want[name].shape
            assert got.dtype == getattr(torch, str(want[name].dtype))
            assert _rel(got, want[name]) < TOL, (r, name)
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


def test_kernel_route_is_taken_by_prefill_only(monkeypatch):
    """With ``use_flash`` prefill calls the wkv wrapper once per ``R``
    layer, with the decode state's wkv as its initial state; decode never
    calls it; ``use_flash=False`` never does."""
    calls = []
    real = trwkv.wkv6

    def spy(r, k, v, w, u, init_state=None):
        calls.append(None if init_state is None else tuple(init_state.shape))
        return real(r, k, v, w, u, init_state)

    monkeypatch.setattr(trwkv, "wkv6", spy)
    cfg, params, ref = _port(True)
    _, state = prefill(cfg, params, {"tokens": torch.from_numpy(ref["tokens"])},
                       max_len=MAX_LEN)
    N = cfg.rwkv_head_size
    assert calls == [(2, cfg.d_model // N, N, N)] * cfg.n_layers
    calls.clear()
    decode_step(cfg, params, torch.from_numpy(ref["feed"][0]), state)
    assert calls == []
    forward(cfg, params, {"tokens": torch.from_numpy(ref["tokens"])})
    assert calls == [None] * cfg.n_layers  # no state: the kernel starts from zeros
    calls.clear()
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
    cfg = tcfg.get_reduced(ARCH)
    model = tmodel.init_params(cfg, seed=0, device="cpu")
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg.get_reduced(ARCH),
                                                   jax.random.PRNGKey(0)))
    blk = model.segs[0][2]["0R"]
    for name, w in blk.named_parameters():
        want = tree["segs"][0]["0R"][name][2]
        assert w.shape == want.shape and w.dtype == getattr(torch, str(want.dtype)), name
        if name in trwkv.CONST_INIT:  # constants: equal to the JAX leaf
            assert np.array_equal(w.numpy(), want), name
        else:  # truncated normal: within 2 standard deviations, not constant
            scale = trwkv.SCALED_INIT.get(
                name, 1.0 / np.sqrt(w.shape[0] if w.ndim > 1 else w.shape[-1]))
            assert float(w.abs().max()) <= 2 * scale + 1e-6 and float(w.std()) > 0, name
            assert float(np.abs(want).max()) <= 2 * scale + 1e-6, name
    assert blk.w0.dtype == blk.u.dtype == torch.float32
    names = {n for n, _ in model.named_parameters()}
    assert {"unembed", "segs.0.3.0R.lora_A", "segs.0.3.0R.Wcv"} <= names
    assert not any("shared_attn" in n for n in names)


def test_params_from_jax_carries_f32_leaves_bit_exact_in_bf16():
    kw = dict(dtype="bfloat16", param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg.get_reduced(ARCH, **kw),
                                                   jax.random.PRNGKey(2)))
    model = params_from_jax(tcfg.get_reduced(ARCH, **kw), tree, device="cpu")
    blk = model.segs[0][1]["0R"]
    want = tree["segs"][0]["0R"]
    assert blk.Wr.dtype == torch.bfloat16 and blk.u.dtype == torch.float32
    assert np.array_equal(blk.lora_B.view(torch.int16).numpy(),
                          want["lora_B"][1].view(np.int16))
    assert np.array_equal(blk.u.numpy(), want["u"][1])
    assert np.array_equal(blk.w0.numpy(), want["w0"][1])
