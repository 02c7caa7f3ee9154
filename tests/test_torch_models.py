"""The port's LM serving path against the JAX package's, on the CPU.

Configs field by field; then the reduced h2o-danube-3-4b (window 16, GQA
4 heads over 2) and granite-3-8b (tied embeddings, no window), with the
JAX package's weights carried over by ``params_from_jax`` and seeded
numpy tokens: ``forward`` logits, ``prefill`` last logits and caches
(ring and non-ring), and teacher-forced decode steps, with
``use_flash`` True (the flash wrapper's plain version on the CPU) and
False (the torch ``chunked_attention``); then the reduced grok-1,
deepseek-v2-lite, whisper-small and internvl2-2b the same way, with
whisper's seeded frames and internvl2's seeded image prefix, and the
summed MoE aux loss.  Everything is f32; the
tolerance, 1e-4 on logits of magnitude ~1, allows for the two
frameworks summing products in different orders over four layers.
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
import repro_torch.configs as tcfg
from repro_torch.launch import steps as tsteps
from repro_torch.models import decode_step, forward, model as tmodel, prefill
from repro_torch.models.convert import params_from_jax, tensor_from_numpy

TOL = 1e-4
N_DECODE = 4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores; torch's
    default of one thread per core in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jcfg.all_arch_ids())
def test_configs_match_repro_field_by_field(arch):
    assert tcfg.all_arch_ids() == jcfg.all_arch_ids()
    for want, got in ((jcfg.get_config(arch), tcfg.get_config(arch)),
                      (jcfg.get_reduced(arch), tcfg.get_reduced(arch))):
        w, g = dataclasses.asdict(want), dataclasses.asdict(got)
        assert g.keys() == w.keys()
        # the one listed difference: the port routes prefill to its kernel
        assert w.pop("use_flash") is False and g.pop("use_flash") is True
        assert g == w
        assert (got.hd, got.pattern, got.param_count()) == (
            want.hd, want.pattern, want.param_count())
        assert got.tdtype == getattr(torch, str(want.jdtype))
        assert got.tparam_dtype == getattr(torch, str(want.jparam_dtype))
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    assert tmodel.plan_segments(tcfg.get_config(arch)) == tuple(
        tmodel.Segment(**dataclasses.asdict(s))
        for s in jm.model.plan_segments(jcfg.get_config(arch)))


def test_cell_config_and_skip_reason_match_repro():
    from repro.launch import steps as jsteps

    for arch in jcfg.all_arch_ids():
        for shape in jcfg.SHAPES:
            assert tsteps.skip_reason(arch, shape) == jsteps.skip_reason(arch, shape)
            w = dataclasses.asdict(jsteps.cell_config(arch, shape))
            g = dataclasses.asdict(tsteps.cell_config(arch, shape))
            w.pop("use_flash"), g.pop("use_flash")
            assert g == w


# MoE (grok-1; deepseek-v2-lite, with MLA), the encoder-decoder (whisper)
# and the VLM image prefix (internvl2)
FAMILIES = ["grok-1-314b", "deepseek-v2-lite-16b", "whisper-small", "internvl2-2b"]
FAMILY_PROMPT = 12


def _family_batch(cfg, rng):
    """Seeded tokens, and whisper's frames or internvl2's image prefix."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, FAMILY_PROMPT), dtype=np.int32)}
    if cfg.enc_dec:
        batch["enc_frames"] = rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_img_tokens:
        batch["img_emb"] = rng.standard_normal(
            (2, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _family_reference(arch):
    """The JAX package's forward, prefill and teacher-forced decode steps
    on one of the four families (reduced), computed once per process."""
    cfg = jcfg.get_reduced(arch)
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    batch = _family_batch(cfg, rng)
    feed = rng.integers(0, cfg.vocab_size, (N_DECODE, 2), dtype=np.int32)
    max_len = cfg.n_img_tokens + FAMILY_PROMPT + N_DECODE
    logits, aux = jax.jit(functools.partial(jm.forward, cfg))(params, batch)
    pre = jax.jit(functools.partial(jm.prefill, cfg), static_argnames="max_len")
    last, state = pre(params, batch, max_len=max_len)
    step = jax.jit(functools.partial(jm.decode_step, cfg))
    steps = []
    for t in range(N_DECODE):
        lg, state = step(params, jnp.asarray(feed[t]), state)
        steps.append(np.asarray(lg))
    return dict(params=jax.tree.map(np.asarray, params), batch=batch, feed=feed,
                max_len=max_len, logits=np.asarray(logits), aux=float(aux),
                last=np.asarray(last), steps=steps, pos=np.asarray(state["pos"]))


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("arch", FAMILIES)
def test_four_families_match_repro(arch, use_flash):
    """init_params and params_from_jax build them, and forward (logits and
    the summed MoE aux loss), prefill and 4 decode steps match the
    reference within TOL on identical weights."""
    ref = _family_reference(arch)
    cfg = tcfg.get_reduced(arch, use_flash=use_flash)
    assert tmodel.init_params(cfg, seed=1, device="cpu").embed.shape == (
        cfg.vocab_size, cfg.d_model)
    params = params_from_jax(cfg, ref["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    logits, aux = forward(cfg, params, batch)
    assert logits.shape == ref["logits"].shape and _err(logits, ref["logits"]) < TOL
    assert float(aux) == pytest.approx(ref["aux"], rel=1e-5, abs=1e-7)
    assert (float(aux) > 0) == ("E" in cfg.pattern)
    last, state = tsteps.make_prefill_step(cfg, tcfg.ShapeSpec(
        "prefill_tiny", ref["max_len"], 2, "prefill"))(params, batch)
    assert _err(last, ref["last"]) < TOL
    assert (state.enc_out is not None) == cfg.enc_dec
    for t in range(N_DECODE):
        lg, state = decode_step(cfg, params, torch.from_numpy(ref["feed"][t]), state)
        assert _err(lg, ref["steps"][t]) < TOL, t
    assert state.pos.tolist() == ref["pos"].tolist() == [
        cfg.n_img_tokens + FAMILY_PROMPT + N_DECODE] * 2


def test_unknown_block_letters_raise():
    with pytest.raises(ValueError, match="unknown block letters"):
        tmodel.init_params(tcfg.get_reduced("grok-1-314b", layer_pattern="X"), device="cpu")


def test_whisper_flash_route_is_non_causal_in_prefill_only(monkeypatch):
    """Under use_flash whisper's prefill sends every encoder layer, every
    decoder self-attention and every cross-attention to the flash
    wrapper: the encoder's and the cross-attention's non-causal, the
    cross-attention's keys the encoder's frames; decode steps never do."""
    from repro_torch.models import attention as tattn

    calls = []
    real = tmodel.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tmodel, "flash_attention", spy)
    monkeypatch.setattr(tattn, "flash_attention", spy)
    ref = _family_reference("whisper-small")
    cfg = tcfg.get_reduced("whisper-small")
    params = params_from_jax(cfg, ref["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    _, state = prefill(cfg, params, batch, max_len=ref["max_len"])
    S, Se = FAMILY_PROMPT, cfg.enc_seq
    assert sorted(calls) == sorted([(Se, Se, False)] * cfg.n_enc_layers
                                   + [(S, S, True)] * cfg.n_layers
                                   + [(S, Se, False)] * cfg.n_layers)
    calls.clear()
    decode_step(cfg, params, torch.from_numpy(ref["feed"][0]), state)
    assert calls == []


# ---------------------------------------------------------------------------
# the serving path on identical weights
# ---------------------------------------------------------------------------

# name: (arch, config overrides, prompt length, max_len)
CASES = {
    "danube_ring": ("h2o-danube-3-4b", dict(n_kv_heads=2), 24, 32),  # 24 > window 16
    "danube_nonring": ("h2o-danube-3-4b", dict(n_kv_heads=2), 10, 14),  # L 14 < 16
    "granite_tied": ("granite-3-8b", {}, 12, 20),
}


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The JAX package's numbers for one case (computed once per process)."""
    arch, kw, S, max_len = CASES[case]
    cfg = jcfg.get_reduced(arch, **kw)
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, S), dtype=np.int32)
    feed = rng.integers(0, cfg.vocab_size, (N_DECODE, 2), dtype=np.int32)
    logits, _ = jax.jit(functools.partial(jm.forward, cfg))(params, {"tokens": tokens})
    pre = jax.jit(functools.partial(jm.prefill, cfg), static_argnames="max_len")
    last, state = pre(params, {"tokens": tokens}, max_len=max_len)
    caches = jax.tree.map(np.asarray, state["segs"])
    step = jax.jit(functools.partial(jm.decode_step, cfg))
    steps = []
    for t in range(N_DECODE):
        lg, state = step(params, jnp.asarray(feed[t]), state)
        steps.append(np.asarray(lg))
    return dict(params=jax.tree.map(np.asarray, params), tokens=tokens, feed=feed,
                logits=np.asarray(logits), last=np.asarray(last), caches=caches,
                steps=steps, pos=np.asarray(state["pos"]))


def _port(case, use_flash):
    arch, kw, _, _ = CASES[case]
    cfg = tcfg.get_reduced(arch, use_flash=use_flash, **kw)
    ref = _reference(case)
    return cfg, params_from_jax(cfg, ref["params"], device="cpu"), ref


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("case", ["danube_ring", "granite_tied"])
def test_forward_matches_repro(case, use_flash):
    cfg, params, ref = _port(case, use_flash)
    logits, aux = forward(cfg, params, {"tokens": torch.from_numpy(ref["tokens"])})
    assert logits.shape == ref["logits"].shape and float(aux) == 0.0
    assert _err(logits, ref["logits"]) < TOL


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_repro(case, use_flash):
    cfg, params, ref = _port(case, use_flash)
    _, _, S, max_len = CASES[case]
    last, state = prefill(cfg, params, {"tokens": torch.from_numpy(ref["tokens"])},
                          max_len=max_len)
    assert _err(last, ref["last"]) < TOL
    ring = case == "danube_ring"
    for si, seg in enumerate(tmodel.plan_segments(cfg)):
        for r in range(seg.reps):
            for key, blk in state.segs[si][r].items():
                for kv in ("k", "v"):
                    got = blk["att"][kv]
                    want = ref["caches"][si][key]["att"][kv]
                    want = want[r] if seg.reps > 1 else want
                    assert got.shape == want.shape
                    assert (got.shape[1] == cfg.swa_window) == ring
                    assert _err(got, want) < TOL
    for t in range(N_DECODE):
        lg, state = decode_step(cfg, params, torch.from_numpy(ref["feed"][t]), state)
        assert _err(lg, ref["steps"][t]) < TOL, t
    assert state.pos.tolist() == ref["pos"].tolist() == [S + N_DECODE] * 2


def test_flash_route_is_taken_by_prefill_only(monkeypatch):
    """With ``use_flash`` every layer's prefill attention goes through the
    flash wrapper, once; decode steps never do."""
    calls = []
    real = tmodel.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw.get("sk_valid")))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tmodel, "flash_attention", spy)
    for case in ("danube_ring", "danube_nonring"):
        cfg, params, ref = _port(case, True)
        _, _, S, max_len = CASES[case]
        calls.clear()
        _, state = prefill(cfg, params, {"tokens": torch.from_numpy(ref["tokens"])},
                           max_len=max_len)
        assert len(calls) == cfg.n_layers
        # ring or not, prefill attends the prompt's own K/V, all valid
        assert {(c[1][1], c[2]) for c in calls} == {(S, None)}
        calls.clear()
        decode_step(cfg, params, torch.from_numpy(ref["feed"][0]), state)
        assert calls == []
    cfg, params, ref = _port("danube_ring", False)
    prefill(cfg, params, {"tokens": torch.from_numpy(ref["tokens"])}, max_len=32)
    assert calls == []


def test_serve_steps_follow_greedy_decode():
    cfg, params, ref = _port("danube_ring", True)
    shape = tcfg.ShapeSpec("prefill_tiny", seq_len=32, global_batch=2, kind="prefill")
    last, state = tsteps.make_prefill_step(cfg, shape)(
        params, {"tokens": torch.from_numpy(ref["tokens"])})
    assert _err(last, ref["last"]) < TOL
    serve = tsteps.make_serve_step(cfg)
    toks = last.argmax(-1).to(torch.int32)
    for _ in range(3):
        nxt, state = serve(params, state, toks)
        assert nxt.dtype == torch.int32 and nxt.shape == (2,)
        toks = nxt
    assert state.pos.tolist() == [27, 27]


def test_params_from_jax_is_bit_exact_in_bf16():
    kw = dict(dtype="bfloat16", param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jm.init_params(
        jcfg.get_reduced("h2o-danube-3-4b", **kw), jax.random.PRNGKey(1)))
    assert tree["embed"].dtype.name == "bfloat16"
    cfg = tcfg.get_reduced("h2o-danube-3-4b", **kw)
    model = params_from_jax(cfg, tree, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert np.array_equal(model.embed.view(torch.int16).numpy(),
                          tree["embed"].view(np.int16))
    wq = model.segs[0][3]["0A"].attn.wq
    assert np.array_equal(wq.view(torch.int16).numpy(),
                          tree["segs"][0]["0A"]["attn"]["wq"][3].view(np.int16))
    assert torch.equal(tensor_from_numpy(tree["final_norm"]), model.final_norm)
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(cfg, dict(tree, embed=tree["embed"][:, :5]), device="cpu")


def test_init_params_is_seeded():
    cfg = tcfg.get_reduced("h2o-danube-3-4b")
    a = tmodel.init_params(cfg, seed=3, device="cpu")
    b = tmodel.init_params(cfg, seed=3, device="cpu")
    c = tmodel.init_params(cfg, seed=4, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.embed, c.embed)
    assert float(a.embed.abs().max()) <= 0.04 + 1e-6  # 2 std of 0.02
    assert torch.equal(a.segs[0][0]["0A"].ln1, torch.ones(cfg.d_model))
    names = {n for n, _ in a.named_parameters()}
    assert {"embed", "final_norm", "unembed", "segs.0.2.0A.attn.wq",
            "segs.0.2.0A.mlp.w_gate", "segs.0.2.0A.ln2"} <= names
