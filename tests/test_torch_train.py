"""The port's train step and driver against the JAX package's, on the CPU.

``launch/steps.py::make_train_step``'s loss and gradients equal the
reference's (``jax.value_and_grad(loss_fn)``, averaged in f32 over
microbatches as ``repro.launch.steps.make_train_step`` averages them) on
the JAX package's weights carried across by ``models/convert.py`` and a
seeded batch with masked labels (batch seeds 0 and 5): the loss within
1e-5 relative, each gradient leaf within 1e-4 of its largest value or,
failing that, as accurate as the reference's own f32 gradients (see
``ACCURACY_FACTOR``), in f32, for the reduced
h2o-danube-3-4b, zamba2-2.7b (``MMMMMH``), rwkv6-3b, deepseek-v2-lite-16b
(MoE, MLA) and whisper-small (encoder-decoder), at 1 and 2 microbatches.
Gradients are read where both optimizers hand them to their
``grad_transform``.  Then: a tiny model learns; the driver trains,
checkpoints and resumes exactly; the entry points need a GPU unless the
CPU is asked for; the kernels refuse inputs that require grad; the new
modules import neither JAX nor the JAX package.
"""
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
from repro_torch.checkpoint.store import Stacked, _leaf_paths, model_tree
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import forward, init_params, loss_fn
from repro_torch.optim import AdamW

ROOT = Path(__file__).resolve().parents[1]
LOSS_REL, GRAD_REL = 1e-5, 1e-4
# f32 gradients carry rounding of their own.  rwkv6-3b's reduced
# gradients from the reference jitted differ from the same reference run
# op by op by up to 7.1e-5 of a leaf's largest value, and from the
# reference on f64 weights and activations (its wkv recurrence stays in
# f32) by 4.7e-5 to 4.5e-4 (batch seeds 0-5, 1 and 2 microbatches); the
# port's differ from the reference's by up to 3.2e-4.  So a leaf that
# misses GRAD_REL is held instead to the reference's own f32 accuracy:
# its distance from the f64 reference at most ACCURACY_FACTOR times the
# reference's farthest leaf's, each relative to the leaf's largest
# value.  Over those 12 cases the port's farthest leaf sat 0.40 to 2.55
# times as far as the reference's: the same f32 rounding, summed in
# another order (torch's einsum paths are not JAX's).  ``python
# tests/test_torch_train.py`` prints those numbers.
ACCURACY_FACTOR = 3.0
BATCH_SEEDS = (0, 5)  # both batch seeds the parity test has used


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


FAMILIES = {
    "h2o-danube-3-4b": {},
    "zamba2-2.7b": dict(n_layers=6, layer_pattern="MMMMMH"),
    "rwkv6-3b": {},
    "deepseek-v2-lite-16b": {},
    "whisper-small": {},
}


def _batch(cfg, rng, B=2, S=16):
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[:, :3] = -1  # masked positions
    batch = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.enc_dec:
        batch["enc_frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
            np.float32)
    return batch


def _flat_port(grads: dict) -> dict:
    """The port's gradients (by parameter name) under the JAX package's
    leaf names, a segment's reps stacked."""
    return {k: (torch.stack(v.parts) if isinstance(v, Stacked) else v).numpy()
            for k, v in _leaf_paths(model_tree(grads))}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The JAX package's reduced config, weights and jitted
    ``value_and_grad(loss_fn)`` (one compile per arch: every microbatch
    below has 2 rows)."""
    jax = pytest.importorskip("jax")
    import repro.configs as jcfg
    import repro.models as jm

    jc = jcfg.get_reduced(arch, **FAMILIES[arch])
    jp = jax.jit(lambda k: jm.init_params(jc, k))(jax.random.PRNGKey(0))
    vg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(jc, p, b), has_aux=True))
    return jc, jp, vg


def _mean_grads(jax, vg, jp, batch, mb, with_loss=False, dtype=np.float32):
    """The reference's gradients by leaf name (and loss): ``vg`` on each
    2-row microbatch, summed in ``dtype``, divided by ``mb``."""
    loss, grads = dtype(0.0), None
    for i in range(mb):
        (l, _), g = vg(jp, {k: v[2 * i:2 * i + 2] for k, v in batch.items()})
        g = jax.tree.map(lambda a: np.asarray(a, dtype), g)
        loss = loss + dtype(l)
        grads = g if grads is None else jax.tree.map(np.add, grads, g)
    out = {jax.tree_util.keystr(k): v / dtype(mb)
           for k, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return (out, loss / dtype(mb)) if with_loss else out


def _mean_grads_f64(jax, arch, jp, batch, mb):
    """``_mean_grads`` of the reference with f64 weights (``jp`` upcast),
    activations and sums: the yardstick of an f32 gradient's rounding."""
    import repro.configs as jcfg
    import repro.models as jm

    with jax.enable_x64(True):
        jc = jcfg.get_reduced(arch, **FAMILIES[arch], dtype="float64", param_dtype="float64")
        vg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(jc, p, b), has_aux=True))
        jp64 = jax.tree.map(lambda a: jax.numpy.asarray(np.asarray(a, np.float64)), jp)
        b64 = {k: v.astype(np.float64) if v.dtype.kind == "f" else v for k, v in batch.items()}
        return _mean_grads(jax, vg, jp64, b64, mb, dtype=np.float64)


def _port_grads(tc, jax, jp, batch):
    """The port's gradients by leaf name and its loss: one train step on
    the JAX package's weights ``jp``, the gradients read where AdamW
    hands them to its ``grad_transform``."""
    from repro_torch.models.convert import params_from_jax

    model = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    seen = {}
    opt = AdamW(lr=1e-3, grad_transform=lambda g: seen.setdefault("grads", g))
    step = tsteps.make_train_step(tc, opt)
    _, _, tm = step(model, opt.init(model), {k: torch.from_numpy(v) for k, v in batch.items()})
    return _flat_port(seen["grads"]), float(tm["loss"])


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_step_loss_and_grads_match_the_reference(arch, mb):
    """The reference: ``jax.value_and_grad(loss_fn)`` on each microbatch,
    summed in f32 and divided by ``mb``, as ``repro.launch.steps.
    make_train_step`` accumulates them."""
    jax = pytest.importorskip("jax")
    jc, jp, vg = _reference(arch)
    tc = tcfg.get_reduced(arch, **FAMILIES[arch], microbatches=mb)
    for seed in BATCH_SEEDS:
        batch = _batch(jc, np.random.default_rng(seed), B=2 * mb)
        want, loss = _mean_grads(jax, vg, jp, batch, mb, with_loss=True)

        got, port_loss = _port_grads(tc, jax, jp, batch)
        assert port_loss == pytest.approx(float(loss), rel=LOSS_REL), seed
        assert got.keys() == want.keys()
        scale = {k: max(float(np.abs(want[k]).max()), 1e-30) for k in want}
        far = [k for k in want
               if float(np.abs(got[k].astype(np.float64) - want[k]).max()) > GRAD_REL * scale[k]]
        if far:
            exact = _mean_grads_f64(jax, arch, jp, batch, mb)
            ref_err = max(float(np.abs(want[k] - exact[k]).max()) / scale[k] for k in want)
            for k in far:
                err = float(np.abs(got[k] - exact[k]).max()) / scale[k]
                assert err <= ACCURACY_FACTOR * ref_err, (seed, k, err, ref_err)


def test_loss_fn_matches_the_reference_with_masked_labels():
    jax = pytest.importorskip("jax")
    import repro.configs as jcfg
    import repro.models as jm

    from repro_torch.models.convert import params_from_jax

    jc, tc = jcfg.get_reduced("granite-3-8b"), tcfg.get_reduced("granite-3-8b")
    jp = jax.jit(lambda k: jm.init_params(jc, k))(jax.random.PRNGKey(1))
    batch = _batch(jc, np.random.default_rng(2))
    batch["labels"][1] = -1  # a whole row masked
    (jl, jmet) = jax.jit(lambda p, b: jm.loss_fn(jc, p, b))(jp, batch)
    model = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    tl, tmet = loss_fn(tc.replace(use_flash=False), model,
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_REL)
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == 13.0


def test_loss_decreases_on_tiny_train():
    """Few AdamW steps on a reduced dense config actually learn."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline

    cfg = tcfg.get_reduced("granite-3-8b", n_layers=2, vocab_size=128, d_model=64,
                           d_ff=128, n_heads=2, n_kv_heads=2, head_dim=32)
    params = init_params(cfg, 0, device="cpu")
    opt = AdamW(lr=3e-3, moment_dtype="float32")
    opt_state = opt.init(params)
    step = tsteps.make_train_step(cfg, opt)
    pipe = TokenPipeline(DataConfig(vocab_size=128, seq_len=32, global_batch=8, ngram=4))
    losses = []
    for i in range(30):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::6]


def test_train_step_leaves_serving_as_it_was():
    """Gradients are on only inside the step; forward stays no-grad; the
    kernels' twins run even if the config asks for the kernels."""
    cfg = tcfg.get_reduced("h2o-danube-3-4b")
    assert cfg.use_flash and cfg.remat is False
    params = init_params(cfg, 0, device="cpu")
    step = tsteps.make_train_step(cfg.replace(remat=True), AdamW(lr=1e-3))
    batch = _batch(cfg, np.random.default_rng(0))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params, st, m = step(params, AdamW(lr=1e-3).init(params), batch)
    assert int(st.step) == 1 and np.isfinite(float(m["loss"]))
    assert not any(p.requires_grad for p in params.parameters())
    logits, _ = forward(cfg, params, batch)
    assert not logits.requires_grad


def test_remat_gives_the_same_gradients():
    cfg = tcfg.get_reduced("h2o-danube-3-4b", use_flash=False)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, np.random.default_rng(3)).items()}
    grads = []
    for remat in (False, True):
        model = init_params(cfg, 4, device="cpu")
        named = dict(model.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
        loss, _ = loss_fn(cfg.replace(remat=remat), model, batch)
        grads.append(torch.autograd.grad(loss, list(named.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["flash", "ssd", "wkv"])
def test_kernels_refuse_inputs_that_require_grad(kernel):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_scan import ssd_scan
    from repro_torch.kernels.rwkv6_wkv import wkv6

    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    if kernel == "flash":
        fn, args = (lambda *a: flash_attention(*a, causal=True)), [r(1, 8, 2, 16) for _ in range(3)]
    elif kernel == "ssd":
        fn = ssd_scan
        args = [r(1, 8, 2, 4), torch.rand(1, 8, 2, generator=g) + 0.1, -torch.rand(2, generator=g),
                r(1, 8, 4), r(1, 8, 4)]
    else:
        fn = wkv6
        args = [r(1, 8, 2, 4), r(1, 8, 2, 4), r(1, 8, 2, 4),
                torch.rand(1, 8, 2, 4, generator=g) * 0.5 + 0.4, r(2, 4)]
    want = fn(*args)  # no input requires grad: the plain version on the CPU
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad.*use_flash=False"):
        fn(*args)
    with torch.no_grad():  # without autograd the kernel's route is open
        got = fn(*args)
    for a, b in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert torch.equal(a, b)


def test_loss_fn_with_kernels_under_autograd_raises():
    cfg = tcfg.get_reduced("h2o-danube-3-4b")  # use_flash: the flash route
    model = init_params(cfg, 0, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, np.random.default_rng(1)).items()}
    with pytest.raises(RuntimeError, match="flash_attention: an input requires grad"):
        loss_fn(cfg, model, batch)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def _run(tmp_path, steps, resume=False, ckpt=True):
    argv = ["--arch", "h2o-danube-3-4b", "--reduced", "--steps", str(steps), "--seq-len", "32",
            "--global-batch", "4", "--ckpt-every", "2", "--device", "cpu"]
    if ckpt:
        argv += ["--ckpt-dir", str(tmp_path / "ckpt")]
    if resume:
        argv.append("--resume")
    return ttrain.main(argv)


def test_driver_trains_checkpoints_and_resumes_exactly(tmp_path, capsys):
    from repro_torch.checkpoint import CheckpointManager

    import shutil

    straight = ttrain.train("h2o-danube-3-4b", steps=6, seq_len=32, global_batch=4,
                            device="cpu")
    _run(tmp_path, 6)
    mgr = CheckpointManager(tmp_path / "ckpt")
    assert sorted(mgr._steps()) == [2, 4, 6]  # keep 3
    out = capsys.readouterr().out
    assert "step     5 loss" in out and "[train] done" in out
    shutil.rmtree(tmp_path / "ckpt" / "step_000000000006")  # as if the run died after 4
    _run(tmp_path, 6, resume=True)
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    resumed = [float(line.split("loss ")[1].split()[0]) for line in out.splitlines()
               if line.strip().startswith("step")]
    assert resumed[-1] == pytest.approx(straight[-1], abs=5e-5)
    assert CheckpointManager(tmp_path / "ckpt").latest_step() == 6


def test_driver_checkpoint_restores_in_the_reference(tmp_path):
    """The driver's checkpoint is the JAX package's (params, opt_state)."""
    jax = pytest.importorskip("jax")
    import repro.configs as jcfg
    import repro.models as jm
    from repro.checkpoint import CheckpointManager as JManager
    from repro.optim import AdamW as JAdamW

    _run(tmp_path, 2)
    jc = jcfg.get_reduced("h2o-danube-3-4b")
    jp = jax.eval_shape(lambda: jm.init_params(jc, jax.random.PRNGKey(0)))
    like = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), (jp, JAdamW().init(jp)))
    (params, state), step = JManager(tmp_path / "ckpt").restore(like)
    assert step == 2 and int(state.step) == 2
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(params))


def test_entry_points_without_device_need_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train("h2o-danube-3-4b", steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "h2o-danube-3-4b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.batch_to_device(tcfg.get_reduced("h2o-danube-3-4b"),
                               {"tokens": np.zeros((1, 2), np.int32)}, None)


def test_training_modules_import_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch.launch.train, repro_torch.optim, repro_torch.data\n"
        "import repro_torch.checkpoint, repro_torch.resilience\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_module_exports_match_the_reference():
    pytest.importorskip("jax")
    import importlib

    for name in ("optim", "data", "checkpoint", "resilience"):
        want = importlib.import_module(f"repro.{name}").__all__
        assert importlib.import_module(f"repro_torch.{name}").__all__ == want, name


def accuracy_sweep(arch="rwkv6-3b", seeds=range(6), mbs=(1, 2)) -> None:
    """Print, per batch seed and microbatch count, the farthest leaf's
    distance (relative to its largest value) of the port's gradients
    from the reference's, and of both from the reference on f64 weights
    and activations: the numbers behind ``ACCURACY_FACTOR``."""
    import jax

    torch.set_num_threads(2)
    jc, jp, vg = _reference(arch)
    for mb in mbs:
        tc = tcfg.get_reduced(arch, **FAMILIES[arch], microbatches=mb)
        for seed in seeds:
            batch = _batch(jc, np.random.default_rng(seed), B=2 * mb)
            want = _mean_grads(jax, vg, jp, batch, mb)
            got, _ = _port_grads(tc, jax, jp, batch)
            exact = _mean_grads_f64(jax, arch, jp, batch, mb)
            scale = {k: max(float(np.abs(want[k]).max()), 1e-30) for k in want}

            def far(a, b):
                return max(float(np.abs(a[k] - b[k]).max()) / scale[k] for k in want)

            port, ref = far(got, exact), far(want, exact)
            print(f"{arch} mb {mb} seed {seed}: port vs reference {far(got, want):.3g}; "
                  f"vs the f64 reference: port {port:.3g}, reference {ref:.3g}, "
                  f"ratio {port / ref:.2f}", flush=True)


if __name__ == "__main__":
    accuracy_sweep()
