"""The training slice on a CUDA device: the kernels refuse inputs that
require grad, the train step on the card agrees with the same step on
the CPU (f32, TF32 off: within 1e-4 of each gradient leaf's largest
value and 1e-5 on the loss, sums taken in other orders), launches no
kernel, and checkpoints of tensors on the card restore bit for bit.
Marked ``gpu``; each test skips where no CUDA device is visible.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_train.py
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import batch_to_device, train_state_tree
from repro_torch.models import init_params
from repro_torch.optim import AdamW

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(cfg, seed=0, B=2, S=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("kernel", ["flash", "ssd", "wkv"])
def test_kernels_refuse_grad_on_the_card(cuda, kernel):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv

    g = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *s, dt=torch.bfloat16: torch.randn(*s, device=cuda, generator=g).to(dt)
    if kernel == "flash":
        mod, fn, args = fa, (lambda *a: fa.flash_attention(*a, causal=True)), [
            r(1, 128, 2, 64) for _ in range(3)]
    elif kernel == "ssd":
        mod, fn = ssd, ssd.ssd_scan
        args = [r(1, 64, 2, 32), torch.rand(1, 64, 2, device=cuda, generator=g) + 0.1,
                -torch.rand(2, device=cuda, generator=g), r(1, 64, 16), r(1, 64, 16)]
    else:
        mod, fn = wkv, wkv.wkv6
        args = [r(1, 64, 2, 32), r(1, 64, 2, 32), r(1, 64, 2, 32),
                torch.rand(1, 64, 2, 32, device=cuda, generator=g) * 0.5 + 0.4,
                r(2, 32, dt=torch.float32)]
    args[0].requires_grad_(True)
    mod.reset_launches()
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*args)
    assert sum(mod.launches.values()) == 0
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    assert sum(mod.launches.values()) > 0


def test_train_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.kernels import flash_attention as fa

    cfg = get_reduced("h2o-danube-3-4b")
    out = {}
    for dev in ("cpu", cuda):
        model = init_params(cfg, 0, device="cpu").to(dev)
        seen = {}
        opt = AdamW(lr=1e-3, grad_transform=lambda gr, seen=seen: seen.setdefault("g", gr))
        fa.reset_launches()
        _, _, m = make_train_step(cfg, opt)(model, opt.init(model),
                                            batch_to_device(cfg, _batch(cfg), dev))
        assert fa.launches["flash_attention"] == 0
        out[str(dev)] = (float(m["loss"]), {k: v.cpu() for k, v in seen["g"].items()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    assert l_gpu == pytest.approx(l_cpu, rel=1e-5)
    for k in g_cpu:
        tol = 1e-4 * float(g_cpu[k].abs().max())
        assert float((g_gpu[k] - g_cpu[k]).abs().max()) <= tol, k


def test_a_few_steps_learn_on_the_card(cuda):
    cfg = get_reduced("h2o-danube-3-4b", param_dtype="bfloat16", dtype="bfloat16",
                      remat=True)
    model = init_params(cfg, 0, device=cuda)
    opt = AdamW(lr=3e-3)
    st = opt.init(model)
    step = make_train_step(cfg, opt)
    batch = batch_to_device(cfg, _batch(cfg, 1), cuda)
    losses = []
    for _ in range(8):
        model, st, m = step(model, st, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_checkpoint_of_card_tensors_restores_bit_for_bit(cuda, tmp_path):
    cfg = get_reduced("zamba2-2.7b", n_layers=6, layer_pattern="MMMMMH",
                      param_dtype="bfloat16")
    model = init_params(cfg, 0, device=cuda)
    opt = AdamW()
    st = opt.init(model)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, train_state_tree(model, st))
    with torch.no_grad():
        for p in model.parameters():  # the next step, in place, at once
            p.add_(1)
    mgr.wait()
    fresh = init_params(cfg, 3, device=cuda)
    fresh_st = opt.init(fresh)
    mgr.restore(train_state_tree(fresh, fresh_st))
    for (n, p), q in zip(init_params(cfg, 0, device=cuda).named_parameters(),
                         fresh.parameters()):
        assert q.device.type == "cuda" and torch.equal(p, q), n
