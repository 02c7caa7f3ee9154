"""The per-layer, teacher-forced bf16 check of ``chip_smoke.py`` has
teeth: on the CPU, at narrow widths and a few layers, the same measure
passes the kernels' plain versions and fails each of three slips a
kernel could make.

``chip_smoke.layer_update_errors`` feeds every block the bf16 twin's
activation x_i and compares the block's update y - x_i, with the kernels
(``use_flash``) and with the bf16 twin, against the block in f32
(``bf16_rel_err``, row-normalised); ``layers_within_bound`` holds the
kernels to ``max(LAYER_FLOOR, 1.5 x the twin's error)`` on every block.
On the CPU the kernel route is the wrappers' plain versions, so a slip is
injected by patching the wrapper each model calls.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.configs import get_reduced
from repro_torch.kernels.mamba2_scan import ssd_scan_plain
from repro_torch.kernels.rwkv6_wkv import wkv6_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import init_params
from repro_torch.models import mamba2 as m_mamba2
from repro_torch.models import model as m_model
from repro_torch.models import rwkv6 as m_rwkv6

BATCH, SEQ = 2, 128  # two SSD chunks of 64 and eight windows of 16
# narrow widths, a few layers: zamba2's Mamba2 blocks and one shared
# attention block, rwkv6's wkv blocks, danube's windowed attention
MODELS = {
    "zamba2-2.7b": dict(n_layers=6, layer_pattern="MMMMMH"),
    "rwkv6-3b": dict(n_layers=3),
    "h2o-danube-3-4b": dict(n_layers=2, swa_window=16),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ssd_carry_dropped(x, dt, A, B, C, init_state=None):
    """The SSD scan with the state carry into the second 64-token chunk
    dropped."""
    y0, s0 = ssd_scan_plain(x[:, :64], dt[:, :64], A, B[:, :64], C[:, :64], init_state)
    y1, s1 = ssd_scan_plain(x[:, 64:], dt[:, 64:], A, B[:, 64:], C[:, 64:], init_state)
    return torch.cat([y0, y1], dim=1), s1


def _wkv_without_bonus(r, k, v, w, u, init_state=None):
    return wkv6_plain(r, k, v, w, torch.zeros_like(u), init_state)


def _flash_window_off_by_one(q, k, v, *, causal=True, window=None, **kw):
    return flash_attention_plain(q, k, v, causal=causal,
                                 window=None if window is None else window + 1, **kw)


SLIPS = {
    "zamba2-2.7b": (m_mamba2, "ssd_scan", _ssd_carry_dropped),
    "rwkv6-3b": (m_rwkv6, "wkv6", _wkv_without_bonus),
    "h2o-danube-3-4b": (m_model, "flash_attention", _flash_window_off_by_one),
}


def _errs(arch):
    cfg = get_reduced(arch, dtype="bfloat16", param_dtype="bfloat16", **MODELS[arch])
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32))
    return chip_smoke.layer_update_errors(torch, cfg, params, {"tokens": tokens})


@pytest.mark.parametrize("arch", list(MODELS))
def test_layer_check_passes_the_plain_kernels(arch):
    errs = _errs(arch)
    assert len(errs) == MODELS[arch]["n_layers"]
    assert all(np.isfinite(e_k) and 0 < e_t for _, _, e_k, e_t in errs), errs
    assert chip_smoke.layers_within_bound(errs), errs


@pytest.mark.parametrize("arch", list(MODELS))
def test_layer_check_catches_a_slipped_kernel(arch, monkeypatch):
    """Each slip fails the check on the blocks that run the kernel, and
    leaves the twin's errors as they were."""
    clean = _errs(arch)
    module, name, slip = SLIPS[arch]
    monkeypatch.setattr(module, name, slip)
    errs = _errs(arch)
    assert not chip_smoke.layers_within_bound(errs), errs
    assert [e[3] for e in errs] == [e[3] for e in clean]
