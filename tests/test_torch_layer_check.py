"""The per-layer, teacher-forced bf16 check of ``chip_smoke.py`` has
teeth: on the CPU, at narrow widths and a few layers, the same measure
passes the kernels' plain versions and fails each of five slips a
kernel could make.

``chip_smoke.layer_update_errors`` feeds every block the bf16 twin's
activation x_i and compares the block's update y - x_i, with the kernels
(``use_flash``) and with the bf16 twin, against the block in f32
(``bf16_rel_err``, row-normalised); ``layers_within_bound`` holds the
kernels to ``max(LAYER_FLOOR, 1.5 x the twin's error)`` on every block.
On the CPU the kernel route is the wrappers' plain versions, so a slip is
injected by patching the wrapper each model calls.  whisper's encoder
blocks are checked before its decoder blocks; an MoE block (grok-1) is
measured on the token rows whose kept experts agree with the f32
block's.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.configs import get_reduced
from repro_torch.kernels.mamba2_scan import ssd_scan_plain
from repro_torch.kernels.rwkv6_wkv import wkv6_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import attention as m_attention
from repro_torch.models import init_params
from repro_torch.models import mamba2 as m_mamba2
from repro_torch.models import model as m_model
from repro_torch.models import rwkv6 as m_rwkv6

BATCH, SEQ = 2, 128  # two SSD chunks of 64 and eight windows of 16
# narrow widths, a few layers: zamba2's Mamba2 blocks and one shared
# attention block, rwkv6's wkv blocks, danube's windowed attention,
# grok-1's MoE blocks under GQA 2:1, whisper's non-causal encoder and
# cross-attention
MODELS = {
    "zamba2-2.7b": dict(n_layers=6, layer_pattern="MMMMMH"),
    "rwkv6-3b": dict(n_layers=3),
    "h2o-danube-3-4b": dict(n_layers=2, swa_window=16),
    "grok-1-314b": dict(n_layers=2, n_kv_heads=2),
    "whisper-small": dict(n_layers=2, n_enc_layers=2, enc_seq=48),
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


def _flash_kv_heads_interleaved(q, k, v, **kw):
    """GQA with query head h on KV head h % KV, not h // (H / KV)."""
    G = q.shape[2] // k.shape[2]
    return flash_attention_plain(q, k.repeat(1, 1, G, 1), v.repeat(1, 1, G, 1), **kw)


def _flash_made_causal(q, k, v, *, causal=True, **kw):
    return flash_attention_plain(q, k, v, causal=True, **kw)


SLIPS = {
    "zamba2-2.7b": (m_mamba2, "ssd_scan", _ssd_carry_dropped),
    "rwkv6-3b": (m_rwkv6, "wkv6", _wkv_without_bonus),
    "h2o-danube-3-4b": (m_model, "flash_attention", _flash_window_off_by_one),
    "grok-1-314b": (m_model, "flash_attention", _flash_kv_heads_interleaved),
    # the encoder's and the cross-attention's calls
    "whisper-small": (m_attention, "flash_attention", _flash_made_causal),
}


def _errs(arch):
    cfg = get_reduced(arch, dtype="bfloat16", param_dtype="bfloat16", **MODELS[arch])
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32))}
    if cfg.enc_dec:
        batch["enc_frames"] = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model), dtype=np.float32)).bfloat16()
    return chip_smoke.layer_update_errors(torch, cfg, params, batch)


@pytest.mark.parametrize("arch", list(MODELS))
def test_layer_check_passes_the_plain_kernels(arch):
    errs = _errs(arch)
    assert len(errs) == MODELS[arch]["n_layers"] + MODELS[arch].get("n_enc_layers", 0)
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


@pytest.mark.parametrize("flipped", [(), (1,), (0, 1)])
def test_logits_flip_exclusion_keeps_a_row_each_step(flipped):
    """A logits step of an MoE model is measured on its rows routed as in
    the run it is held to; a step whose rows all flipped fails instead of
    dropping out of the comparison."""
    a = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    b = torch.tensor([[1.0, 2.5], [3.0, 9.0]])
    flip = torch.tensor([i in flipped for i in range(2)])
    if len(flipped) == 2:
        with pytest.raises(AssertionError):
            chip_smoke.held_err(a, b, flip)
    else:
        rows = [i for i in range(2) if i not in flipped]
        assert chip_smoke.held_err(a, b, flip, rel=False) == float(
            (a[rows] - b[rows]).abs().max())


def test_logits_flip_cap_counts_every_step():
    """More flipped rows over a run than ``MOE_LOGIT_FLIP_SHARE`` allows fail."""
    steps = 17
    n = int(chip_smoke.MOE_LOGIT_FLIP_SHARE * 2 * steps)
    flips = [torch.tensor([i < n, False]) for i in range(steps)]
    chip_smoke.assert_few_flips(flips, "at the cap")
    flips[n] = torch.tensor([True, False])
    with pytest.raises(AssertionError):
        chip_smoke.assert_few_flips(flips, "over the cap")
