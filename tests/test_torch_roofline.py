"""The port's roofline (``repro_torch.roofline``) against the reference's.

``model_flops`` and ``roofline_terms`` equal the reference's;
``collective_bytes`` on the port's collective records equals the
reference's parse of hand-written HLO lines of the same collectives;
``analyze_step``'s FLOPs on fake tensors equal ``FlopCounterMode`` on a
real CPU run of the same reduced prefill, and its bytes and peak the
real run's; on fake tensors a kernel wrapper reports its kernel's work.
"""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as REF_SHAPES
from repro.launch.steps import cell_config as ref_cell_config
from repro.roofline import analysis as ref
from repro_torch.comm.collectives import CollectiveRecord
from repro_torch.configs import SHAPES, ShapeSpec, all_arch_ids, get_config, get_reduced
from repro_torch.kernels.flash_attention.ops import kept_pairs
from repro_torch.launch import steps
from repro_torch.models import init_params
from repro_torch.roofline import HW, analyze_step, collective_bytes, model_flops, roofline_terms


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", all_arch_ids())
def test_model_flops_match_the_reference(arch, shape_name):
    want = ref.model_flops(ref_cell_config(arch, shape_name), REF_SHAPES[shape_name])
    assert model_flops(steps.cell_config(arch, shape_name), SHAPES[shape_name]) == want


@pytest.mark.parametrize("counts", [
    dict(flops=9.3e15, bytes_accessed=2.5e13, ici=0.0, dci=0.0),  # compute-bound
    dict(flops=7.5e11, bytes_accessed=4.5e10, ici=1e9, dci=0.0),  # memory-bound
    dict(flops=1e9, bytes_accessed=1e9, ici=6e9, dci=3e9),  # collective-bound
    dict(flops=0.0, bytes_accessed=0.0, ici=0.0, dci=0.0),
])
def test_roofline_terms_match_the_reference(counts):
    """The same counts under both packages' key names, the port's H100
    constants given to both."""
    coll = dict(coll_ici_bytes=counts["ici"], coll_dci_bytes=counts["dci"])
    ref_hw = ref.HW(**dataclasses.asdict(HW()))
    want = ref.roofline_terms(dict(hlo_flops=counts["flops"], hlo_bytes=counts["bytes_accessed"],
                                   **coll), n_devices=1, hw=ref_hw)
    got = roofline_terms(dict(flops=counts["flops"], bytes_accessed=counts["bytes_accessed"],
                              **coll), n_devices=1)
    assert got == want


def test_hw_is_the_h100_data_sheet_and_chip_smoke_reads_it():
    import chip_smoke

    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.dci_bw, hw.hbm_bytes) == (
        989e12, 3.35e12, 450e9, 50e9, 80e9)
    assert chip_smoke.BF16_FLOP_PER_S == hw.peak_flops
    assert chip_smoke.HBM_BYTES_PER_S == hw.hbm_bw


def _ring(n, first=0, stride=1):
    ranks = [first + stride * i for i in range(n)]
    return tuple((ranks[i], ranks[(i + 1) % n]) for i in range(n))


# (HLO line as XLA prints it, the port's record of the same collective,
# n_devices): every kind, both link classes, both replica-group spellings
_HLO_CASES = {
    "all-gather": (
        "%ag = bf16[64,128]{1,0} all-gather(bf16[8,128]{1,0} %x), "
        "replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}",
        CollectiveRecord("all-gather", 8, 8 * 128 * 2, 64 * 128 * 2), 8),
    "reduce-scatter": (
        "%rs = f32[4,8]{1,0} reduce-scatter(f32[32,8]{1,0} %y), "
        "replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}, to_apply=%add",
        CollectiveRecord("reduce-scatter", 8, 32 * 8 * 4, 4 * 8 * 4), 8),
    "reduce-scatter-iota-groups": (
        "%rs = f32[4,8]{1,0} reduce-scatter(f32[64,8]{1,0} %y), "
        "replica_groups=[32,16]<=[512], dimensions={0}, to_apply=%add",
        CollectiveRecord("reduce-scatter", 16, 64 * 8 * 4, 4 * 8 * 4), 512),
    "all-reduce-pod": (
        "%ar = f32[1024]{0} all-reduce(f32[1024]{0} %z), replica_groups={{0,256}}, "
        "to_apply=%add",
        CollectiveRecord("all-reduce", 2, 4096, 4096), 512),
    "all-to-all": (
        "%a2a = f32[8,16]{1,0} all-to-all(f32[8,16]{1,0} %w), "
        "replica_groups={{0,1,2,3}}, dimensions={0}",
        CollectiveRecord("all-to-all", 4, 512, 512), 4),
    "collective-permute": (
        "%cp = f32[2,4]{1,0} collective-permute(f32[2,4]{1,0} %b), "
        "source_target_pairs={{0,1},{1,2},{2,3},{3,0}}",
        CollectiveRecord("collective-permute", 4, 32, 32, _ring(4)), 4),
    "collective-permute-start": (
        "%cp = bf16[16,4]{1,0} collective-permute-start(bf16[16,4]{1,0} %b), "
        "source_target_pairs={{0,16},{16,32},{32,0}}",
        CollectiveRecord("collective-permute", 3, 128, 128, _ring(3, 0, 16)), 512),
}


@pytest.mark.parametrize("case", list(_HLO_CASES))
def test_collective_bytes_on_records_match_the_reference_on_hlo(case):
    hlo, rec, n_devices = _HLO_CASES[case]
    want = ref.collective_bytes(hlo, n_devices=n_devices)
    got = collective_bytes([rec], n_devices=n_devices)
    assert want.n_ops == 1
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_permute_across_pods_is_dci_where_the_reference_parse_misses_it():
    """A permute whose pairs jump by 256 or more crosses pods: DCI, as the
    reference's rule says.  The reference's parse never applies the rule:
    its ``source_target_pairs=\\{([^}]*)\\}`` stops at the first pair's
    closing brace, so no pair is found and every permute counts as ICI."""
    hlo = ("%cp = bf16[16,4]{1,0} collective-permute(bf16[16,4]{1,0} %b), "
           "source_target_pairs={{0,256},{256,0}}")
    want = ref.collective_bytes(hlo, n_devices=512)
    assert (want.ici_bytes, want.dci_bytes) == (128.0, 0.0)  # the reference's miss
    got = collective_bytes(
        [CollectiveRecord("collective-permute", 2, 128, 128, _ring(2, 0, 256))], n_devices=512)
    assert (got.ici_bytes, got.dci_bytes) == (0.0, 128.0)
    assert (got.n_ops, got.by_kind) == (want.n_ops, want.by_kind)


def test_collective_bytes_count_no_wire_for_a_ring_of_one():
    """A permute to the rank itself is a local copy, a group of one sends
    nothing."""
    recs = [CollectiveRecord("collective-permute", 1, 64, 64, ((0, 0),)),
            CollectiveRecord("all-gather", 1, 64, 64)]
    got = collective_bytes(recs, n_devices=1)
    assert (got.n_ops, got.ici_bytes, got.dci_bytes) == (0, 0.0, 0.0)


# reduced prefills: (arch, config overrides, the batch beyond tokens)
_PREFILLS = {
    "h2o-danube-3-4b": {},
    "zamba2-2.7b": dict(n_layers=12, layer_pattern="MMMMMH" * 2),
    "rwkv6-3b": {},
    "deepseek-v2-lite-16b": {},
    "whisper-small": {},
}
_SEQ, _BATCH = 24, 2


def _reduced_cell(monkeypatch, arch, **kw):
    """The reduced config's prefill cell at a tiny shape, and the same
    prefill's real arguments on the CPU (weights from seed 0)."""
    name = "tiny_prefill"
    monkeypatch.setitem(SHAPES, name, ShapeSpec(name, _SEQ, _BATCH, "prefill"))
    full, red = get_config(arch), get_reduced(arch, **{**_PREFILLS[arch], **kw})
    overrides = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
                 if getattr(red, f.name) != getattr(full, f.name)}
    c = steps.cell(arch, name, {"data": 1, "model": 1}, **overrides)
    gen = torch.Generator().manual_seed(1)
    batch = {k: (torch.randint(0, c.cfg.vocab_size, tuple(v.shape), generator=gen,
                               dtype=v.dtype) if k == "tokens"
                 else torch.randn(tuple(v.shape), generator=gen).to(v.dtype))
             for k, v in c.args[1].items()}
    return c, init_params(c.cfg, seed=0, device="cpu"), batch


@pytest.mark.parametrize("arch", list(_PREFILLS))
def test_analyze_step_counts_a_fake_prefill_as_a_real_run(arch, monkeypatch):
    """On fake tensors, ``analyze_step`` counts the FLOPs that
    ``FlopCounterMode`` counts on a real CPU run of the same reduced
    prefill (the torch twins), and the same bytes and peak; an MoE's
    routing (``nonzero``) is counted at its most on fake tensors, so
    there the bytes and peak are at least the real run's."""
    c, params, batch = _reduced_cell(monkeypatch, arch, use_flash=False)
    counter = FlopCounterMode(display=False)
    with counter:  # first: a cached constant (the rotary table) is made once
        c.fn(params, batch)
    fake = analyze_step(c.fn, *c.args)
    assert fake["flops"] == counter.get_total_flops() > 0
    real = analyze_step(c.fn, params, batch)
    assert real["flops"] == fake["flops"]
    moe = "E" in c.cfg.pattern
    assert (fake["data_dependent_ops"] > 0) == moe
    peak = "peak_size_in_bytes"
    if moe:
        assert fake["bytes_accessed"] >= real["bytes_accessed"]
        assert fake["memory"][peak] >= real["memory"][peak]
    else:
        assert fake["bytes_accessed"] == real["bytes_accessed"]
        assert fake["memory"] == real["memory"]


@pytest.mark.parametrize("arch,launches", [
    ("h2o-danube-3-4b", {"flash_attention": 4}),
    ("zamba2-2.7b", {"ssd_scan": 12, "flash_attention": 2}),
    ("rwkv6-3b", {"wkv6": 4}),
])
def test_kernels_on_fake_tensors_report_their_work(arch, launches, monkeypatch):
    """With ``use_flash`` the prefill reaches the kernel wrappers, which on
    fake tensors launch nothing and report each kernel's FLOPs: 4 d a
    kept (query, key) pair for flash, 4 a state entry a token for the
    scans."""
    from repro_torch.kernels import flash_attention as fa

    before = dict(fa.launches)
    c, _, _ = _reduced_cell(monkeypatch, arch, use_flash=True)
    got = analyze_step(c.fn, *c.args)
    assert fa.launches == before
    assert got["kernel_launches"] == launches
    cfg, B, S = c.cfg, _BATCH, _SEQ
    want = 0
    if "flash_attention" in launches:
        pairs = kept_pairs(S, S, S, True, cfg.swa_window)
        want += launches["flash_attention"] * 4 * cfg.hd * B * cfg.n_heads * pairs
    if "ssd_scan" in launches:
        h = cfg.d_model * cfg.ssm_expand // cfg.ssm_head_dim
        want += launches["ssd_scan"] * 4 * B * S * h * cfg.ssm_head_dim * cfg.ssm_state
    if "wkv6" in launches:
        N = cfg.rwkv_head_size
        want += launches["wkv6"] * 4 * B * S * (cfg.d_model // N) * N * N
    assert got["kernel_flops"] == want
    assert got["flops"] > got["kernel_flops"]


def test_peak_counts_storages_not_views():
    """Arguments count from the start; a view or an in-place update adds
    nothing; a freed temporary leaves the live bytes."""
    x = torch.zeros(1000)  # 4000 bytes, an argument

    def step(x):
        t = torch.ones(2000)  # +8000: live 12000
        v = t[10:]  # a view: +0
        v.add_(1.0)  # in place: +0
        s = v.sum()  # +4: live 12004, the peak
        del t, v
        return x.mul_(s)  # in place into the argument: +0

    got = analyze_step(step, x)
    assert got["memory"] == dict(argument_size_in_bytes=4000, output_size_in_bytes=0,
                                 peak_size_in_bytes=12004, temp_size_in_bytes=8004)
