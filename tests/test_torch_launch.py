"""The port's launch layer (``repro_torch.launch``: mesh, sharding rules,
``cell()`` and the dry-run) against the reference's.

The specs of every parameter, batch and decode-state leaf of all 10
configurations, on both production meshes, equal the reference's leaf
for leaf by ``keystr`` path (the reference on ``AbstractMesh``, the port
on a name→size mapping).  Each leaf's local shape under ``shardings()``
on a ``DeviceMesh`` of a fake process group equals
``NamedSharding.shard_shape``: the process group is process-global, so
it lives in a subprocess.  ``_probe_pattern`` equals the reference's,
and a reduced cell's full-depth count equals the two-probe
extrapolation of the cost pass.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from repro_torch.checkpoint.store import _leaf_paths, model_tree
from repro_torch.configs import SHAPES, ShapeSpec, all_arch_ids, get_config, get_reduced
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import MESH_AXES, dp_axes, fsdp_axes
from repro_torch.launch.sharding import P, _is_spec, batch_specs, param_specs, state_specs
from repro_torch.models import make_decode_state
from repro_torch.models.model import Model

import test_launch as ref_launch
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import make_batch_specs as ref_batch
from repro.launch import mesh as ref_mesh
from repro.launch import sharding as ref_sharding
from repro.launch.steps import cell_config as ref_cell_config
from repro.models import make_decode_state as ref_state

ROOT = Path(__file__).resolve().parents[1]
ARCHS = all_arch_ids()
MESHES = {"pod16x16": False, "pod2x16x16": True}
SUBPROCESS_LIMIT_S = 300


def _sizes(multi_pod: bool) -> dict:
    names, shape = MESH_AXES[multi_pod]
    return dict(zip(names, shape))


def _ref_mesh(multi_pod: bool):
    return ref_launch.MESH3 if multi_pod else ref_launch.MESH


def _specs(tree) -> dict:
    """keystr path -> spec tuple of a port spec tree."""
    return {path: tuple(spec) for path, spec in _leaf_paths(tree, is_leaf=_is_spec)}


def _ref_specs(shapes, specs) -> dict:
    """keystr path -> spec tuple of a reference (shape tree, spec tree)."""
    flat_sh, _ = jax.tree_util.tree_flatten_with_path(shapes)
    flat_sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(flat_sh) == len(flat_sp)
    return {jax.tree_util.keystr(kp): tuple(sp) for (kp, _), sp in zip(flat_sh, flat_sp)}


def test_mesh_axes_and_name_logic_match_the_reference():
    assert MESH_AXES == ref_mesh.MESH_AXES
    for multi_pod in (False, True):
        m = _ref_mesh(multi_pod)
        assert fsdp_axes(_sizes(multi_pod)) == ref_mesh.fsdp_axes(m)
        assert dp_axes(_sizes(multi_pod)) == ref_mesh.dp_axes(m)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference_leaf_for_leaf(arch, mesh):
    """``param_specs`` of the full-size model (on the meta device) against
    ``tests/test_launch.py::_leaf_specs``: the same keystr paths, shapes
    and specs."""
    multi_pod = MESHES[mesh]
    cfg = get_config(arch)
    want = ref_launch._leaf_specs(ref_get_config(arch), _ref_mesh(multi_pod))
    model = Model(cfg, "meta")
    shapes = {path: tuple(leaf.shape) for path, leaf in _leaf_paths(model_tree(
        dict(model.named_parameters())))}
    got = _specs(param_specs(model, _sizes(multi_pod)))
    assert set(got) == set(want)
    for path, (shape, spec) in want.items():
        assert shapes[path] == tuple(shape), path
        assert got[path] == tuple(spec), (path, got[path], spec)


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_state_specs_match_the_reference(arch, shape_name):
    """``batch_specs`` on each shape's batch (tokens for decode) and
    ``state_specs`` on its decode state, against the reference's, on both
    meshes."""
    shape = SHAPES[shape_name]
    cfg = steps.cell_config(arch, shape_name)
    rcfg = ref_cell_config(arch, shape_name)
    B, L = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        batch = torch.empty((B,), dtype=torch.int32, device="meta")
        rbatch = jax.ShapeDtypeStruct((B,), jnp.int32)
        state = make_decode_state(cfg, B, L, start_pos=L - 1, device="meta")
        rstate = jax.eval_shape(lambda: ref_state(rcfg, B, L, start_pos=jnp.full(
            (B,), L - 1, jnp.int32)))
    else:
        batch = {k: torch.empty(s, dtype=torch.float32, device="meta")
                 for k, (s, _) in make_batch_specs(cfg, shape).items()}
        rbatch = ref_batch(rcfg, REF_SHAPES[shape_name])
        state = make_decode_state(cfg, B, L, device="meta")
        rstate = jax.eval_shape(lambda: ref_state(rcfg, B, L))
    seq = B == 1 and shape.kind != "decode"
    for multi_pod in (False, True):
        m, rm = _sizes(multi_pod), _ref_mesh(multi_pod)
        got = _specs(batch_specs(batch, m, seq_sharded=seq))
        want = _ref_specs(rbatch, ref_sharding.batch_specs(rbatch, rm, seq_sharded=seq))
        assert got == want, (multi_pod, got, want)
        got = _specs(state_specs(state, m))
        want = _ref_specs(rstate, ref_sharding.state_specs(rstate, rm))
        assert got == want, multi_pod


# the fake process group is process-global: the meshes live in a subprocess
_SHARDS = textwrap.dedent(
    """
    import json, sys
    import torch
    from repro_torch.checkpoint.store import _leaf_paths, model_tree
    from repro_torch.configs import all_arch_ids, get_config
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import _is_spec, param_specs, shardings
    from repro_torch.models.model import Model
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    import torch.distributed as dist

    fake_world(512)
    try:
        out = {}
        for multi_pod in (False, True):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            assert list(mesh.get_coordinate()) == [0] * mesh.ndim
            for arch in all_arch_ids():
                model = Model(get_config(arch), "meta")
                specs = param_specs(model, mesh)
                leaves = dict(_leaf_paths(model_tree(dict(model.named_parameters()))))
                for path, spec in _leaf_paths(specs, is_leaf=_is_spec):
                    local, _ = compute_local_shape_and_global_offset(
                        tuple(leaves[path].shape), mesh, shardings(spec, mesh))
                    out[f"{multi_pod}|{arch}|{path}"] = [list(leaves[path].shape),
                                                         list(spec), list(local)]
        json.dump(out, sys.stdout)
    finally:
        dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def dtensor_shards():
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run([sys.executable, "-c", _SHARDS], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=SUBPROCESS_LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout)


def _named_sharding_shape(shape, spec, multi_pod):
    entries = [tuple(e) if isinstance(e, list) else e for e in spec]
    return NamedSharding(_ref_mesh(multi_pod), PartitionSpec(*entries)).shard_shape(
        tuple(shape))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dtensor_local_shapes_match_named_sharding(dtensor_shards, arch, mesh):
    """Every leaf's local shard shape from ``shardings()`` on a fake
    16×16 (2×16×16) ``DeviceMesh`` (rank 0) equals
    ``NamedSharding(AbstractMesh(...), spec).shard_shape(global)``."""
    multi_pod = MESHES[mesh]
    rows = {k.split("|", 2)[2]: v for k, v in dtensor_shards.items()
            if k.startswith(f"{multi_pod}|{arch}|")}
    assert rows
    for path, (shape, spec, local) in rows.items():
        want = _named_sharding_shape(shape, spec, multi_pod)
        assert tuple(local) == want, (path, shape, spec, local, want)


def test_danube_projection_shards_as_the_probe_did(dtensor_shards):
    """h2o-danube's [3840, 10240] MLP input under P("data", "model") on
    the 16×16 mesh: a (240, 640) shard."""
    shape, spec, local = dtensor_shards[
        "False|h2o-danube-3-4b|['segs'][0]['0A']['mlp']['w_in']"]
    assert shape[-2:] == [3840, 10240] and spec[-2:] == ["data", "model"]
    assert local[-2:] == [240, 640]


@pytest.mark.parametrize("kind,shape_name", [("train", "train_4k"),
                                             ("prefill", "prefill_32k"),
                                             ("decode", "decode_32k")])
def test_cell_builds_each_kind_on_fake_tensors(kind, shape_name):
    """``cell()`` at full size: fake tensors of the shapes the reference's
    ``ShapeDtypeStruct``s have, and the reference's spec structure."""
    from torch._subclasses.fake_tensor import FakeTensor

    c = steps.cell("h2o-danube-3-4b", shape_name, _sizes(False))
    shape = SHAPES[shape_name]
    assert c.kind == kind and c.shape == shape
    params = c.args[0]
    assert all(isinstance(p, FakeTensor) for p in params.parameters())
    assert sum(p.numel() for p in params.parameters()) > 3.9e9
    B, S = shape.global_batch, shape.seq_len
    if kind == "train":
        _, opt_state, batch = c.args
        assert tuple(batch["tokens"].shape) == (B, S) and batch["tokens"].dtype == torch.int32
        assert set(opt_state.mu) == set(dict(params.named_parameters()))
        assert c.in_shardings[1].step == P() and c.in_shardings[1].mu is c.in_shardings[0]
        assert c.out_shardings[2] == P()
    elif kind == "prefill":
        assert tuple(c.args[1]["tokens"].shape) == (B, S)
        assert c.out_shardings[0] == P()
    else:
        state, tokens = c.args[1:]
        assert tuple(tokens.shape) == (B,) and isinstance(tokens, FakeTensor)
        assert state.pos.shape == (B,)
        assert c.in_shardings[2] == P("data")
        assert c.out_shardings == (c.in_shardings[2], c.in_shardings[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_pattern_matches_the_reference(arch):
    old = os.environ.get("XLA_FLAGS")
    try:  # the reference's dryrun sets XLA_FLAGS when imported
        from repro.launch.dryrun import _probe_pattern as ref_probe
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    assert dryrun._probe_pattern(get_config(arch)) == ref_probe(ref_get_config(arch))


def _reduced_overrides(arch: str, **kw) -> dict:
    """The fields ``get_reduced`` changes, as ``cell()`` overrides."""
    full, red = get_config(arch), get_reduced(arch, **kw)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


@pytest.mark.parametrize("arch,kw,kind", [
    ("h2o-danube-3-4b", {}, "prefill"),
    ("h2o-danube-3-4b", {}, "train"),
    ("zamba2-2.7b", dict(n_layers=18, layer_pattern="MMMMMH" * 3), "prefill"),
    ("rwkv6-3b", {}, "train"),
    ("deepseek-v2-lite-16b", {}, "prefill"),
    ("deepseek-v2-lite-16b", {}, "train"),
])
def test_full_depth_count_equals_the_two_probe_extrapolation(arch, kw, kind, monkeypatch,
                                                             tmp_path):
    """The cost pass on a reduced cell: its two shallow probes,
    extrapolated linearly in depth as the reference does, give the FLOPs,
    bytes and collectives the port counts over the full depth."""
    name = f"tiny_{kind}"
    monkeypatch.setitem(SHAPES, name, ShapeSpec(name, 32, 2, kind))
    rec = dryrun.run_cost_probe(arch, name, out_dir=tmp_path,
                                overrides=_reduced_overrides(arch, **kw))
    assert rec["status"] == "ok", rec.get("traceback")
    k1, k2 = rec["probe_layers"]
    assert k1 < k2 < get_reduced(arch, **kw).n_layers
    assert rec["flops"] > 0
    for key, full in rec["full_depth"].items():
        assert rec[key] == full, (key, rec[key], full)


def test_dryrun_cli_writes_a_record_per_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the CPU: an ``ok`` record
    with the roofline and ``fits`` on one H100, exit 0; and the
    reference's ``skipped`` with its reason."""
    out = tmp_path / "out"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "whisper-small", "--shape", "decode_32k", "--out", str(out)],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH="src"),
                          capture_output=True, text=True, timeout=SUBPROCESS_LIMIT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ok = json.loads((out / "whisper-small_decode_32k_h100.json").read_text())
    assert ok["status"] == "ok" and ok["kind"] == "decode" and ok["n_devices"] == 1
    assert ok["fits"] == (ok["peak_bytes"] <= 80e9) and ok["dominant"] in (
        "compute", "memory", "collective")
    assert ok["memory"]["peak_size_in_bytes"] >= ok["memory"]["argument_size_in_bytes"] > 0
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "yi-34b", "--shape", "long_500k", "--out", str(out)])
    assert done.value.code == 0
    skipped = json.loads((out / "yi-34b_long_500k_h100.json").read_text())
    assert skipped["status"] == "skipped" and "quadratic" in skipped["reason"]
