"""The port's checkpoint store against the JAX package's, on the CPU.

The two packages share one on-disk format, so each restores the other's
directory: a generic tree (dicts, a list, a named tuple; f32, int32 and
bf16 leaves) and whole training states — a model's parameters in the
JAX package's layout (a segment's reps and an encoder's blocks stacked)
with AdamW's moments — written by one package and restored by the other
bit for bit.  A corrupted leaf raises on its CRC, keep-N pruning keeps
the newest, and an async save followed by an in-place update of the
saved tensors still restores the saved values.  The port's copies of
``tests/test_checkpoint.py``'s cases follow.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, restore_latest, save_checkpoint
from repro_torch.checkpoint.store import Stacked, model_tree
from repro_torch.optim import OptState


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(16, 8, generator=g),
        "b": torch.arange(8, dtype=torch.float32),
        "nested": {"scale": torch.tensor(2.5), "table": torch.randn(4, 4, generator=g)
                   .to(torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
        "seq": [torch.ones(3), torch.zeros(2, dtype=torch.int32)],
        "opt": OptState(torch.tensor(3, dtype=torch.int32), {"x": torch.full((2,), 0.5)},
                        {"x": torch.full((2,), 0.25)}),
    }


def _like(tree):
    """Zeroed tensors of the same structure (a fresh model's stand-in)."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_like(v) for v in tree))
    return type(tree)(_like(v) for v in tree)


def _flat(tree, prefix=""):
    from repro_torch.checkpoint.store import _leaf_paths

    return dict(_leaf_paths(tree, prefix))


def _assert_tree_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        assert x.dtype == y.dtype, k
        assert torch.equal(x, y), k


def _to_jax(tree):
    """The same values as JAX arrays (bf16 through its bits)."""
    import jax.numpy as jnp
    import ml_dtypes

    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return jnp.asarray(tree.view(torch.uint16).numpy().view(ml_dtypes.bfloat16))
        return jnp.asarray(tree.numpy())
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        from repro.optim import OptState as JOptState

        return JOptState(*(_to_jax(v) for v in tree))
    return type(tree)(_to_jax(v) for v in tree)


def _from_jax(tree):
    from repro_torch.models.convert import tensor_from_numpy

    if isinstance(tree, dict):
        return {k: _from_jax(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return OptState(*(_from_jax(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_jax(v) for v in tree)
    return tensor_from_numpy(np.asarray(tree))


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def test_names_are_jax_keystr():
    jax = pytest.importorskip("jax")
    t = _tree()
    flat, _ = jax.tree_util.tree_flatten_with_path(_to_jax(t))
    assert list(_flat(t)) == [jax.tree_util.keystr(k) for k, _ in flat]


def test_reference_restores_the_ports_directory(tmp_path):
    pytest.importorskip("jax")
    from repro.checkpoint import CheckpointManager as JManager

    t = _tree(1)
    CheckpointManager(tmp_path).save(4, t, blocking=True)
    restored, step = JManager(tmp_path).restore(_to_jax(_like(t)))
    assert step == 4
    _assert_tree_equal(_from_jax(restored), t)


def test_port_restores_the_references_directory(tmp_path):
    pytest.importorskip("jax")
    from repro.checkpoint import CheckpointManager as JManager

    t = _tree(2)
    JManager(tmp_path).save(6, _to_jax(t), blocking=True)
    restored, step = CheckpointManager(tmp_path).restore(_like(t))
    assert step == 6
    _assert_tree_equal(restored, t)


_ARCHS = {"h2o-danube-3-4b": {}, "zamba2-2.7b": dict(n_layers=6, layer_pattern="MMMMMH"),
          "whisper-small": {}, "deepseek-v2-lite-16b": {}}


def _train_states(arch):
    """The JAX package's (params, opt_state) after one update on random
    gradients, and the port's model and AdamW state holding the same
    values (the moments carried across leaf by leaf)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.configs as jcfg
    import repro.models as jm
    from repro.optim import AdamW as JAdamW

    import repro_torch.configs as tcfg
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import AdamW

    kw = dict(_ARCHS[arch], param_dtype="bfloat16")
    jc, tc = jcfg.get_reduced(arch, **kw), tcfg.get_reduced(arch, **kw)
    jp = jax.jit(lambda k: jm.init_params(jc, k))(jax.random.PRNGKey(3))
    opt = JAdamW(lr=1e-2)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), jp)
    jp, js, _ = jax.jit(opt.update)(grads, opt.init(jp), jp)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    model = params_from_jax(tc, to_np(jp), device="cpu")
    ts = AdamW().init(model)
    names = list(ts.mu)
    for moments, jmom in ((ts.mu, js.mu), (ts.nu, js.nu)):
        # the JAX moments, reshaped into the port's layout through a model
        carried = params_from_jax(tc.replace(param_dtype="float32"), to_np(jmom),
                                  device="cpu")
        for n, p in zip(names, carried.parameters()):
            moments[n].copy_(p)
    ts = OptState(torch.tensor(int(js.step), dtype=torch.int32), ts.mu, ts.nu)
    return tc, (jp, js), (model, ts)


def _port_tree(model, st):
    from repro_torch.launch.train import train_state_tree

    return train_state_tree(model, st)


def _stacked_to_tensor(tree):
    flat = _flat(tree)
    return {k: torch.stack(v.parts) if isinstance(v, Stacked) else v for k, v in flat.items()}


@pytest.mark.parametrize("arch", list(_ARCHS))
def test_training_state_restores_across_packages(arch, tmp_path):
    jax = pytest.importorskip("jax")
    from repro.checkpoint import CheckpointManager as JManager

    from repro_torch.models import init_params
    from repro_torch.optim import AdamW

    tc, (jp, js), (model, ts) = _train_states(arch)
    want = _stacked_to_tensor(_port_tree(model, ts))
    jnames = [jax.tree_util.keystr(k)
              for k, _ in jax.tree_util.tree_flatten_with_path((jp, js))[0]]
    assert sorted(want) == sorted(jnames)
    # the reference writes, the port restores into a fresh model in place
    JManager(tmp_path / "ref").save(1, (jp, js), blocking=True)
    fresh = init_params(tc, seed=9, device="cpu")
    fresh_st = AdamW().init(fresh)
    _, step = CheckpointManager(tmp_path / "ref").restore(_port_tree(fresh, fresh_st))
    assert step == 1
    got = _stacked_to_tensor(_port_tree(fresh, fresh_st))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the port writes, the reference restores
    CheckpointManager(tmp_path / "port").save(2, _port_tree(model, ts), blocking=True)
    like = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), (jp, js))
    back, step = JManager(tmp_path / "port").restore(like)
    assert step == 2
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                 jax.tree_util.tree_flatten_with_path((jp, js))[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))


def test_model_tree_stacks_reps_and_encoder_blocks():
    named = {"embed": torch.zeros(4, 2), "segs.0.0.0A.attn.wq": torch.zeros(2, 2),
             "segs.0.1.0A.attn.wq": torch.ones(2, 2), "segs.1.0.0M.ln": torch.zeros(2),
             "encoder.blocks.0.ln1": torch.ones(2), "encoder.norm": torch.ones(2)}
    tree = model_tree(named)
    assert isinstance(tree["segs"], list) and len(tree["segs"]) == 2
    wq = tree["segs"][0]["0A"]["attn"]["wq"]
    assert isinstance(wq, Stacked) and wq.shape == (2, 2, 2)
    assert wq.parts[1] is named["segs.0.1.0A.attn.wq"]
    assert tree["segs"][1]["0M"]["ln"] is named["segs.1.0.0M.ln"]  # one rep: no stack
    assert isinstance(tree["encoder"]["blocks"]["ln1"], Stacked)  # one layer: stacked
    assert tree["encoder"]["norm"] is named["encoder.norm"]


# ---------------------------------------------------------------------------
# async saves, in-place updates
# ---------------------------------------------------------------------------


def test_async_save_then_in_place_step_restores_the_saved_values(tmp_path):
    t = _tree(4)
    saved = _like(t)
    for k, v in _flat(t).items():
        _flat(saved)[k].copy_(v)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, t)  # async: the leaves are on the host before this returns
    with torch.no_grad():
        for v in _flat(t).values():  # the next step writes in place at once
            v.add_(1)
    mgr.wait()
    restored, _ = mgr.restore(_like(t))
    _assert_tree_equal(restored, saved)


def test_restore_writes_stacked_parts_in_place(tmp_path):
    parts = [torch.full((3,), float(i)) for i in range(4)]
    save_checkpoint(tmp_path, 1, {"w": Stacked(parts)})
    fresh = [torch.zeros(3) for _ in range(4)]
    restored, _ = restore_latest(tmp_path, {"w": Stacked(fresh)})
    assert restored["w"].parts[2] is fresh[2]
    for i, p in enumerate(fresh):
        assert torch.equal(p, parts[i])


def test_restore_into_numpy_like_returns_arrays(tmp_path):
    t = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "h": torch.ones(2, dtype=torch.bfloat16)}
    save_checkpoint(tmp_path, 1, t)
    out, _ = restore_latest(tmp_path, {"a": np.zeros((2, 3), np.float64),
                                       "h": np.zeros(2, np.float32)})
    assert out["a"].dtype == np.float64 and out["a"][1, 2] == 5.0
    np.testing.assert_array_equal(out["h"], np.ones(2, np.float32))


# ---------------------------------------------------------------------------
# the port's copies of tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(100, t, blocking=True)
    restored, step = mgr.restore(_like(t))
    assert step == 100
    _assert_tree_equal(t, restored)


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree(1)
    mgr.save(5, t)
    mgr.wait()
    restored, step = mgr.restore(_like(t))
    assert step == 5
    _assert_tree_equal(t, restored)


def test_latest_and_keep_n(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(s, _tree(s), blocking=True)
    assert sorted(mgr._steps()) == [30, 40]
    assert mgr.latest_step() == 40
    restored, step = mgr.restore(_like(_tree()))
    assert step == 40
    _assert_tree_equal(restored, _tree(40))


def test_atomic_commit_no_partial_visible(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(), blocking=True)
    (tmp_path / "step_000000000002.tmp").mkdir()
    assert mgr.latest_step() == 1


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree(2)
    mgr.save(3, t, blocking=True)
    shard = next((tmp_path / "step_000000000003").glob("shard_*.bin"))
    raw = bytearray(shard.read_bytes())
    raw[-8] ^= 0xFF  # flip a payload bit
    shard.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="CRC"):
        mgr.restore(_like(t))


def test_multi_shard_layout(tmp_path):
    t = _tree(3)
    m0 = CheckpointManager(tmp_path, shard_id=0, n_shards=2, is_primary=False)
    m1 = CheckpointManager(tmp_path, shard_id=1, n_shards=2, is_primary=True)
    m0.save(9, t, blocking=True)
    m1.save(9, t, blocking=True)
    restored, step = CheckpointManager(tmp_path).restore(_like(t))
    assert step == 9
    _assert_tree_equal(t, restored)


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore(_tree())
