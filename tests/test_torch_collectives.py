"""The port's collectives (``repro_torch.comm``) against the reference's.

Seeded numpy inputs go through the reference's seven primitives under
``shard_map`` on 8 fake CPU devices and on one, in one subprocess (as
``tests/test_collectives.py`` runs them), and through the port's on a
gloo group of 8 ranks and on one of a single rank (the self-peer cases),
each a ``torch.multiprocessing`` spawn (``tests/_gloo_ranks.py``).
Every rank's output is held to the reference's shard of the same rank:
bit for bit where no matmul is involved, to ``rtol=atol=1e-5`` for
``ag_matmul`` and ``matmul_rs``; the f64 Jacobi step bit for bit to a
NumPy sweep.  The ranks meet through a ``FileStore`` in ``tmp_path``
(never a TCP port: several test workers run at once), with a 60 s gloo
timeout, one torch thread a rank and a limit on the spawn's join.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch.multiprocessing as mp

import _gloo_ranks as ranks

ROOT = Path(__file__).resolve().parents[1]
N = 8
SPAWN_LIMIT_S = 180
MATMUL_TOL = 1e-5
MATMUL_CASES = {"ag_matmul_ring", "ag_matmul_none", "matmul_rs_ring", "matmul_rs_none"}
RING_CASES = ["ring_all_gather", "ring_all_gather_axis1", "ring_reduce_scatter",
              "ring_reduce_scatter_lazy", "ag_matmul_ring", "matmul_rs_ring",
              "stencil_1d_ring", "stencil_1d_periodic", "jacobi_ring", "jacobi_f64_ring"]
BLOCKING_CASES = ["ag_matmul_none", "matmul_rs_none", "halo_exchange", "stencil_1d_none",
                  "jacobi_none", "jacobi_f64_none"]
F32_CASES = [c for c in ranks.cases(None, {}) if "f64" not in c]

_REFERENCE = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:  # jax <= 0.4.x
        from jax.experimental.shard_map import shard_map
    from repro.comm.collectives import (
        ring_all_gather, ring_reduce_scatter, ag_matmul, matmul_rs,
        halo_exchange, stencil_1d_sharded, jacobi_step_sharded,
    )
    sys.path.insert(0, "tests")
    from _gloo_ranks import SHARDED, point

    inputs, out_path = dict(np.load(sys.argv[1])), sys.argv[2]

    def spec(name):
        d = SHARDED[name]
        return P() if d is None else P(*([None] * d + ["x"]))

    CASES = {
        "ring_all_gather": (lambda a: ring_all_gather(a, "x"), ["x16"], 1),
        "ring_all_gather_axis1": (lambda a: ring_all_gather(a, "x", axis=1), ["x4x16"], 1),
        "ring_reduce_scatter": (lambda a: ring_reduce_scatter(a, "x", axis=0), ["z"], 1),
        "ring_reduce_scatter_lazy": (lambda a: ring_reduce_scatter(
            lambda c: lax.dynamic_slice_in_dim(a, c, 1, 0) * 0.5, "x", axis=0), ["z"], 1),
        "ag_matmul_ring": (lambda a, b: ag_matmul(a, b, "x", gather_axis=0), ["xs", "w"], 1),
        "ag_matmul_none": (lambda a, b: ag_matmul(a, b, "x", overlap="none", gather_axis=0),
                           ["xs", "w"], 1),
        "matmul_rs_ring": (lambda a, b: matmul_rs(a, b, "x", scatter_axis=0), ["xk", "wk"], 1),
        "matmul_rs_none": (lambda a, b: matmul_rs(a, b, "x", overlap="none", scatter_axis=0),
                           ["xk", "wk"], 1),
        "halo_exchange": (lambda a: halo_exchange(a, "x"), ["u"], 2),
        "halo_exchange_periodic": (lambda a: halo_exchange(a, "x", periodic=True), ["u"], 2),
        "halo_exchange_axis1": (lambda a: halo_exchange(a, "x", halo=2, axis=1), ["g8x32"], 2),
        "stencil_1d_ring": (lambda a: stencil_1d_sharded(a, "x", point), ["u"], 1),
        "stencil_1d_none": (lambda a: stencil_1d_sharded(a, "x", point, overlap="none"),
                            ["u"], 1),
        "stencil_1d_periodic": (lambda a: stencil_1d_sharded(a, "x", point, periodic=True),
                                ["u"], 1),
        "jacobi_ring": (lambda a: jacobi_step_sharded(a, "x"), ["g"], 1),
        "jacobi_none": (lambda a: jacobi_step_sharded(a, "x", overlap="none"), ["g"], 1),
    }
    # every case in one program a mesh: one compile each.  Each shard's
    # output is returned as it is, the global output split back into the
    # ranks' shards: under jax 0.9.0, a jitted 1-device shard_map that
    # returned jacobi_step_sharded(a, "x")[None] gave other values than
    # its eager run and the NumPy sweep (without the [None] they agree)
    names = [k for k in SHARDED if inputs[k].dtype == np.float32]

    def body(*a):
        a = dict(zip(names, a))
        outs = []
        for f, keys, n_out in CASES.values():
            got = f(*(a[k] for k in keys))
            outs += list(got) if isinstance(got, tuple) else [got]
        return tuple(outs)

    n_outs = sum(n_out for *_, n_out in CASES.values())
    out = {}
    for n in (8, 1):
        mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
        kw = dict(mesh=mesh, in_specs=tuple(spec(k) for k in names),
                  out_specs=(P("x"),) * n_outs)
        try:
            sm = shard_map(body, check_vma=False, **kw)
        except TypeError:  # jax <= 0.4.x spells it check_rep
            sm = shard_map(body, check_rep=False, **kw)
        got = iter(np.asarray(o) for o in jax.jit(sm)(*(inputs[k] for k in names)))
        for name, (_, _, n_out) in CASES.items():
            for i in range(n_out):
                out[f"n{n}.{name}.{i}"] = np.stack(np.split(next(got), n))
    np.savez(out_path, **out)
    print("REFERENCE-DONE")
    """
)


def _spawn(n: int, tmp: Path, in_path: Path) -> Path:
    """The port's ranks on a gloo group of ``n``; returns their output
    directory.  Fails, and ends every rank, past SPAWN_LIMIT_S."""
    out = tmp / f"port{n}"
    out.mkdir()
    ctx = mp.start_processes(ranks.run_rank, nprocs=n, join=False, start_method="spawn",
                             args=(n, str(tmp / f"store{n}"), str(in_path), str(out)))
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {n} gloo ranks ran past {SPAWN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, {n: (per-rank outputs, per-rank logs)}, inputs):
    the reference's subprocess runs while the port's ranks do."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("collectives")
    inputs = ranks.make_inputs(0)
    in_path = tmp / "inputs.npz"
    np.savez(in_path, **inputs)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    ref_path = tmp / "reference.npz"
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(in_path), str(ref_path)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        port = {}
        for n in (N, 1):
            out = _spawn(n, tmp, in_path)
            port[n] = ([dict(np.load(out / f"rank{r}.npz")) for r in range(n)],
                       [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)])
        stdout, stderr = proc.communicate(timeout=SPAWN_LIMIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "REFERENCE-DONE" in stdout, stdout + stderr
    return dict(np.load(ref_path)), port, inputs


@pytest.mark.parametrize("n", [N, 1])
@pytest.mark.parametrize("case", F32_CASES)
def test_port_matches_the_reference_rank_for_rank(runs, case, n):
    ref, port, _ = runs
    outs, _ = port[n]
    n_out = 2 if case.startswith("halo") else 1
    for i in range(n_out):
        want = ref[f"n{n}.{case}.{i}"]
        assert want.shape[0] == n
        for r in range(n):
            got = outs[r][f"{case}.{i}"]
            assert got.shape == want[r].shape and got.dtype == want[r].dtype, case
            if case in MATMUL_CASES:
                np.testing.assert_allclose(got, want[r], rtol=MATMUL_TOL, atol=MATMUL_TOL)
            else:
                np.testing.assert_array_equal(got, want[r], err_msg=f"{case} rank {r}")


def _numpy_sweep(full: np.ndarray) -> np.ndarray:
    """One sweep of the fig. 10 program (``chip_smoke.numpy_sweeps``)."""
    full = full.copy()
    acc = full[1:-1, 1:-1] + full[0:-2, 1:-1]
    acc += full[2:, 1:-1]
    acc += full[1:-1, 0:-2]
    acc += full[1:-1, 2:]
    full[1:-1, 1:-1] = 0.2 * acc
    return full


@pytest.mark.parametrize("n", [N, 1])
@pytest.mark.parametrize("mode", ["ring", "none"])
def test_jacobi_f64_equals_a_numpy_sweep_bit_for_bit(runs, n, mode):
    _, port, inputs = runs
    outs, _ = port[n]
    got = np.concatenate([outs[r][f"jacobi_f64_{mode}.0"] for r in range(n)])
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, _numpy_sweep(inputs["g64"]))


def test_subgroup_ring_uses_group_ranks(runs):
    """A ring on the ranks of one parity: its peers are group ranks,
    sent to as global ranks; each gathers its group's shards in group
    order."""
    _, port, inputs = runs
    outs, logs = port[N]
    x = inputs["x16"]
    for r in range(N):
        members = range(r % 2, N, 2)
        want = np.concatenate([ranks.shard(x, 0, m, N) for m in members])
        np.testing.assert_array_equal(outs[r]["subgroup_all_gather.0"], want)
        pairs = {tuple(p) for rec in logs[r]["subgroup_all_gather"]["records"]
                 for p in rec["pairs"]}
        assert pairs == {(members[i], members[(i - 1) % 4]) for i in range(4)}


def _hops(log: dict) -> list:
    """(kind, post index, wait index, computes between them) of each record."""
    ev = log["events"]
    out = []
    for i, rec in enumerate(log["records"]):
        post = ev.index(["post", i])
        wait = ev.index(["wait", i])
        out.append((rec["kind"], post, wait,
                    sum(e[0] == "compute" for e in ev[post + 1:wait])))
    return out


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_hops_post_before_compute_before_wait(runs, case):
    """Every hop of a ring primitive is posted, then the compute that
    overlaps it is issued, then it is waited on: on each of the 8 ranks."""
    _, port, _ = runs
    _, logs = port[N]
    for r in range(N):
        hops = _hops(logs[r][case])
        assert hops, case
        for kind, post, wait, computes in hops:
            assert kind == "collective-permute" and post < wait, (case, r)
            assert computes >= 1, f"{case} rank {r}: a hop with no compute between post and wait"


@pytest.mark.parametrize("case", BLOCKING_CASES)
def test_blocking_baselines_wait_before_any_compute(runs, case):
    """overlap="none" (and a bare halo exchange) waits on each transfer
    before issuing any compute: the transfer sits on the critical path."""
    _, port, _ = runs
    _, logs = port[N]
    for r in range(N):
        hops = _hops(logs[r][case])
        assert hops and all(c == 0 for *_, c in hops), (case, r, hops)


def test_records_count_each_collective_and_its_bytes(runs):
    """The records the roofline reads: kinds, group sizes and per-rank
    bytes of each primitive on 8 ranks and on one."""
    _, port, inputs = runs
    f32 = 4
    xs_blk = inputs["xs"].size // N * f32
    want = {
        "ag_matmul_ring": [("collective-permute", N, xs_blk, xs_blk)] * (N - 1),
        "ag_matmul_none": [("all-gather", N, xs_blk, xs_blk * N)],
        "matmul_rs_none": [("reduce-scatter", N, 32 * 8 * f32, 32 * 8 * f32 // N)],
        "matmul_rs_ring": [("collective-permute", N, 4 * 8 * f32, 4 * 8 * f32)] * (N - 1),
        "halo_exchange": [("collective-permute", N, f32, f32)] * 2,
    }
    for case, recs in want.items():
        got = [(r["kind"], r["group_size"], r["in_bytes"], r["out_bytes"])
               for r in port[N][1][0][case]["records"]]
        assert got == recs, case
    one = port[1][1][0]
    assert [r["kind"] for r in one["ag_matmul_ring"]["records"]] == ["all-gather"]
    assert [(r["kind"], r["group_size"]) for r in one["halo_exchange"]["records"]] == [
        ("collective-permute", 1)] * 2
