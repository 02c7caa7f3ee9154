"""The ranks of ``tests/test_torch_collectives.py``: each rank of a gloo
group runs the port's collectives on its shard of seeded inputs and
saves its outputs and its collective records.

Not a test module (the leading underscore keeps pytest from collecting
it): ``torch.multiprocessing`` imports it by name in every spawned rank.
"""
from __future__ import annotations

import datetime
import json
import os

import numpy as np

# input -> the dim the ranks shard it along (None: replicated), as the
# reference's shard_map in_specs put "x" on that dim
SHARDED = {"x16": 0, "x4x16": 1, "z": 0, "xs": 0, "w": None, "xk": 1, "wk": 0,
           "u": 0, "g8x32": 1, "g": 0, "g64": 0}


def make_inputs(seed: int = 0) -> dict:
    """Seeded inputs of every case, f32 (``g64`` f64)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "x16": normal(16, 4), "x4x16": normal(4, 16), "z": normal(64, 8),
        "xs": normal(32, 16), "w": normal(16, 8), "xk": normal(32, 64), "wk": normal(64, 8),
        "u": normal(64), "g8x32": normal(8, 32), "g": normal(32, 16),
        "g64": rng.standard_normal((32, 16)),
    }


def shard(a: np.ndarray, dim, rank: int, n: int) -> np.ndarray:
    if dim is None:
        return a
    size = a.shape[dim] // n
    return np.take(a, np.arange(rank * size, (rank + 1) * size), axis=dim)


def point(left, center, right):
    """The 3-point stencil of ``tests/test_collectives.py``."""
    return 0.25 * left + 0.5 * center + 0.25 * right


def cases(col, a) -> dict:
    """name -> zero-argument call of the port on this rank's shards ``a``
    (torch tensors) over the default group; each returns a tensor or a
    tuple of tensors."""
    return {
        "ring_all_gather": lambda: col.ring_all_gather(a["x16"], None),
        "ring_all_gather_axis1": lambda: col.ring_all_gather(a["x4x16"], None, axis=1),
        "ring_reduce_scatter": lambda: col.ring_reduce_scatter(a["z"], None, axis=0),
        "ring_reduce_scatter_lazy": lambda: col.ring_reduce_scatter(
            lambda c: a["z"][c:c + 1] * 0.5, None, axis=0),
        "ag_matmul_ring": lambda: col.ag_matmul(a["xs"], a["w"], None, gather_axis=0),
        "ag_matmul_none": lambda: col.ag_matmul(a["xs"], a["w"], None, overlap="none",
                                                gather_axis=0),
        "matmul_rs_ring": lambda: col.matmul_rs(a["xk"], a["wk"], None, scatter_axis=0),
        "matmul_rs_none": lambda: col.matmul_rs(a["xk"], a["wk"], None, overlap="none",
                                                scatter_axis=0),
        "halo_exchange": lambda: col.halo_exchange(a["u"], None),
        "halo_exchange_periodic": lambda: col.halo_exchange(a["u"], None, periodic=True),
        "halo_exchange_axis1": lambda: col.halo_exchange(a["g8x32"], None, halo=2, axis=1),
        "stencil_1d_ring": lambda: col.stencil_1d_sharded(a["u"], None, point),
        "stencil_1d_none": lambda: col.stencil_1d_sharded(a["u"], None, point, overlap="none"),
        "stencil_1d_periodic": lambda: col.stencil_1d_sharded(a["u"], None, point,
                                                              periodic=True),
        "jacobi_ring": lambda: col.jacobi_step_sharded(a["g"], None),
        "jacobi_none": lambda: col.jacobi_step_sharded(a["g"], None, overlap="none"),
        "jacobi_f64_ring": lambda: col.jacobi_step_sharded(a["g64"], None),
        "jacobi_f64_none": lambda: col.jacobi_step_sharded(a["g64"], None, overlap="none"),
    }


def _log_json(log) -> dict:
    index = {id(r): i for i, r in enumerate(log.records)}
    return {
        "records": [dict(kind=r.kind, group_size=r.group_size, in_bytes=r.in_bytes,
                         out_bytes=r.out_bytes, pairs=[list(p) for p in r.pairs])
                    for r in log.records],
        "events": [[ev, index[id(x)]] if ev in ("post", "wait") else [ev, x]
                   for ev, x in log.events],
    }


def run_rank(rank: int, n: int, store_path: str, in_path: str, out_dir: str) -> None:
    """One rank: every case of ``cases`` on the world group under a
    recorder, then ``ring_all_gather`` on the subgroup of this rank's
    parity (ranks 0, 2, 4, ... and 1, 3, 5, ...: group ranks are not
    global ranks); saves ``rank{rank}.npz`` and ``rank{rank}.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.comm import collectives as col

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n), rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=60))
    try:
        inputs = dict(np.load(in_path))
        a = {k: torch.from_numpy(shard(v, SHARDED[k], rank, n)) for k, v in inputs.items()}
        outs, logs = {}, {}
        for name, call in cases(col, a).items():
            with col.record_collectives() as log:
                got = call()
            got = got if isinstance(got, tuple) else (got,)
            for i, t in enumerate(got):
                outs[f"{name}.{i}"] = t.numpy()
            logs[name] = _log_json(log)
        if n > 1:
            groups = [dist.new_group(list(range(p, n, 2))) for p in (0, 1)]
            mine = groups[rank % 2]
            with col.record_collectives() as log:
                outs["subgroup_all_gather.0"] = col.ring_all_gather(a["x16"], mine).numpy()
            logs["subgroup_all_gather"] = _log_json(log)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **outs)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(logs, f)
    finally:
        dist.destroy_process_group()
