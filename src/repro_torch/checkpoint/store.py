"""Sharded checkpoint store with async save, atomic commit and keep-N GC.

The port of ``repro.checkpoint.store``, on the same on-disk format, so a
directory written by either package restores in the other:

* **One file per host-shard** — every host serializes only the leaves it
  owns (round-robin by leaf index).
* **Atomic commit** — shards are written to ``step_N.tmp/``; a manifest
  (leaf names, shapes, dtypes, integrity checksums) is written last and
  the directory is atomically renamed to ``step_N/``.  A crash mid-save
  never corrupts the latest valid checkpoint.
* **Async save** — ``save`` copies every leaf to the host before it
  returns, and serializes the copies on a background thread, so a train
  step that updates the parameters in place right after cannot race the
  write.
* **keep-N GC** — old steps are deleted after a successful commit.

Format: per leaf ``RPRC\\x01``, a JSON header (dtype name, shape, zlib
CRC of the raw bytes) and the raw bytes.  A tree is nested dicts (keys
in sorted order), lists, tuples and named tuples; leaves are named as
``jax.tree_util.keystr`` names them (``[0]['embed']``, ``[1].mu['x']``)
and ``None`` holds no leaf, as in JAX.  Leaves are torch tensors, numpy
arrays, Python scalars or :class:`Stacked` groups.  bf16 leaves travel
as their bits (a ``torch.uint16`` view) under the dtype name
``bfloat16``: nothing here needs ``ml_dtypes``.

``model_tree`` gives the port's parameters (or anything named like them,
such as AdamW's moments) in the JAX package's parameter layout, so a
training checkpoint of either package restores into the other's model.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import zlib
from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_checkpoint", "restore_latest", "Stacked", "model_tree"]

_MAGIC = b"RPRC\x01"
_BF16 = "bfloat16"


class Stacked:
    """Tensors of one shape that the JAX package stacks along a leading
    axis (a segment's reps, an encoder's blocks): one leaf on disk.  Its
    snapshot stacks host copies; a restore writes each part in place."""

    def __init__(self, parts):
        self.parts = tuple(parts)
        self.shape = (len(self.parts), *self.parts[0].shape)
        self.dtype = self.parts[0].dtype


def model_tree(named: Mapping[str, torch.Tensor]) -> dict:
    """The tensors of ``named`` (keyed by the port's parameter names) in
    the JAX package's parameter tree: ``segs.{i}.{r}.{key}.…`` becomes
    ``['segs'][i][key]…``, stacked over the reps r where the segment has
    more than one, ``encoder.blocks.{l}.…`` ``['encoder']['blocks']…``
    stacked over the layers l, everything else nested by its dotted
    name."""
    tree: dict = {}
    groups: dict = {}  # leaf path -> {rep or layer: tensor}
    always = set()  # the encoder's paths: stacked even over one layer

    def put(path, value):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value

    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "segs":
            key = ("segs", int(parts[1]), *parts[3:])
            groups.setdefault(key, {})[int(parts[2])] = t
        elif parts[:2] == ["encoder", "blocks"]:
            key = ("encoder", "blocks", *parts[3:])
            always.add(key)
            groups.setdefault(key, {})[int(parts[2])] = t
        else:
            put(parts, t)
    for path, by_index in groups.items():
        parts = [by_index[i] for i in sorted(by_index)]
        put(path, Stacked(parts) if path in always or len(parts) > 1 else parts[0])
    if "segs" in tree:
        segs = tree["segs"]
        tree["segs"] = [segs[i] for i in range(len(segs))]
    return tree


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple)) or isinstance(x, Stacked)


def _leaf_paths(tree, prefix: str = "", is_leaf=None) -> list[tuple[str, Any]]:
    """(keystr name, leaf) pairs in JAX's flattening order; ``is_leaf``,
    as JAX's, marks further leaves (a tuple type that is one)."""
    if tree is None:
        return []
    if _is_leaf(tree) or (is_leaf is not None and is_leaf(tree)):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif hasattr(tree, "_fields"):  # a named tuple
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    else:
        items = [(f"[{i}]", x) for i, x in enumerate(tree)]
    return [pair for key, sub in items for pair in _leaf_paths(sub, prefix + key, is_leaf)]


def _map_leaves(fn, tree, prefix: str = "", is_leaf=None):
    """``tree`` with each leaf replaced by ``fn(name, leaf)`` (``is_leaf``
    as in ``_leaf_paths``)."""
    if tree is None:
        return None
    if _is_leaf(tree) or (is_leaf is not None and is_leaf(tree)):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], prefix + f"[{k!r}]", is_leaf) for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, getattr(tree, f), prefix + f".{f}", is_leaf)
                            for f in tree._fields))
    return type(tree)(_map_leaves(fn, x, prefix + f"[{i}]", is_leaf)
                      for i, x in enumerate(tree))


def _to_host(leaf) -> tuple[str, np.ndarray]:
    """(dtype name, numpy array of the raw values): a copy on the host."""
    if isinstance(leaf, Stacked):
        leaf = torch.stack([p.detach().to("cpu") for p in leaf.parts])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return _BF16, t.view(torch.uint16).numpy()
        return str(t.numpy().dtype), t.numpy()
    arr = np.array(leaf)  # a copy
    return str(arr.dtype), arr


def _write_leaf(fh, dtype: str, arr: np.ndarray) -> dict:
    raw = np.ascontiguousarray(arr).tobytes()
    crc = zlib.crc32(raw)
    hdr = json.dumps({"dtype": dtype, "shape": list(arr.shape), "crc": crc}).encode()
    fh.write(_MAGIC)
    fh.write(struct.pack("<I", len(hdr)))
    fh.write(hdr)
    fh.write(struct.pack("<Q", len(raw)))
    fh.write(raw)
    return {"dtype": dtype, "shape": list(arr.shape), "crc": crc}


def _read_leaf(fh) -> tuple[str, np.ndarray]:
    """(dtype name, array): a bf16 leaf's array holds its bits as uint16."""
    magic = fh.read(5)
    if magic != _MAGIC:
        raise IOError(f"bad leaf magic {magic!r}")
    (hlen,) = struct.unpack("<I", fh.read(4))
    hdr = json.loads(fh.read(hlen))
    (rlen,) = struct.unpack("<Q", fh.read(8))
    raw = fh.read(rlen)
    if zlib.crc32(raw) != hdr["crc"]:
        raise IOError("checkpoint leaf CRC mismatch")
    dt = np.uint16 if hdr["dtype"] == _BF16 else np.dtype(hdr["dtype"])
    return hdr["dtype"], np.frombuffer(raw, dtype=dt).reshape(hdr["shape"])


def _as_tensor(dtype: str, arr: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(arr.copy())
    return t.view(torch.bfloat16) if dtype == _BF16 else t


@torch.no_grad()
def _restore_leaf(like, dtype: str, arr: np.ndarray):
    if isinstance(like, Stacked):
        src = _as_tensor(dtype, arr).reshape(like.shape)
        for part, value in zip(like.parts, src):
            part.copy_(value)
        return like
    if isinstance(like, torch.Tensor):
        return like.copy_(_as_tensor(dtype, arr).reshape(like.shape))
    if hasattr(like, "dtype"):
        if dtype == _BF16:
            arr = _as_tensor(dtype, arr).float().numpy()
        return np.asarray(arr).astype(like.dtype).reshape(like.shape)
    return arr


class CheckpointManager:
    def __init__(
        self,
        directory: str | Path,
        *,
        keep: int = 3,
        shard_id: int = 0,
        n_shards: int = 1,
        is_primary: Optional[bool] = None,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.is_primary = (shard_id == 0) if is_primary is None else is_primary
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        """Copy ``tree``'s leaves to the host now and serialize the copies
        asynchronously.  Raises any error from the *previous* async save."""
        self.wait()  # one in-flight save at a time; surfaces prior errors
        snapshot = [(name, *_to_host(leaf)) for name, leaf in _leaf_paths(tree)]

        def work():
            try:
                self._write(step, snapshot)
            except BaseException as e:  # pragma: no cover
                self._error = e

        if blocking:
            work()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _write(self, step: int, snapshot) -> None:
        tmp = self.dir / f"step_{step:012d}.tmp"
        final = self.dir / f"step_{step:012d}"
        tmp.mkdir(parents=True, exist_ok=True)
        # this host writes its assigned leaves (round-robin by index)
        manifest = {"step": step, "n_shards": self.n_shards, "leaves": {}}
        with open(tmp / f"shard_{self.shard_id:05d}.bin", "wb") as fh:
            for i, (name, dtype, arr) in enumerate(snapshot):
                if i % self.n_shards != self.shard_id:
                    continue
                meta = _write_leaf(fh, dtype, arr)
                manifest["leaves"][name] = {"index": i, **meta}
        with open(tmp / f"manifest_{self.shard_id:05d}.json", "w") as fh:
            json.dump(manifest, fh)
        # commit: all shards present (single-process tests write them all
        # into the same tmp dir; on a pod a barrier precedes the rename)
        done = len(list(tmp.glob("manifest_*.json")))
        if done >= self.n_shards and self.is_primary:
            os.replace(tmp, final)
            self._gc()

    def _gc(self) -> None:
        steps = sorted(self._steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:012d}", ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    # -- restore ------------------------------------------------------------
    def _steps(self) -> list[int]:
        return [
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if p.is_dir() and not p.name.endswith(".tmp")
        ]

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return max(steps) if steps else None

    def restore(self, tree_like, step: Optional[int] = None):
        """Restore into the structure of ``tree_like``; returns (tree, step).
        A tensor leaf (or :class:`Stacked` group) of ``tree_like`` gets the
        saved values in place, cast to its dtype, and is returned; a
        numpy leaf gives a new array of its dtype and shape."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:012d}"
        names = [name for name, _ in _leaf_paths(tree_like)]
        by_name: dict[str, tuple[str, np.ndarray]] = {}
        for mf in sorted(d.glob("manifest_*.json")):
            manifest = json.loads(mf.read_text())
            shard = mf.name.replace("manifest", "shard").replace(".json", ".bin")
            with open(d / shard, "rb") as fh:
                for name in sorted(
                    manifest["leaves"], key=lambda n: manifest["leaves"][n]["index"]
                ):
                    by_name[name] = _read_leaf(fh)
        missing = [n for n in names if n not in by_name]
        if missing:
            raise IOError(f"checkpoint {d} missing leaves: {missing[:5]}...")
        return _map_leaves(lambda n, like: _restore_leaf(like, *by_name[n]), tree_like), step


def save_checkpoint(directory, step: int, tree, **kw) -> None:
    CheckpointManager(directory, **kw).save(step, tree, blocking=True)


def restore_latest(directory, tree_like, **kw):
    return CheckpointManager(directory, **kw).restore(tree_like)
