"""Sharding rules: param/batch/state trees → partition specs → DTensor placements.

The port of ``repro.launch.sharding``, with its rules and regexes
unchanged.  The rule system is name-based (leaf key paths) with
**divisibility fallback**: a dim is sharded over an axis group only if
its size divides the group's total size; otherwise that dim's spec entry
degrades to ``None``.  This keeps every (arch × shape × mesh) cell
placeable even where published head/expert counts don't divide the mesh
(yi-34b's 56 heads, grok's 8 experts vs a 16-way model axis) — the
baseline is then conservatively replicated on that dim.

Scheme (mesh axes ``pod``/``data``/``model``):

* FSDP: every ≥2-D parameter shards its *largest eligible* dim over
  ``("pod","data")`` — ZeRO-3 semantics.
* TP over ``model``: attention heads / FFN hidden / MoE experts / vocab
  (unembed).
* Batch over ``("pod","data")``; ``long_500k`` (batch=1) shards the
  sequence dim instead (SP).

Leaf paths are the JAX package's ``keystr`` paths: the port's parameters
and AdamW moments go through ``checkpoint.store.model_tree`` (a
segment's reps and an encoder's blocks as ``Stacked`` leaves with their
leading rep dim), a :class:`~repro_torch.models.model.DecodeState`
through :func:`state_tree`.  A spec is a :class:`P`; a mesh a
``DeviceMesh`` or a mapping of axis name to size (``launch.mesh``).
``shardings`` turns specs into DTensor placements, one a mesh dim.
"""
from __future__ import annotations

import re
from typing import Any, Optional

import numpy as np
from torch.distributed.tensor import Replicate, Shard

from repro_torch.checkpoint.store import Stacked, _map_leaves, model_tree
from repro_torch.optim.adamw import named

from .mesh import axis_names, axis_sizes, dp_axes, fsdp_axes

__all__ = [
    "P",
    "param_specs",
    "batch_specs",
    "state_specs",
    "state_tree",
    "shardings",
    "axis_size",
]


class P(tuple):
    """A partition spec: one entry a tensor dim, each ``None``
    (replicated), a mesh axis name, or a tuple of names (sharded over
    their product, the first major) — ``jax.sharding.PartitionSpec``'s
    meaning."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _is_spec(x) -> bool:
    return isinstance(x, P)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fits(dim: int, mesh, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0 and dim >= axis_size(mesh, axes)


def _clean(spec: list, shape: tuple[int, ...], mesh) -> P:
    """Drop axis assignments that don't divide; dedupe axis reuse."""
    used: set[str] = set()
    out = []
    for d, ax in enumerate(spec):
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        axes = tuple(a for a in axes if a not in used)
        if not axes or not _fits(shape[d], mesh, axes):
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    return P(*out)


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------

# (regex on the leaf path, spec-builder(shape, fsdp) -> list spec)
# Leaf paths look like: "['segs'][0]['0A']['attn']['wq']".
def _param_rule(path: str, shape: tuple[int, ...], fsdp, mesh) -> P:
    nd = len(shape)
    F, M = fsdp, "model"

    def match(*pats):
        return any(re.search(p, path) for p in pats)

    if nd == 0 or all(s == 1 for s in shape):
        return P()

    # --- embeddings -----------------------------------------------------
    # Megatron vocab-parallel: V over model, D UNSHARDED.  Sharding D over
    # the data axis makes the logits matmul contract a data-sharded dim →
    # a full-vocab f32 all-reduce over "data".
    if match(r"\['embed'\]$"):
        return _clean([M, None], shape, mesh)
    if match(r"\['unembed'\]$"):
        return _clean([None, M], shape, mesh)

    # --- attention -------------------------------------------------------
    if match(r"\['attn'\]\['wq'\]", r"\['attn'\]\['wk'\]", r"\['attn'\]\['wv'\]",
             r"\['xattn'\]\['wq'\]", r"\['xattn'\]\['wk'\]", r"\['xattn'\]\['wv'\]"):
        return _clean([F, M], shape[-2:], mesh) if nd == 2 else _stacked([F, M], shape, mesh)
    if match(r"\['attn'\]\['wo'\]", r"\['xattn'\]\['wo'\]"):
        return _clean([M, F], shape[-2:], mesh) if nd == 2 else _stacked([M, F], shape, mesh)
    # MLA
    if match(r"\['attn'\]\['wdkv'\]"):
        return _stacked([F, None], shape, mesh)
    if match(r"\['attn'\]\['wuk'\]", r"\['attn'\]\['wuv'\]"):
        return _stacked([F, M], shape, mesh)

    # --- MLP --------------------------------------------------------------
    if match(r"\['mlp'\]\['w_in'\]", r"\['mlp'\]\['w_gate'\]",
             r"\['shared'\]\['w_in'\]", r"\['shared'\]\['w_gate'\]"):
        return _stacked([F, M], shape, mesh)
    if match(r"\['mlp'\]\['w_out'\]", r"\['shared'\]\['w_out'\]"):
        return _stacked([M, F], shape, mesh)

    # --- MoE ----------------------------------------------------------------
    if match(r"\['moe'\]\['router'\]"):
        return _stacked([F, None], shape, mesh)
    if match(r"\['moe'\]\['w_gate'\]", r"\['moe'\]\['w_in'\]"):
        # experts over model when divisible (EP), else TP inside experts
        E = shape[-3]
        if _fits(E, mesh, M):
            return _stacked([M, F, None], shape, mesh)
        return _stacked([None, F, M], shape, mesh)
    if match(r"\['moe'\]\['w_out'\]"):
        E = shape[-3]
        if _fits(E, mesh, M):
            return _stacked([M, None, F], shape, mesh)
        return _stacked([None, M, F], shape, mesh)

    # --- mamba2 ----------------------------------------------------------
    if match(r"\['mamba'\]\['w_z'\]", r"\['mamba'\]\['w_x'\]"):
        return _stacked([F, M], shape, mesh)  # heads (d_in) over model
    if match(r"\['mamba'\]\['w_out'\]"):
        return _stacked([M, F], shape, mesh)
    if match(r"\['mamba'\]\['conv_x'\]$"):
        return _stacked([None, M], shape, mesh)
    if match(r"\['mamba'\]\['w_B'\]", r"\['mamba'\]\['w_C'\]", r"\['mamba'\]\['w_dt'\]"):
        return _stacked([F, None], shape, mesh)
    if match(r"\['mamba'\]"):  # biases, A_log, D, dt_bias, norm_g, conv_B/C
        if shape[-1] > 1024:  # norm_g / conv_x_b over d_in
            return _stacked([M], shape, mesh, from_end=1)
        return _stacked([None], shape, mesh, from_end=1)

    # --- rwkv6 ----------------------------------------------------------
    if match(r"\['Wr'\]", r"\['Wk'\]", r"\['Wv'\]", r"\['Wg'\]", r"\['Wck'\]"):
        return _stacked([F, M], shape, mesh)
    if match(r"\['Wo'\]", r"\['Wcv'\]"):
        return _stacked([M, F], shape, mesh)
    if match(r"\['Wcr'\]"):
        return _stacked([F, None], shape, mesh)
    if match(r"\['lora_A'\]", r"\['lora_B'\]", r"\['wA'\]", r"\['wB'\]"):
        return _stacked([None, None], shape, mesh)
    if match(r"\['u'\]"):
        return _stacked([M, None], shape, mesh)  # heads over model

    # --- norms / small vectors -------------------------------------------
    if nd >= 2 and shape[-1] * shape[-2] >= 1 << 20:
        return _stacked([F, M], shape, mesh)  # generic big matrix
    return P(*([None] * nd))


def _stacked(tail_spec: list, shape, mesh, from_end: Optional[int] = None) -> P:
    """Apply ``tail_spec`` to the trailing dims (leading dims = scan
    stacking, unsharded)."""
    k = len(tail_spec) if from_end is None else from_end
    lead = [None] * (len(shape) - k)
    return _clean(lead + list(tail_spec), shape, mesh)


def param_specs(params, mesh) -> Any:
    """Spec tree for a model's parameters (an ``nn.Module``, or a dict of
    parameter names to tensors such as AdamW's moments), in the JAX
    package's parameter layout (``model_tree``)."""
    F = fsdp_axes(mesh)
    return _map_leaves(lambda path, leaf: _param_rule(path, tuple(leaf.shape), F, mesh),
                       model_tree(named(params)))


# --------------------------------------------------------------------------
# batch / state rules
# --------------------------------------------------------------------------


def batch_specs(batch, mesh, *, seq_sharded: bool = False) -> Any:
    """tokens/labels [B, S] over dp; modality embeddings [B, T, D] over dp.
    ``seq_sharded`` (long_500k, batch=1): shard S over "data" instead."""
    dp = dp_axes(mesh)

    def rule(_, leaf):
        nd = len(leaf.shape)
        if seq_sharded and nd >= 2:
            return _clean([None, "data"] + [None] * (nd - 2), leaf.shape, mesh)
        if nd == 0:
            return P()
        return _clean([dp] + [None] * (nd - 1), leaf.shape, mesh)

    return _map_leaves(rule, batch)


def state_tree(state) -> dict:
    """A :class:`~repro_torch.models.model.DecodeState` in the JAX
    package's layout: ``{"segs": [...], "pos": ..., "enc_out": ...}``,
    a segment's per-rep states stacked (``Stacked``, the leading reps
    dim) where it has more than one rep."""

    def stack(reps):
        if isinstance(reps[0], dict):
            return {k: stack([r[k] for r in reps]) for k in reps[0]}
        return Stacked(reps)

    tree = {"segs": [reps[0] if len(reps) == 1 else stack(reps) for reps in state.segs],
            "pos": state.pos}
    if state.enc_out is not None:
        tree["enc_out"] = state.enc_out
    return tree


def state_specs(state, mesh, *, seq_axis_candidates=(524288, 32768)) -> Any:
    """Decode-state sharding (``state`` a ``DecodeState``, laid out by
    :func:`state_tree`): batch dim over dp; KV-cache length dim over
    "data" when the batch can't use it (B==1); head-ish dims over model
    when divisible."""
    dp = dp_axes(mesh)
    sizes = axis_sizes(mesh)

    def rule(_, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return P()
        spec: list = [None] * nd
        # find the leading batch dim: "pos" is [B]; seg states have
        # [reps?, B, ...] — reps come from stacking, batch is the first
        # dim that matches the decode batch. Heuristic: shard the first
        # dim that divides dp; if it's 1 (B==1 long-ctx) shard the
        # largest dim over "data" instead (sequence/cache sharding).
        b_dim = None
        for d, s in enumerate(shape):
            if s > 1 and s % axis_size(mesh, dp) == 0:
                b_dim = d
                break
        if b_dim is not None:
            spec[b_dim] = dp
        elif nd >= 2:
            big = int(np.argmax(shape))
            if shape[big] % sizes["data"] == 0 and shape[big] > 1:
                spec[big] = "data"
        # model axis on a trailing head/hidden dim
        for d in range(nd - 1, max(nd - 3, (b_dim if b_dim is not None else -1)), -1):
            if spec[d] is None and shape[d] % sizes["model"] == 0 and shape[d] >= sizes["model"]:
                if d != b_dim:
                    spec[d] = "model"
                    break
        return _clean(spec, shape, mesh)

    return _map_leaves(rule, state_tree(state))


# --------------------------------------------------------------------------
# specs -> placements
# --------------------------------------------------------------------------


def _placements(spec: P, mesh) -> tuple:
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        for a in (() if ax is None else (ax,) if isinstance(ax, str) else ax):
            # a dim over ("pod", "data") is Shard(d) on both mesh dims:
            # pod-major, as the mesh orders them
            out[names.index(a)] = Shard(d)
    return tuple(out)


def shardings(spec_tree, mesh):
    """Each spec of ``spec_tree`` as DTensor placements, one a mesh dim:
    ``Shard(d)`` on each mesh dim the spec assigns to tensor dim d,
    ``Replicate()`` elsewhere."""
    return _map_leaves(lambda _, spec: _placements(spec, mesh), spec_tree, is_leaf=_is_spec)

