"""Roofline terms of one step, counted as it runs (the dry-run's fake tensors).

    T_compute = FLOPs / peak
    T_memory  = bytes accessed / HBM_bw
    T_coll    = Σ_class wire_bytes / link_bw_class

The port of ``repro.roofline.analysis``.  The reference reads a compiled
XLA artifact (``cost_analysis()``, ``memory_analysis()`` and the
post-partitioning HLO text); the port has none, so ``analyze_step`` runs
the step once and counts what it dispatches:

* FLOPs by ``torch.utils.flop_counter.FlopCounterMode``, plus the work
  of each hand-written kernel the step reaches (``repro_torch.kernels
  .fake_launch``), which no aten op shows;
* bytes accessed by a dispatch mode that sums every op's operand and
  output bytes (the counterpart of XLA's "bytes accessed"; views and
  allocations move none);
* the peak bytes of live storages: storages, not views, so a view or an
  in-place update adds nothing;
* collective wire bytes from the records of ``repro_torch.comm``, with
  the reference's per-algorithm ring wire factors:

    all-gather      (g-1)/g × output_bytes   per participating device-group
    reduce-scatter  (g-1)/g × input_bytes
    all-reduce      2(g-1)/g × buffer_bytes
    all-to-all      (g-1)/g × buffer_bytes
    collective-permute  full buffer_bytes

Device-groups of size 2 on the multi-pod mesh are the "pod" (DCI) axis —
they get the slower link class.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from dataclasses import dataclass, field, fields, is_dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.comm.collectives import record_collectives
from repro_torch.kernels import is_fake, kernel_costs

__all__ = [
    "HW",
    "CollectiveStats",
    "collective_bytes",
    "analyze_step",
    "roofline_terms",
    "model_flops",
]


@dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM (80 GB HBM3) constants, per card."""

    peak_flops: float = 989e12  # bf16 dense tensor cores, NVIDIA H100 data sheet
    hbm_bw: float = 3.35e12  # B/s HBM3, NVIDIA H100 data sheet
    ici_bw: float = 450e9  # B/s NVLink 4 to the host's other cards, each way (900 GB/s both)
    # B/s across hosts: an assumption, one 400 Gb/s NDR InfiniBand adapter a card
    dci_bw: float = 50e9
    hbm_bytes: float = 80e9  # capacity, NVIDIA H100 data sheet


@dataclass
class CollectiveStats:
    # wire bytes PER DEVICE, by link class
    ici_bytes: float = 0.0
    dci_bytes: float = 0.0
    by_kind: dict = field(default_factory=dict)
    n_ops: int = 0

    def add(self, kind: str, wire: float, dci: bool):
        self.n_ops += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + wire
        if dci:
            self.dci_bytes += wire
        else:
            self.ici_bytes += wire


def collective_bytes(records, *, n_devices: int, pod_group_size: int = 2) -> CollectiveStats:
    """Per-device wire bytes of ``records`` (``repro_torch.comm``'s
    :class:`~repro_torch.comm.collectives.CollectiveRecord`, each with the
    per-rank bytes the reference reads off an HLO line's shapes)."""
    stats = CollectiveStats()
    for rec in records:
        kind = rec.kind
        if kind == "collective-permute":
            if all(a == b for a, b in rec.pairs):
                continue  # every rank its own peer: a local copy, no wire
            # permutes on the pod axis pair across 256-boundaries;
            # treat as ICI unless the pairs jump by >= 256
            dci = any(abs(a - b) >= 256 for a, b in rec.pairs)
            stats.add(kind, rec.in_bytes, dci)
            continue
        g = rec.group_size
        if g <= 1:
            continue
        frac = (g - 1) / g
        # per-device bytes: AG sends the local shard g-1 times = (g-1) ×
        # in_b = frac × out_b (out = g × in); RS symmetric; AR = AG+RS.
        if kind == "all-gather":
            wire = frac * rec.out_bytes
        elif kind == "reduce-scatter":
            wire = frac * rec.in_bytes
        elif kind == "all-to-all":
            wire = frac * max(rec.in_bytes, rec.out_bytes)
        else:  # all-reduce
            wire = 2 * frac * rec.in_bytes
        dci = g == pod_group_size and n_devices > 256
        stats.add(kind, wire, dci)
    return stats


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (inference) per step, N = active params."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_active * tokens


# ---------------------------------------------------------------------------
# counting a step
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops that allocate and read or write nothing
_ALLOCATIONS = {_aten.empty.memory_format, _aten.empty_strided.default,
                _aten.empty_like.default, _aten.new_empty.default,
                _aten.new_empty_strided.default}
# ops whose output shape depends on the data, which a fake tensor does
# not hold: counted at their most (nonzero: every element kept)
_DATA_DEPENDENT = {_aten.nonzero.default}


def _tensors(obj):
    """Every tensor in ``obj``: a module's parameters and buffers, the
    fields of a dataclass or named tuple, the items of a dict, list or
    tuple."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif is_dataclass(obj) and not isinstance(obj, type):
        for f in fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """Sums every dispatched op's operand and output bytes (an op that
    returns no tensor only reads metadata), and tracks the
    live bytes of the storages the step holds: a storage counts from the
    op that makes it until it is freed (a weak reference's callback)."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.n_ops = 0
        self.data_dependent_ops = 0
        self.live = self.peak = 0
        self._held: dict = {}  # id(storage) -> weak reference

    def hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live (once); returns its bytes."""
        st = t.untyped_storage()
        if id(st) in self._held:
            return 0
        nb = st.nbytes()
        self._held[id(st)] = weakref.ref(st, functools.partial(self._freed, id(st), nb))
        self.live += nb
        self.peak = max(self.peak, self.live)
        return nb

    def _freed(self, key: int, nb: int, _ref) -> None:
        self._held.pop(key, None)
        self.live -= nb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _DATA_DEPENDENT and is_fake(args[0]):
            x = args[0]
            self.data_dependent_ops += 1
            out = torch.empty((x.numel(), x.dim()), dtype=torch.long, device=x.device)
        else:
            out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:  # a query of metadata (prim.device, sym_size): no traffic
            return out
        self.n_ops += 1
        if not func.is_view and func not in _ALLOCATIONS:
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self.hold(t)
        return out


def analyze_step(fn, *args, n_devices: int = 1) -> dict:
    """Run ``fn(*args)`` once and count it: the counterpart of the
    reference's ``analyze_compiled``.  On fake tensors (``FakeTensorMode``)
    it runs in the mode they belong to, so a full-size step allocates
    nothing; the reference's keys where their meaning carries over
    (``coll_ici_bytes``, ``coll_dci_bytes``, ``coll_by_kind``,
    ``coll_ops``, ``memory``), and ``flops`` / ``bytes_accessed`` where it
    has ``hlo_flops`` / ``hlo_bytes``.

    ``memory`` holds the bytes of the arguments' storages, of the
    outputs' storages that are not the arguments', and the peak of live
    storages (arguments included) while the step ran, with ``temp`` the
    peak less the arguments."""
    arg_tensors = list(_tensors(args))
    fake = next((t.fake_mode for t in arg_tensors if hasattr(t, "fake_mode")), None)
    counter = _Counter()
    flop_counter = FlopCounterMode(display=False)
    with contextlib.ExitStack() as stack:
        if fake is not None and torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not fake:
            stack.enter_context(fake)
        log = stack.enter_context(record_collectives())
        kernels = stack.enter_context(kernel_costs())
        stack.enter_context(flop_counter)
        arg_bytes = sum(counter.hold(t) for t in arg_tensors)
        stack.enter_context(counter)
        out = fn(*args)
    arg_ids = {id(t.untyped_storage()) for t in arg_tensors}
    out_bytes = 0
    for t in _tensors(out):
        st = t.untyped_storage()
        if id(st) not in arg_ids:
            arg_ids.add(id(st))
            out_bytes += st.nbytes()
    coll = collective_bytes(log.records, n_devices=n_devices)
    kernel_flops = sum(f for _, f, _ in kernels)
    launches: dict = {}
    for name, _, _ in kernels:
        launches[name] = launches.get(name, 0) + 1
    return {
        "flops": float(flop_counter.get_total_flops()) + kernel_flops,
        "bytes_accessed": float(counter.bytes_accessed + sum(b for *_, b in kernels)),
        "kernel_flops": kernel_flops,
        "kernel_launches": launches,
        "n_ops": counter.n_ops,
        "data_dependent_ops": counter.data_dependent_ops,
        "coll_ici_bytes": coll.ici_bytes,
        "coll_dci_bytes": coll.dci_bytes,
        "coll_by_kind": coll.by_kind,
        "coll_ops": coll.n_ops,
        "memory": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "peak_size_in_bytes": counter.peak,
            "temp_size_in_bytes": counter.peak - arg_bytes,
        },
    }


def roofline_terms(analysis: dict, *, n_devices: int, hw: HW = HW()) -> dict:
    """The three terms in seconds + the dominant bottleneck.

    ``analyze_step`` counts the step one device runs (one rank's share),
    so each term divides by the per-card rate directly, NOT by cards
    again.  Collective wire bytes from the records are likewise
    per-device.
    """
    t_compute = analysis["flops"] / hw.peak_flops
    t_memory = analysis["bytes_accessed"] / hw.hbm_bw
    t_coll = (
        analysis["coll_ici_bytes"] / hw.ici_bw
        + analysis["coll_dci_bytes"] / hw.dci_bw
    )
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    frac = t_compute / bound if bound > 0 else 0.0
    return {
        **{f"t_{k}": v for k, v in terms.items()},
        "dominant": dom,
        "roofline_fraction": frac,  # compute-term share of the bound
    }
