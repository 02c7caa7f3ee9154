"""repro_torch.analysis — static analysis over recorded graphs.

Only the footprint snapshots are ported so far: the plan-shape cache
keeps an immutable :class:`OpView` snapshot of every cone it records.
The rules (plan verifier, race oracle, deadlock detection) and
``check`` are a later slice (ROADMAP); until then
``ExecutionPolicy(verify="plan"|"full")`` raises ``NotImplementedError``.
"""
from .footprint import OpView, resolve_positions, snapshot_ops

__all__ = ["OpView", "resolve_positions", "snapshot_ops"]
