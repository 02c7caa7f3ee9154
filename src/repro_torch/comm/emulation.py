"""Bridge between the modeled cluster (α–β) and the real transfer
channels of ``repro_torch.exec``.

The discrete-event simulator charges every message the cluster's wire
latency α; the async executor can *inject* the same α into its channels
(a real sleep per message, pipelined by the progress engine's deadline
heap, exposed inline by the blocking channel).  That makes the measured
wait-for-communication fractions directly comparable with the simulated
ones on a single machine, where the raw memcpy would otherwise be too
fast to need hiding.

``Runtime(..., exec_latency="alpha")`` resolves through
:func:`channel_params_for`.
"""
from __future__ import annotations

from repro_torch.core.timeline import ClusterSpec

__all__ = ["channel_params_for", "resolve_latency"]


def channel_params_for(
    cluster: ClusterSpec, *, scale: float = 1.0, progress_threads: int = 2
) -> dict:
    """Channel emulation parameters for a modeled cluster.

    ``latency`` is the cluster's α (optionally scaled — CI machines can't
    afford 960 × 50 µs of real sleeping at full fidelity, ``scale`` trades
    fidelity for wall-clock).  ``progress_threads`` stands in for the NIC
    serialization resource: transfers' latencies overlap, their data
    movement serializes on these threads.
    """
    return dict(latency=cluster.alpha * scale, progress_threads=progress_threads)


def resolve_latency(spec, cluster: ClusterSpec) -> float:
    """Resolve a Runtime ``exec_latency`` spec: a number is taken as
    seconds; ``"alpha"`` means the modeled cluster's wire latency."""
    if spec == "alpha":
        return channel_params_for(cluster)["latency"]
    return float(spec)
