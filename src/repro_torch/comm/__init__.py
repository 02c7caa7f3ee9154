"""repro_torch.comm — the bridge between the modeled cluster and the
real transfer channels.

Only :mod:`~repro_torch.comm.emulation` is ported so far; the sharded
collectives on ``torch.distributed`` are a later slice (ROADMAP).
"""
from .emulation import channel_params_for, resolve_latency

__all__ = ["channel_params_for", "resolve_latency"]
