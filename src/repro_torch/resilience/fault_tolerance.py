"""Fault tolerance for 1000+-node runs.

The port's copy of ``repro.resilience.fault_tolerance`` (host-side and
NumPy only; its code unchanged).

Components (all host-side; they orchestrate, XLA executes):

* :class:`ClusterMonitor` — heartbeat table with failure detection
  (deadline-based, like the TPU pod coordinator).  Hosts report
  heartbeats; ``failed()`` returns hosts past the deadline.
* :class:`ElasticPlan` — given the surviving host set, recompute the data
  sharding (which host reads which batch rows) and the mesh shape to
  restart with.  Because the data pipeline is a pure function of
  ``(seed, step, host)`` and checkpoints are sharded by leaf (not by
  host), *any* surviving subset can resume from the latest checkpoint —
  this is the elastic-rescale path.
* :class:`StragglerTracker` — per-step deadline tracking; hosts whose
  step time is persistently above ``threshold × median`` are flagged for
  eviction (which feeds the elastic plan).  In-step mitigation on TPU is
  XLA's domain; at the framework level eviction-and-rescale is the
  effective lever.
* :class:`TrainSupervisor` — the restart policy glue used by
  ``launch/train.py``: run steps, checkpoint every N, on failure restore
  the latest checkpoint with the surviving hosts and continue.  The unit
  tests drive it with injected failures.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

__all__ = [
    "HostState",
    "ClusterMonitor",
    "ElasticPlan",
    "StragglerTracker",
    "TrainSupervisor",
]


@dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    alive: bool = True
    step_times: list = field(default_factory=list)


class ClusterMonitor:
    """Deadline-based failure detector over a heartbeat table."""

    def __init__(self, n_hosts: int, *, deadline: float = 30.0, clock=time.monotonic):
        self.deadline = deadline
        self.clock = clock
        now = clock()
        self.hosts = {h: HostState(h, now) for h in range(n_hosts)}

    def heartbeat(self, host_id: int, t: Optional[float] = None) -> None:
        hs = self.hosts[host_id]
        hs.last_heartbeat = self.clock() if t is None else t
        hs.alive = True

    def failed(self) -> list[int]:
        now = self.clock()
        out = []
        for hs in self.hosts.values():
            if hs.alive and now - hs.last_heartbeat > self.deadline:
                hs.alive = False
            if not hs.alive:
                out.append(hs.host_id)
        return sorted(out)

    def alive(self) -> list[int]:
        dead = set(self.failed())
        return sorted(h for h in self.hosts if h not in dead)

    def evict(self, host_id: int) -> None:
        self.hosts[host_id].alive = False


@dataclass(frozen=True)
class ElasticPlan:
    """Re-sharding plan for a surviving host set."""

    hosts: tuple[int, ...]  # surviving physical host ids, sorted
    n_hosts: int  # len(hosts)
    rank_of: dict  # physical host -> new contiguous rank
    global_batch: int
    rows_per_host: int

    @staticmethod
    def make(surviving: list[int], global_batch: int) -> "ElasticPlan":
        hosts = tuple(sorted(surviving))
        n = len(hosts)
        if n == 0:
            raise RuntimeError("no surviving hosts")
        # keep the global batch; if it no longer divides, shrink to the
        # largest multiple (documented drop — determinism preserved)
        rows = global_batch // n
        if rows == 0:
            raise RuntimeError("more hosts than batch rows")
        return ElasticPlan(
            hosts=hosts,
            n_hosts=n,
            rank_of={h: i for i, h in enumerate(hosts)},
            global_batch=rows * n,
            rows_per_host=rows,
        )

    def mesh_shape(self, model_parallel: int) -> tuple[int, int]:
        """(data, model) mesh for the survivors; model parallelism is kept,
        data parallelism shrinks."""
        chips = self.n_hosts  # 1 logical chip group per host here
        if chips % model_parallel == 0:
            return (chips // model_parallel, model_parallel)
        return (chips, 1)


class StragglerTracker:
    """Flags hosts whose step time is persistently above
    ``threshold × median`` over a sliding window."""

    def __init__(self, n_hosts: int, *, threshold: float = 2.0, window: int = 8, patience: int = 3):
        self.threshold = threshold
        self.window = window
        self.patience = patience
        self.times: dict[int, list[float]] = {h: [] for h in range(n_hosts)}
        self.strikes: dict[int, int] = {h: 0 for h in range(n_hosts)}

    def record(self, host_id: int, step_time: float) -> None:
        ts = self.times[host_id]
        ts.append(step_time)
        if len(ts) > self.window:
            ts.pop(0)

    def evaluate(self) -> list[int]:
        """Returns hosts to evict (persistent stragglers)."""
        med = np.median([np.median(t) for t in self.times.values() if t] or [0.0])
        if med <= 0:
            return []
        out = []
        for h, ts in self.times.items():
            if ts and np.median(ts) > self.threshold * med:
                self.strikes[h] += 1
            else:
                self.strikes[h] = 0
            if self.strikes[h] >= self.patience:
                out.append(h)
        return sorted(out)


class TrainSupervisor:
    """Checkpoint/restart + elastic-rescale policy loop.

    ``step_fn(state, step, plan) -> state`` runs one training step and may
    raise ``HostFailure`` (injected in tests, real pod: NCCL/ICI error).
    ``save_fn(state, step)`` / ``restore_fn() -> (state, step)`` plug the
    checkpoint manager.  ``on_rescale(plan)`` lets the caller rebuild
    meshes/pipelines for the new host set.
    """

    class HostFailure(RuntimeError):
        def __init__(self, host_id: int):
            super().__init__(f"host {host_id} failed")
            self.host_id = host_id

    def __init__(
        self,
        *,
        n_hosts: int,
        global_batch: int,
        step_fn: Callable,
        save_fn: Callable,
        restore_fn: Callable,
        checkpoint_every: int = 100,
        on_rescale: Optional[Callable] = None,
        max_restarts: int = 8,
    ):
        self.monitor = ClusterMonitor(n_hosts)
        self.global_batch = global_batch
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.checkpoint_every = checkpoint_every
        self.on_rescale = on_rescale
        self.max_restarts = max_restarts
        self.restarts = 0
        self.plan = ElasticPlan.make(list(range(n_hosts)), global_batch)

    def run(self, state, start_step: int, n_steps: int):
        step = start_step
        while step < start_step + n_steps:
            try:
                state = self.step_fn(state, step, self.plan)
                step += 1
                if step % self.checkpoint_every == 0:
                    self.save_fn(state, step)
            except self.HostFailure as f:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                self.monitor.evict(f.host_id)
                self.plan = ElasticPlan.make(self.monitor.alive(), self.global_batch)
                if self.on_rescale is not None:
                    self.on_rescale(self.plan)
                state, step = self.restore_fn()
        return state, step
