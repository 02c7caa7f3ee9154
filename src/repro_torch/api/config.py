"""Declarative runtime configuration: frozen config objects replacing the
``Runtime.__init__`` kwarg soup.

Two orthogonal objects describe a run:

* :class:`RuntimeConfig` — *what the arrays look like*: virtual process
  count, distribution block size, fusion, flush threshold, and the
  ``torch.device`` the blocks live on.  These shape the recorded
  dependency graphs.
* :class:`ExecutionPolicy` — *how the graphs are drained*: the flush
  scheduler mode, simulated vs. measured flush backend, the compute
  backend / transfer channel (resolved through
  :mod:`repro_torch.api.registry`), injected wire latency, and the modeled
  :class:`~repro_torch.core.timeline.ClusterSpec`.

Both are frozen dataclasses validated at construction, with a
``.replace()`` that re-validates — so benchmarks and examples sweep
policies declaratively::

    base = ExecutionPolicy(flush="async", channel="async", latency=10e-3)
    for policy in (base, base.replace(channel="blocking")):
        with repro_torch.runtime(policy=policy) as rt:
            ...

:func:`runtime` is the one-call entry point: keyword overrides are
routed to the right config object by field name.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import torch

from repro_torch.core.timeline import ClusterSpec

from . import registry

__all__ = ["RuntimeConfig", "ExecutionPolicy", "ServeConfig", "runtime"]


class _Replaceable:
    """``.replace()`` with validation: construction re-runs
    ``__post_init__``, so an invalid override fails loudly at the call
    site instead of at first flush."""

    def replace(self, **overrides):
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class RuntimeConfig(_Replaceable):
    """Array layout and recording behaviour (graph-shaping knobs)."""

    nprocs: int = 4
    block_size: Union[int, tuple] = 128
    fusion: bool = False
    flush_threshold: int = 200_000
    execute: bool = True
    # where the block store and the payload compute live: None means
    # "cuda" (construction raises when no GPU is visible — there is no
    # CPU fallback); "cpu" runs the plain versions of the kernels
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        if self.nprocs < 1:
            raise ValueError(f"nprocs must be >= 1, got {self.nprocs}")
        if self.flush_threshold < 1:
            raise ValueError(
                f"flush_threshold must be >= 1, got {self.flush_threshold}"
            )
        bs = self.block_size
        sizes = (bs,) if isinstance(bs, int) else tuple(bs)
        if not sizes or any((not isinstance(s, int)) or s < 1 for s in sizes):
            raise ValueError(f"block_size must be positive int(s), got {bs!r}")
        if self.device is not None:
            torch.device(self.device)  # raises on an unknown device string


@dataclass(frozen=True)
class ExecutionPolicy(_Replaceable):
    """How recorded graphs are drained (schedule-shaping knobs).

    Names resolve through the plugin registries — a newly registered
    backend/channel/scheduler is immediately valid here.
    """

    scheduler: str = "latency_hiding"
    flush: str = "sim"  # "sim" (discrete-event model) | "async" (measured)
    backend: str = "torch"  # compute backend (async flush only)
    channel: Optional[str] = None  # transfer channel; default follows scheduler
    latency: Union[float, str] = 0.0  # seconds per message, or "alpha"
    progress_threads: int = 2
    cluster: Optional[ClusterSpec] = None
    # plan-stage pass pipeline: "auto" (default pipeline under the async
    # flush, none under the simulator), a comma-separated string, or a
    # tuple of registered pass names (repro_torch.register_pass)
    passes: Union[str, tuple] = "auto"
    # readback discipline: "demand" drains only the dependency cone of
    # the array being read (futures surface: repro_torch.evaluate / gather /
    # wait), "barrier" drains the whole recorded graph on every readback
    # (the paper's §5.6 semantics — the escape hatch that keeps old
    # programs and all paper figures bit-identical).  "auto" = demand
    # under flush="async", barrier under the simulator.
    sync: str = "auto"
    # lifecycle tracing (repro_torch.obs): False disables (the default — a true
    # no-op), True collects into a ring buffer inspectable via
    # ``Runtime.tracer``, a string additionally exports Chrome-trace JSON
    # to that path when the runtime closes.  REPRO_TRACE=1 (or =path)
    # enables it from the environment without touching the policy.
    trace: Union[bool, str] = False
    # static verification (repro_torch.analysis): "off" trusts the pass
    # pipeline, "plan" proves every flush's planned op list preserves
    # the recorded happens-before order (§5.7) before it executes,
    # "full" additionally runs the region-level race oracle over
    # in-flight concurrent drains.  An error-severity finding raises
    # repro_torch.analysis.VerificationError and aborts the flush.
    # REPRO_VERIFY=plan|full enables it from the environment.
    verify: str = "off"
    # work stealing on the async executor's worker pool (arXiv 1805.01768
    # regime): an idle worker steals from the longest peer queue holding
    # at least ``steal_threshold`` ops, and only when the expected work
    # moved (ops x measured task grain) exceeds ``steal_latency`` — the
    # round-trip cost of a steal.  Disable for strictly owner-computes
    # placement studies.
    steal: bool = True
    steal_threshold: int = 4
    steal_latency: float = 1e-4
    # plan-shape cache (repro_torch.core.plan_cache): replay the recorded
    # rewrite recipe on cones whose canonical structure was planned (and
    # verified) before, skipping the pass pipeline and re-verification.
    # None defers to the REPRO_PLAN_CACHE env var (unset/1 = on,
    # 0/false/off = off); the cache only engages on demand-driven cone
    # flushes with a non-empty pass pipeline.
    plan_cache: Optional[bool] = None
    # cross-tenant cone batching: merge small, mutually non-conflicting
    # planned cones arriving from concurrent submitter threads into one
    # executor submission (one global-lock round and one dispatch sweep
    # for the whole group).  Async flush only.
    batch_cones: bool = False

    def __post_init__(self):
        if self.scheduler not in registry.SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {self.scheduler!r} "
                f"(registered: {', '.join(registry.available_schedulers())})"
            )
        if self.flush not in ("sim", "async"):
            raise ValueError(f"unknown flush {self.flush!r} (sim|async)")
        if self.backend not in registry.BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r} "
                f"(registered: {', '.join(registry.available_backends())})"
            )
        if self.channel is not None and self.channel not in registry.CHANNELS:
            raise ValueError(
                f"unknown channel {self.channel!r} "
                f"(registered: {', '.join(registry.available_channels())})"
            )
        if self.sync not in ("auto", "demand", "barrier"):
            raise ValueError(
                f"unknown sync {self.sync!r} (auto|demand|barrier)"
            )
        if self.verify not in ("off", "plan", "full"):
            raise ValueError(
                f"unknown verify {self.verify!r} (off|plan|full)"
            )
        if isinstance(self.latency, str) and self.latency != "alpha":
            raise ValueError(
                f"latency must be seconds or 'alpha', got {self.latency!r}"
            )
        if self.progress_threads < 1:
            raise ValueError(
                f"progress_threads must be >= 1, got {self.progress_threads}"
            )
        if self.steal_threshold < 2:
            raise ValueError(
                f"steal_threshold must be >= 2 (a victim keeps at least "
                f"one op), got {self.steal_threshold}"
            )
        if self.steal_latency < 0:
            raise ValueError(
                f"steal_latency must be >= 0 seconds, got {self.steal_latency}"
            )
        if not isinstance(self.trace, (bool, str)):
            raise ValueError(
                f"trace must be False, True, or an export path, got "
                f"{self.trace!r}"
            )
        if self.plan_cache not in (None, True, False):
            raise ValueError(
                f"plan_cache must be None (env default), True, or False, "
                f"got {self.plan_cache!r}"
            )
        if not isinstance(self.batch_cones, bool):
            raise ValueError(
                f"batch_cones must be a bool, got {self.batch_cones!r}"
            )
        p = self.passes
        if isinstance(p, (list, tuple)):
            p = tuple(p)
            object.__setattr__(self, "passes", p)  # normalize for hashing
        elif not isinstance(p, str):
            raise ValueError(
                f"passes must be 'auto', a comma-separated string or a "
                f"tuple of pass names, got {p!r}"
            )
        # one parser/validator for pipeline specs: the plan module's
        # (raises ValueError listing the registered passes on a typo)
        from repro_torch.core.plan import resolve_pipeline

        resolve_pipeline(p, self.flush)

    @property
    def resolved_passes(self) -> tuple:
        """The concrete pass pipeline after resolving ``"auto"`` against
        the flush backend (the measured executor gets the default
        coalesce/fuse/batch pipeline, the simulator none)."""
        from repro_torch.core.plan import resolve_pipeline

        return resolve_pipeline(self.passes, self.flush)

    @property
    def resolved_sync(self) -> str:
        """The readback discipline after resolving ``"auto"``: demand-
        driven cone flushes under the measured async backend, the
        paper's whole-graph barrier under the simulator."""
        if self.sync != "auto":
            return self.sync
        return "demand" if self.flush == "async" else "barrier"

    @property
    def resolved_channel(self) -> str:
        """The channel discipline after applying the scheduler default:
        latency-hiding uses the non-blocking progress engine, everything
        else the synchronous baseline."""
        if self.channel is not None:
            return self.channel
        return "async" if self.scheduler == "latency_hiding" else "blocking"


_CONFIG_FIELDS = {f.name for f in dataclasses.fields(RuntimeConfig)}
_POLICY_FIELDS = {f.name for f in dataclasses.fields(ExecutionPolicy)}

@dataclass(frozen=True)
class ServeConfig(_Replaceable):
    """Admission control for the multi-tenant serving runtime
    (:class:`repro_torch.serve.Server`).

    ``max_inflight`` bounds the number of request cones draining
    concurrently on the shared worker pool; ``max_queue`` bounds the
    admission queue — a request arriving with the queue full is shed
    immediately with :class:`repro_torch.serve.AdmissionError` (the clear
    rejection signal; clients retry with backoff).  ``admission_timeout``
    (seconds, ``None`` = wait forever) bounds how long an admitted-queue
    request may wait for an in-flight slot before it too is rejected."""

    max_inflight: int = 8
    max_queue: int = 64
    admission_timeout: Optional[float] = None

    def __post_init__(self):
        if self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {self.max_inflight}"
            )
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")
        if self.admission_timeout is not None and self.admission_timeout <= 0:
            raise ValueError(
                f"admission_timeout must be positive seconds or None, "
                f"got {self.admission_timeout}"
            )


_CONFIG_FIELDS = {f.name for f in dataclasses.fields(RuntimeConfig)}
_POLICY_FIELDS = {f.name for f in dataclasses.fields(ExecutionPolicy)}


def runtime(
    config: Optional[RuntimeConfig] = None,
    policy: Optional[ExecutionPolicy] = None,
    **overrides,
):
    """Build a :class:`~repro_torch.core.engine.Runtime` from config objects —
    the ``with repro_torch.runtime(...):`` entry point.

    Keyword overrides are routed by field name (``nprocs=8`` or
    ``device="cpu"`` patch the :class:`RuntimeConfig`, ``flush="async"`` the
    :class:`ExecutionPolicy`); an unknown name raises immediately with
    the valid fields listed.  The returned ``Runtime`` is a context
    manager; entering it activates it as the thread's current runtime.
    """
    from repro_torch.core.engine import Runtime

    cfg_kw = {k: v for k, v in overrides.items() if k in _CONFIG_FIELDS}
    pol_kw = {k: v for k, v in overrides.items() if k in _POLICY_FIELDS}
    unknown = set(overrides) - _CONFIG_FIELDS - _POLICY_FIELDS
    if unknown:
        raise TypeError(
            f"unknown runtime option(s) {sorted(unknown)} — "
            f"RuntimeConfig fields: {sorted(_CONFIG_FIELDS)}, "
            f"ExecutionPolicy fields: {sorted(_POLICY_FIELDS)}"
        )
    config = (config or RuntimeConfig()).replace(**cfg_kw)
    policy = (policy or ExecutionPolicy()).replace(**pol_kw)
    return Runtime.from_config(config, policy)
