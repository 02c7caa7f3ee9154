"""String-keyed plugin registries for the runtime's pluggable pieces.

Four registries, one per extension point:

* **backends** — compute backends executing operation payloads against
  block storage (``repro_torch.exec.backend``: ``"torch"``).  An entry
  is a factory ``fn(storage, scratch) -> ComputeBackend``.
* **channels** — transfer-channel disciplines (``repro_torch.exec.channels``:
  ``"async"``, ``"blocking"``).  An entry is a factory ``fn(*,
  latency, progress_threads) -> channel``.
* **schedulers** — flush scheduling modes for the discrete-event
  simulator (``repro_torch.core.scheduler``: ``"latency_hiding"``,
  ``"blocking"``).  An entry is a callable ``fn(deps, cluster,
  executor=None) -> TimelineResult``.
* **passes** — plan-stage graph passes run over the recorded operation
  list before scheduling (``repro_torch.core.plan``: ``"coalesce"``,
  ``"batch"``; ``repro_torch.core.fusion``: ``"fuse"``).  An entry is a
  callable ``fn(ctx: PlanContext) -> None`` that rewrites ``ctx.ops``
  in place and/or sets executor hints — see ``docs/architecture.md``
  for the contract (a pass must preserve the relative program order of
  every pair of conflicting accesses it keeps).
* **rules** — static-analysis rules run by :func:`repro_torch.analysis.check`
  over recorded/planned graphs (``repro_torch.analysis.rules``: ``"plan"``,
  ``"races"``, ``"deadlock"``).  An entry is a callable ``fn(ctx:
  AnalysisContext) -> None`` that appends
  :class:`~repro_torch.analysis.Diagnostic` objects to ``ctx.diagnostics``.

Registration replaces the old ``make_backend`` / ``make_channel``
if-else ladders: a new transport or an autotuned backend plugs in with
one ``register_*`` call and is immediately selectable by name from
:class:`~repro_torch.api.config.ExecutionPolicy`, ``Runtime(...)`` kwargs,
and the benchmark drivers — no factory code changes.

This module imports nothing from the rest of the package (it sits at
the bottom of the import graph); the built-in entries register
themselves when their defining modules import, and ``get_*`` /
``available_*`` lazily import those modules so lookups never depend on
import order.
"""
from __future__ import annotations

import importlib
from typing import Callable, Iterator, Optional

__all__ = [
    "Registry",
    "register_backend",
    "get_backend",
    "available_backends",
    "register_channel",
    "get_channel",
    "available_channels",
    "register_scheduler",
    "get_scheduler",
    "available_schedulers",
    "register_pass",
    "get_pass",
    "available_passes",
    "register_rule",
    "get_rule",
    "available_rules",
]


class Registry:
    """A named string-keyed plugin table with lazy default population."""

    def __init__(self, kind: str, default_modules: tuple[str, ...] = ()):
        self.kind = kind
        self._entries: dict[str, object] = {}
        # modules that register the built-in entries on import
        self._default_modules = default_modules
        self._loaded_defaults = False

    def _ensure_defaults(self) -> None:
        if self._loaded_defaults:
            return
        self._loaded_defaults = True
        for mod in self._default_modules:
            importlib.import_module(mod)

    def register(
        self, name: str, obj: Optional[object] = None, *, overwrite: bool = False
    ):
        """Register ``obj`` under ``name``; usable as a decorator.

        ``register(name)`` returns a decorator; ``register(name, obj)``
        registers directly and returns ``obj``.  Re-registering an
        existing name requires ``overwrite=True`` (guards against two
        plugins silently shadowing each other).
        """
        if obj is None:
            return lambda f: self.register(name, f, overwrite=overwrite)
        # load the built-ins first so the duplicate check sees them: a user
        # registering a built-in name before any lookup must fail HERE, not
        # later inside the defaults import (which would poison the registry)
        self._ensure_defaults()
        if not overwrite and name in self._entries and self._entries[name] is not obj:
            raise ValueError(
                f"{self.kind} {name!r} is already registered "
                f"(pass overwrite=True to replace it)"
            )
        self._entries[name] = obj
        return obj

    def unregister(self, name: str) -> None:
        self._entries.pop(name, None)

    def get(self, name: str) -> object:
        self._ensure_defaults()
        try:
            return self._entries[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} {name!r} "
                f"(registered: {', '.join(self.available()) or 'none'})"
            ) from None

    def __contains__(self, name: str) -> bool:
        self._ensure_defaults()
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        self._ensure_defaults()
        return iter(sorted(self._entries))

    def available(self) -> list[str]:
        self._ensure_defaults()
        return sorted(self._entries)


BACKENDS = Registry("backend", ("repro_torch.exec.backend",))
CHANNELS = Registry("channel", ("repro_torch.exec.channels",))
SCHEDULERS = Registry("scheduler", ("repro_torch.core.scheduler",))
PASSES = Registry("pass", ("repro_torch.core.plan", "repro_torch.core.fusion"))
RULES = Registry("rule", ("repro_torch.analysis.rules",))


def register_backend(name: str, factory: Optional[Callable] = None, **kw):
    """Register a compute backend: ``factory(storage, scratch) ->
    ComputeBackend``."""
    return BACKENDS.register(name, factory, **kw)


def get_backend(name: str) -> Callable:
    return BACKENDS.get(name)


def available_backends() -> list[str]:
    return BACKENDS.available()


def register_channel(name: str, factory: Optional[Callable] = None, **kw):
    """Register a transfer channel: ``factory(*, latency,
    progress_threads) -> channel``."""
    return CHANNELS.register(name, factory, **kw)


def get_channel(name: str) -> Callable:
    return CHANNELS.get(name)


def available_channels() -> list[str]:
    return CHANNELS.available()


def register_pass(name: str, fn: Optional[Callable] = None, **kw):
    """Register a plan-stage graph pass: ``fn(ctx: PlanContext) ->
    None``.  The pass may rewrite ``ctx.ops`` (setting ``ctx.dirty``)
    and/or set executor hints in ``ctx.hints``; it must preserve the
    relative order of every pair of conflicting accesses it keeps."""
    return PASSES.register(name, fn, **kw)


def get_pass(name: str) -> Callable:
    return PASSES.get(name)


def available_passes() -> list[str]:
    return PASSES.available()


def register_rule(name: str, fn: Optional[Callable] = None, **kw):
    """Register a static-analysis rule: ``fn(ctx: AnalysisContext) ->
    None``.  The rule inspects the context's pre-/post-plan snapshots
    (or cone footprints, or the cross-rank message schedule) and
    appends :class:`~repro_torch.analysis.Diagnostic` objects to
    ``ctx.diagnostics``; a rule must no-op when its inputs are absent
    so ``repro_torch.analysis.check`` can run any subset."""
    return RULES.register(name, fn, **kw)


def get_rule(name: str) -> Callable:
    return RULES.get(name)


def available_rules() -> list[str]:
    return RULES.available()


def register_scheduler(name: str, fn: Optional[Callable] = None, **kw):
    """Register a simulator flush scheduler: ``fn(deps, cluster,
    executor=None) -> TimelineResult``."""
    return SCHEDULERS.register(name, fn, **kw)


def get_scheduler(name: str) -> Callable:
    return SCHEDULERS.get(name)


def available_schedulers() -> list[str]:
    return SCHEDULERS.available()
