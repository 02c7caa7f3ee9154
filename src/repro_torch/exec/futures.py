"""Minimal thread-safe futures for the asynchronous executor.

``concurrent.futures.Future`` would work, but it drags in executor
machinery and its callback semantics (exceptions swallowed into the
logger) are wrong for us: a completion callback that raises must surface
as an executor failure, not vanish.  This Future is the small core the
flush executor needs — set-once result/exception, callbacks that run
exactly once (immediately when already done), and a blocking ``result``.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional

__all__ = ["Future", "FutureError"]


class FutureError(RuntimeError):
    pass


class Future:
    """Write-once container for a value produced on another thread."""

    __slots__ = ("_lock", "_event", "_result", "_exception", "_callbacks", "_done")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._result: Any = None
        self._exception: Optional[BaseException] = None
        self._callbacks: list[Callable[["Future"], None]] = []
        self._done = False

    # -- producer side ---------------------------------------------------
    def set_result(self, value: Any) -> None:
        with self._lock:
            if self._done:
                raise FutureError("future already resolved")
            self._result = value
            self._done = True
            callbacks, self._callbacks = self._callbacks, []
        self._event.set()
        for cb in callbacks:
            cb(self)

    def set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._done:
                raise FutureError("future already resolved")
            self._exception = exc
            self._done = True
            callbacks, self._callbacks = self._callbacks, []
        self._event.set()
        for cb in callbacks:
            cb(self)

    # -- consumer side ---------------------------------------------------
    def done(self) -> bool:
        return self._done

    def exception(self) -> Optional[BaseException]:
        return self._exception

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("future not resolved within timeout")
        if self._exception is not None:
            raise self._exception
        return self._result

    def add_done_callback(self, cb: Callable[["Future"], None]) -> None:
        """Run ``cb(self)`` when resolved — immediately if already done.
        Callbacks run on the resolving thread; exceptions propagate to it."""
        with self._lock:
            if not self._done:
                self._callbacks.append(cb)
                return
        cb(self)
