"""Fault tolerance: step watchdogs and failure injection.

A copy of the host-side part of ``repro.train.fault_tolerance``:

  * ``Watchdog`` -- wall-clock bound per step; a hung step raises
    ``StepTimeout`` instead of blocking the job forever.
  * ``FailureInjector`` -- deterministic fault schedule for integration
    tests (kill at step k, slow step = straggler).

``elastic_remesh`` and ``usable_mesh_shape`` rebuild a device mesh from the
survivors; the port has no mesh yet (ROADMAP A14).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence

__all__ = ["Watchdog", "StepTimeout", "FailureInjector"]


class StepTimeout(RuntimeError):
    pass


class Watchdog:
    """Context manager raising StepTimeout if the body exceeds ``timeout_s``.

    CUDA launches are asynchronous; callers must block (e.g. read the loss)
    inside.
    """

    def __init__(self, timeout_s: float, on_timeout: Optional[Callable] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self.fired = False

    def _fire(self):
        self.fired = True
        if self.on_timeout:
            self.on_timeout()

    def __enter__(self):
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._timer:
            self._timer.cancel()
        if self.fired and exc_type is None:
            raise StepTimeout(f"step exceeded {self.timeout_s}s watchdog")
        return False


@dataclasses.dataclass
class FailureInjector:
    """Deterministic fault schedule keyed by step number."""

    crash_at: Sequence[int] = ()
    straggle_at: Sequence[int] = ()
    straggle_seconds: float = 0.5

    def maybe_fail(self, step: int):
        if step in self.crash_at:
            raise RuntimeError(f"[injected] node failure at step {step}")
        if step in self.straggle_at:
            time.sleep(self.straggle_seconds)
