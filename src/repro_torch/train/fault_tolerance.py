"""Fault tolerance: step watchdogs, failure injection, elastic re-mesh.

A port of ``repro.train.fault_tolerance``:

  * ``Watchdog`` -- wall-clock bound per step; a hung step (or collective)
    raises ``StepTimeout`` instead of blocking the job forever.
  * ``FailureInjector`` -- deterministic fault schedule for integration
    tests (kill at step k, slow step = straggler).
  * ``usable_mesh_shape`` and ``elastic_remesh`` -- the largest usable
    (data, model) grid from the surviving ranks, as a ``DeviceMesh``; the
    latest checkpoint then restores onto it
    (``restore_pytree(..., shardings=, mesh=)``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence

__all__ = ["Watchdog", "StepTimeout", "FailureInjector", "elastic_remesh", "usable_mesh_shape"]


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


def usable_mesh_shape(n_devices: int, *, model_parallel: int) -> tuple[int, int]:
    """Largest (data, model) grid from survivors, keeping the TP degree if
    possible (params were sharded model-wise; keeping it avoids resharding
    the TP axis), else the biggest TP degree that divides the survivors."""
    mp = model_parallel
    while mp > 1 and n_devices % mp:
        mp //= 2
    return (n_devices // mp, mp)


def elastic_remesh(
    ranks: Sequence[int],
    *,
    model_parallel: int,
    axis_names: tuple[str, str] = ("data", "model"),
    device_type: str = "cuda",
):
    """A ``DeviceMesh`` over the first ``data * model`` of the surviving
    ``ranks`` (of the default process group), shaped by
    :func:`usable_mesh_shape`. Every rank of the group calls it, as
    ``DeviceMesh`` requires; a rank left out holds no coordinate in it."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    dp, mp = usable_mesh_shape(len(ranks), model_parallel=model_parallel)
    grid = torch.tensor(list(ranks)[: dp * mp], dtype=torch.int64).reshape(dp, mp)
    return DeviceMesh(device_type, grid, mesh_dim_names=axis_names)
