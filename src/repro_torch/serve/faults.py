"""Deterministic fault injection for the serve stack.

A port of ``repro.serve.faults``, whole. A :class:`FaultPlan` is a seeded,
schedule-addressable list of faults ("exhaust the pool at step 6", "cancel
rid 2 at step 3", "fail the device step once at step 9") behind no-op hooks
in ``PagePool``, ``PagedKVPool`` and ``ServeEngine``. With no plan attached
every hook is one ``is None`` test; with one, an injected failure takes the
same code path a real one does (``PoolExhausted`` out of
``PagePool.alloc``, an exception out of the mixed step's dispatch, a host
``cancel`` at a step boundary), so preemption, retry and the typed
statuses run end to end on a pool that is not starved and a card that is
not failing.

Addressing is by **mixed-step index**: the engine calls
:meth:`FaultPlan.begin_step` at every step boundary, and a fault arms once
the step counter reaches its ``step``. Each fault fires ``times`` times
(consumed on firing), and every firing is appended to
:attr:`FaultPlan.fired`; the engine checks the pool's invariants after
every step in which a fault fired.

Sites:

* ``"pool.alloc"``  -- ``PagePool.alloc`` raises ``PoolExhausted``.
* ``"pool.admit"``  -- ``PagedKVPool.admit`` reports no pages.
* ``"device.step"`` -- the engine's mixed-step dispatch raises
  :class:`StepFault` before the step runs (retried once, then the step's
  rows fail).
* ``"cancel"``      -- the engine host-cancels ``rid`` at the step boundary.
* ``"tier.spill"``, ``"tier.fetch"`` -- the host KV tier's hooks; valid
  names, their hooks come with the tier (ROADMAP §A10).

``FaultPlan.random(seed, ...)`` draws a small chaos schedule from a seeded
numpy generator, the reference's draws: the same seed gives the same plan
in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Fault", "FaultPlan", "StepFault", "FAULT_SITES"]

FAULT_SITES = (
    "pool.alloc",
    "pool.admit",
    "device.step",
    "cancel",
    "tier.spill",
    "tier.fetch",
)


class StepFault(RuntimeError):
    """The injected (or real, wrapped) device-step failure type."""


@dataclasses.dataclass
class Fault:
    """One scheduled fault: fires at sites matching ``site`` from mixed
    step ``step`` on, ``times`` times total; ``rid`` targets a request
    (cancel faults only)."""

    site: str
    step: int
    times: int = 1
    rid: Optional[int] = None
    note: str = ""

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; use {FAULT_SITES}")


class FaultPlan:
    """Seeded, schedule-addressable fault list with firing bookkeeping."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.faults: list[Fault] = []
        self.fired: list[dict] = []       # {site, step, rid, note} per firing
        self._step = -1                   # begin_step not called yet: nothing arms
        self._fired_this_step = 0

    # ---- schedule builders (chainable) ---------------------------------------

    def add(self, fault: Fault) -> "FaultPlan":
        self.faults.append(fault)
        return self

    def exhaust_pool(self, step: int, times: int = 1) -> "FaultPlan":
        """Make the next ``times`` page allocations at/after ``step`` raise
        ``PoolExhausted`` — the mid-flight pressure the preemption answers."""
        return self.add(Fault("pool.alloc", step, times, note="exhaust_pool"))

    def refuse_admission(self, step: int, times: int = 1) -> "FaultPlan":
        """Make ``PagedKVPool.admit`` report no pages ``times`` times."""
        return self.add(Fault("pool.admit", step, times, note="refuse_admission"))

    def fail_device_step(self, step: int, times: int = 1, note: str = "") -> "FaultPlan":
        """Fail the mixed-step dispatch ``times`` times at/after ``step``
        (one transient failure is retried; two consecutive fail the rows)."""
        return self.add(Fault("device.step", step, times, note=note or "fail_device_step"))

    def cancel(self, step: int, rid: int) -> "FaultPlan":
        """Host-cancel request ``rid`` at the ``step`` boundary."""
        return self.add(Fault("cancel", step, rid=rid, note="cancel"))

    def spill_stall(self, step: int, times: int = 1) -> "FaultPlan":
        """Make the tiered pool refuse the next ``times`` slot spills at or
        after ``step`` (a stalled host-tier writer) — the engine's
        shed -> spill -> preempt resolution must fall through to
        preemption instead of wedging on the tier."""
        return self.add(Fault("tier.spill", step, times, note="spill_stall"))

    def fetch_fail(self, step: int, times: int = 1) -> "FaultPlan":
        """Fail the next ``times`` host->device page fetches at/after
        ``step`` (a dropped transfer). The prefetcher requeues the page —
        the host copy is untouched — and retries at the next boundary, so
        the suspended row resumes late but bitwise-intact."""
        return self.add(Fault("tier.fetch", step, times, note="fetch_fail"))

    @classmethod
    def random(
        cls,
        seed: int,
        *,
        n_steps: int,
        rids: tuple = (),
        n_exhaust: int = 1,
        n_step_fail: int = 1,
        n_cancel: int = 1,
    ) -> "FaultPlan":
        """A small reproducible chaos schedule: fault steps (and cancel
        targets) drawn from a seeded generator — same seed, same plan."""
        rng = np.random.default_rng(seed)
        plan = cls(seed)
        for _ in range(n_exhaust):
            plan.exhaust_pool(int(rng.integers(1, max(n_steps, 2))))
        for _ in range(n_step_fail):
            plan.fail_device_step(int(rng.integers(1, max(n_steps, 2))))
        for _ in range(min(n_cancel, len(rids))):
            plan.cancel(
                int(rng.integers(0, max(n_steps, 1))),
                rid=int(rng.choice(np.asarray(rids))),
            )
        return plan

    # ---- engine-side protocol ------------------------------------------------

    def begin_step(self, step: int) -> None:
        """Arm faults scheduled at/before ``step`` (engine step boundary)."""
        self._step = step
        self._fired_this_step = 0

    @property
    def fired_this_step(self) -> int:
        return self._fired_this_step

    @property
    def exhausted(self) -> bool:
        """True when every scheduled fault has fully fired."""
        return all(f.times <= 0 for f in self.faults)

    def _fire(self, f: Fault) -> None:
        f.times -= 1
        self._fired_this_step += 1
        self.fired.append(
            {"site": f.site, "step": self._step, "rid": f.rid, "note": f.note}
        )

    def take(self, site: str) -> bool:
        """Consume one due fault at ``site`` (hook call sites). False when
        nothing is due — the no-op fast path."""
        for f in self.faults:
            if f.site == site and f.times > 0 and 0 <= f.step <= self._step:
                self._fire(f)
                return True
        return False

    def take_cancels(self) -> list[int]:
        """All rids whose cancel faults are due at the current step."""
        rids = []
        for f in self.faults:
            if f.site == "cancel" and f.times > 0 and 0 <= f.step <= self._step:
                self._fire(f)
                rids.append(f.rid)
        return rids

    def raise_if(self, site: str) -> None:
        """Raise ``StepFault`` when a fault at ``site`` is due (device-step
        hook: the engine wraps its dispatch with this)."""
        if self.take(site):
            note = self.fired[-1]["note"]
            raise StepFault(f"injected fault at {site} (step {self._step}): {note}")
