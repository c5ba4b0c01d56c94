"""Online traversal-order adaptation: modeled-LLC signal -> visit-order knob.

A port of ``repro.serve.adapt`` with the same rules. The winning traversal
order flips with the KV footprint (cyclic while the working set fits the
LLC, block_snake or sawtooth once it is capacity-bound), and
``obs.llc.LLCSampler`` evaluates that signal against the live
``PagedKVPool``. :class:`OrderAdaptController` seeds its initial order from
the persistent autotune cache at engine start, then every adaptation epoch
re-evaluates the per-candidate modeled miss bytes and, with hysteresis,
switches the order the serve engine stages into its next mixed steps.

The switch is free. ``core.schedule.resolve_order_group`` collapses an
(order, snake_group) pair to the one effective reversal-group scalar
(cyclic 1, sawtooth n_blocks, block_snake g), and the continuous engine
stages that scalar as an int32 input of its captured mixed steps
(``order_group`` through ``assemble_cache_view`` to the paged attention,
B1 on the card), so a switch stages one value and captures nothing:
``ServeEngine.compiled_step_count()`` stays the same across switches.

Hysteresis: modeled miss bytes move with every admission and retirement. A
switch needs the best candidate to beat the current order by at least
``hysteresis`` (fractional modeled-byte improvement) on ``confirm``
consecutive samples; a sample whose candidate changes or falls under the
threshold resets the count.

Metrics: ``serve.order_switches`` (counter) and ``serve.current_order``
(gauge, :data:`ORDER_INDEX`: 0 cyclic, 1 sawtooth, 2 block_snake). Both
exist also when adaptation is off (the gauge then pins the static order).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.schedule import DEFAULT_SNAKE_GROUP, Order, resolve_order_group
from repro_torch.obs.autotune import load_autotune_cache, lookup_order_winner
from repro_torch.obs.metrics import Registry

__all__ = ["OrderAdaptController", "ORDER_INDEX"]

# Stable gauge encoding of the order families (enum declaration order).
ORDER_INDEX = {Order.CYCLIC: 0, Order.SAWTOOTH: 1, Order.BLOCK_SNAKE: 2}


class OrderAdaptController:
    """Decide, per adaptation epoch, which traversal order the engine binds.

    The controller owns the engine's *current* (order, snake_group) pair on
    the continuous path; the engine asks :meth:`effective_group` for the
    staged reversal group each step and calls :meth:`maybe_adapt` once per mixed
    step. ``enabled=False`` keeps the metrics surface (current-order gauge,
    zero switch counter) but never samples or switches — the pinned-order
    engine configuration.
    """

    def __init__(
        self,
        registry: Registry,
        *,
        order: "Order | str",
        snake_group: Optional[int] = None,
        epoch: int = 8,
        hysteresis: float = 0.05,
        confirm: int = 2,
        shared_threshold: float = 0.25,
        enabled: bool = True,
    ):
        self.registry = registry
        self.order = Order.parse(order)
        self.snake_group = snake_group
        self.epoch = int(epoch)
        self.hysteresis = float(hysteresis)
        self.confirm = max(1, int(confirm))
        self.shared_threshold = float(shared_threshold)
        self.enabled = enabled
        self.switches = 0
        self.seeded_from: Optional[dict] = None
        self._pending: Optional[str] = None
        self._pending_count = 0
        self._m_switches = registry.counter("serve.order_switches")
        self._m_current = registry.gauge("serve.current_order")
        self._m_current.set(ORDER_INDEX[self.order])

    # ---- the per-step operand ------------------------------------------------

    def effective_group(self, n_blocks: int) -> int:
        """Effective reversal-group for the current order over ``n_blocks``
        pages — the int the engine stages into the mixed step's
        ``order_group`` input."""
        return resolve_order_group(self.order, self.snake_group, n_blocks)

    @property
    def candidate_orders(self) -> tuple[str, ...]:
        """Orders the LLC sampler must model for the controller to choose
        among — all three families (the current one listed first by the
        sampler's own convention)."""
        return (Order.CYCLIC.value, Order.SAWTOOTH.value, Order.BLOCK_SNAKE.value)

    # ---- engine-start cache seeding ------------------------------------------

    def seed_from_cache(
        self,
        path: str,
        *,
        arch: str,
        seq_bucket: int,
        capacity_mib: float,
        backend: Optional[str] = None,
    ) -> bool:
        """Seed (order, snake_group) from the persistent autotune cache.

        Nearest-bucket ``order_sweep`` lookup (``obs.autotune``); on a
        hit the winner's order replaces the configured initial order before
        the first step ever runs. Missing file / no arch match → keep the
        configured order, return False.
        """
        rec = lookup_order_winner(
            load_autotune_cache(path),
            arch=arch,
            seq_bucket=seq_bucket,
            capacity_mib=capacity_mib,
            backend=backend,
        )
        if rec is None:
            return False
        winner = rec.get("winner", {})
        try:
            self.order = Order.parse(winner["order"])
        except (KeyError, ValueError):
            return False
        if winner.get("snake_group") is not None:
            self.snake_group = int(winner["snake_group"])
        self.seeded_from = rec
        self._m_current.set(ORDER_INDEX[self.order])
        return True

    # ---- the runtime decision loop -------------------------------------------

    def maybe_adapt(self, step_epoch: int, pool, sampler, step_q=None) -> bool:
        """Run one adaptation decision if ``step_epoch`` lands on the epoch.

        Samples the LLC models against the live pool (through ``sampler``,
        an ``obs.llc.LLCSampler``) and applies the hysteresis rule to the
        fresh per-candidate modeled miss bytes. On a switch, the sampler's
        notion of the current order — and the history entry that triggered
        the switch — are updated, so the recorded order is the one driving
        the *next* steps. ``step_q`` (the step's widest decode/verify
        chunk — K+1 under speculative decoding) is forwarded to the sampler
        so the recorded footprint reflects multi-token verification sweeps.
        Returns True iff the order changed.
        """
        if not self.enabled or self.epoch <= 0 or step_epoch % self.epoch != 0:
            return False
        if not sampler.sample(pool, step_q=step_q):
            return False
        entry = sampler.history[-1]
        switched = self.consider(
            sampler.last_fwd_miss,
            shared_miss=entry.get("shared_miss"),
            shared_frac=entry.get("shared_frac", 0.0),
        )
        if switched:
            sampler.current_order = self.order.value
            sampler.history[-1]["current_order"] = self.order.value
        return switched

    def consider(
        self,
        fwd_miss: Optional[dict],
        shared_miss: Optional[dict] = None,
        shared_frac: float = 0.0,
    ) -> bool:
        """Apply the hysteresis rule to one per-order modeled-miss reading.

        The base reading is the fwd-wavefront model; when the live
        shared-page fraction reaches ``shared_threshold``, the shared-prefix
        decode model is blended in, weighted by that fraction — a pool
        dominated by adopted prefix pages has cross-row reuse the fwd model
        cannot see, and the two models can disagree on the argmin (the flip
        the blend exists to catch). Split from :meth:`maybe_adapt` so unit
        tests (and offline replays) can drive the decision logic with
        synthetic readings — no pool or sampler required.
        """
        if not fwd_miss:
            return False
        blended = self.blend(fwd_miss, shared_miss, shared_frac)
        cur = blended.get(self.order.value)
        if cur is None:
            return False
        best_order = min(blended, key=blended.get)
        best = blended[best_order]
        improvement = (cur - best) / cur if cur > 0 else 0.0
        if best_order == self.order.value or improvement < self.hysteresis:
            self._pending, self._pending_count = None, 0
            return False
        if self._pending != best_order:
            self._pending, self._pending_count = best_order, 1
        else:
            self._pending_count += 1
        if self._pending_count < self.confirm:
            return False
        self.switch_to(best_order)
        return True

    def blend(
        self,
        fwd_miss: dict,
        shared_miss: Optional[dict],
        shared_frac: float,
    ) -> dict:
        """Per-order decision signal: fwd model blended with the
        shared-prefix model by the live shared-page fraction ``w`` —
        ``(1-w)*fwd + w*shared`` — once that fraction reaches
        ``shared_threshold``; below it (or with no shared reading) the fwd
        reading passes through untouched. Orders the shared model did not
        score fall back to their fwd value."""
        if not shared_miss or shared_frac < self.shared_threshold:
            return dict(fwd_miss)
        w = min(max(shared_frac, 0.0), 1.0)
        return {
            o: (1.0 - w) * v + w * shared_miss.get(o, v)
            for o, v in fwd_miss.items()
        }

    def switch_to(self, order: "Order | str") -> None:
        """Unconditional switch (the hysteresis-approved tail of
        :meth:`consider`; also the forced-switch hook tests use). Publishes
        the counter bump and the new gauge value; ``snake_group`` is kept —
        it parameterizes block_snake whenever that family is (re)entered."""
        self.order = Order.parse(order)
        self.switches += 1
        self._pending, self._pending_count = None, 0
        self._m_switches.inc()
        self._m_current.set(ORDER_INDEX[self.order])

    @property
    def effective_snake_group(self) -> int:
        """The group block_snake runs at if selected (config or default)."""
        return DEFAULT_SNAKE_GROUP if self.snake_group is None else self.snake_group
