"""Periodic modeled-LLC sampler: the paper's cache analysis, live.

A port of ``repro.obs.llc``: the same gauges, history and models, read
from the port's ``serve.kv_pool.PagedKVPool`` (``lens``, ``_slot_pages``,
``_ref``).

The offline benches evaluate ``kernels.traffic.fwd_llc_model`` /
``shared_prefix_llc_model`` at hand-picked footprints; this sampler
evaluates them against the *live* ``serve.kv_pool.PagedKVPool`` state every
``every`` mixed steps and emits the results as registry gauges:

* ``llc.modeled_miss_bytes{order=...,model=fwd}`` — the forward-wavefront
  LRU model at the pool's current longest-row footprint, one gauge per
  candidate traversal order (the engine's current order always included);
* ``llc.modeled_miss_bytes{order=...,model=shared_prefix}`` — the
  cross-row shared-prefix decode model at the live row count / shared-page
  count (emitted only when the pool actually holds shared pages);
* ``llc.footprint_bytes`` / ``llc.capacity_bytes`` / ``llc.active_rows`` /
  ``llc.shared_pages`` — the inputs, so a dashboard can plot modeled misses
  against the footprint that produced them;
* ``llc.best_order_index`` — argmin over the fwd gauges (index into
  :attr:`LLCSampler.orders`), i.e. *the* decision signal the online order
  adaptation (``serve.adapt.OrderAdaptController``) consumes. Beyond
  the gauges (last-write-wins), every sample also appends one entry to
  :attr:`LLCSampler.history` — footprint + per-order modeled miss bytes +
  the order in effect — so controllers and benches can account modeled
  bytes over time, not just read the latest value.

The model replay is host-side Python over O(tiles²) wavefront steps — at
serve page granularity that is thousands of dict operations, so sampling
every step would be felt; ``every`` defaults to 8 and ``every<=0`` disables
the sampler entirely (the zero-overhead default for benches).

``fwd_spec_for`` is deliberately public and deterministic: tests (and
dashboards) re-derive the exact ``FlashGridSpec`` the sampler used at a
given footprint and check gauge parity against a direct ``fwd_llc_model``
call.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.kernels.traffic import (
    FlashGridSpec,
    fwd_llc_model,
    shared_prefix_llc_model,
)
from repro_torch.obs.metrics import Registry

__all__ = ["LLCSampler", "DEFAULT_CAPACITY_BYTES"]

# Default modeled LLC capacity: 3 MiB, matching the fixed-hardware view the
# hillclimb --sweep-orders ranking uses (so live gauges and offline sweep
# winners are comparable on the same axis).
DEFAULT_CAPACITY_BYTES = 3 * 2**20


class LLCSampler:
    """Evaluate the traffic LLC models against live pool state, per epoch."""

    def __init__(
        self,
        registry: Registry,
        *,
        page: int,
        n_heads: int,
        n_kv_heads: int,
        head_dim: int,
        elem_bytes: int,
        current_order: str,
        snake_group: Optional[int] = None,
        orders: Sequence[str] = ("cyclic", "sawtooth"),
        every: int = 8,
        n_workers: int = 8,
        capacity_bytes: float = DEFAULT_CAPACITY_BYTES,
    ):
        self.registry = registry
        self.page = page
        self.n_groups = max(1, n_heads // max(n_kv_heads, 1))
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.elem_bytes = elem_bytes
        self.current_order = str(current_order)
        self.snake_group = snake_group
        # Current order first (it is the one actually running), then the
        # alternates — ≥2 orders total so modeled-vs-live dashboards always
        # have a comparison series.
        self.orders = [self.current_order] + [
            o for o in orders if o != self.current_order
        ]
        self.every = every
        self.n_workers = n_workers
        self.capacity_bytes = float(capacity_bytes)
        self.samples = 0
        # Per-sample record of the fwd-model evaluation: the adaptation
        # controller reads the latest entry to decide a switch, and benches
        # integrate modeled bytes over the run. Bounded so a long-lived
        # server can't grow it without limit.
        self.history: list[dict] = []
        self.history_cap = 4096

    @property
    def last_fwd_miss(self) -> Optional[dict]:
        """Per-order modeled fwd miss bytes of the latest sample (or None)."""
        return self.history[-1]["fwd_miss"] if self.history else None

    # ---- deterministic model inputs (public: tests re-derive these) ----------

    def fwd_spec_for(self, kv_tokens: int) -> FlashGridSpec:
        """The forward-grid spec modeled at a ``kv_tokens``-token footprint:
        a causal pass over the live KV at page-size tiles (page == kv tile by
        construction of the paged pool, DESIGN.md §8)."""
        kv_tokens = max(self.page, -(-kv_tokens // self.page) * self.page)
        return FlashGridSpec(
            seq_q=kv_tokens,
            seq_kv=kv_tokens,
            n_groups=self.n_groups,
            head_dim=self.head_dim,
            q_block=self.page,
            kv_block=self.page,
            elem_bytes=self.elem_bytes,
            causal=True,
        )

    def verify_spec_for(self, kv_tokens: int, step_q: int) -> FlashGridSpec:
        """The grid spec of one speculative *verification* sweep: a
        ``step_q``-token query chunk (K drafts + 1) attending the full
        ``kv_tokens`` footprint. Rectangular and non-causal — the chunk
        reads every prior KV page; only the intra-chunk triangle is masked,
        which at page granularity rounds away. This is the footprint the
        traversal-order models must see under speculative decoding: the
        same KV sweep now amortized over ``step_q`` query rows."""
        kv_tokens = max(self.page, -(-kv_tokens // self.page) * self.page)
        return FlashGridSpec(
            seq_q=max(self.page, -(-step_q // self.page) * self.page),
            seq_kv=kv_tokens,
            n_groups=self.n_groups,
            head_dim=self.head_dim,
            q_block=self.page,
            kv_block=self.page,
            elem_bytes=self.elem_bytes,
            causal=False,
        )

    def pool_footprint(self, pool) -> dict:
        """Live footprint summary: active rows, longest row (tokens),
        distinct held pages, shared (refcount>1) pages, resident KV bytes."""
        lens = [int(x) for x in pool.lens if int(x) > 0]
        held = {pid for pages in pool._slot_pages for pid in pages}
        shared = sum(1 for pid in held if pool._ref[pid] > 1)
        page_bytes = self.page * self.n_kv_heads * self.head_dim * self.elem_bytes
        return {
            "active_rows": len(lens),
            "max_len": max(lens, default=0),
            "distinct_pages": len(held),
            "shared_pages": shared,
            "resident_bytes": 2 * len(held) * page_bytes,  # K + V
        }

    # ---- sampling ------------------------------------------------------------

    def maybe_sample(self, step_epoch: int, pool, step_q: Optional[int] = None) -> bool:
        """Sample iff enabled and ``step_epoch`` lands on the period."""
        if self.every <= 0 or step_epoch % self.every != 0:
            return False
        return self.sample(pool, step_q=step_q)

    def sample(self, pool, step_q: Optional[int] = None) -> bool:
        fp = self.pool_footprint(pool)
        if fp["max_len"] == 0:
            return False
        reg = self.registry
        reg.gauge("llc.footprint_bytes").set(fp["resident_bytes"])
        reg.gauge("llc.capacity_bytes").set(self.capacity_bytes)
        reg.gauge("llc.active_rows").set(fp["active_rows"])
        reg.gauge("llc.shared_pages").set(fp["shared_pages"])
        # ``step_q`` is the widest decode/verify chunk of the step that
        # triggered the sample: 1 on plain decode, K+1 under speculative
        # decoding. Gauged so dashboards (and the adaptation controller's
        # inputs) see the per-sweep query width the footprint is amortized
        # over, and — when the chunk is wider than one token — the verify
        # model is evaluated per order alongside the fwd model.
        if step_q is not None:
            reg.gauge("llc.step_q_tokens").set(int(step_q))

        spec = self.fwd_spec_for(fp["max_len"])
        fwd_miss = []
        for order in self.orders:
            res = fwd_llc_model(
                spec,
                order,
                snake_group=self.snake_group if order == "block_snake" else None,
                n_workers=self.n_workers,
                capacity_bytes=self.capacity_bytes,
            )
            fwd_miss.append(res.misses)
            reg.gauge("llc.modeled_miss_bytes", order=order, model="fwd").set(
                res.misses
            )
        reg.gauge("llc.best_order_index").set(fwd_miss.index(min(fwd_miss)))

        verify_miss: Optional[dict] = None
        if step_q is not None and step_q > 1:
            vspec = self.verify_spec_for(fp["max_len"], int(step_q))
            verify_miss = {}
            for order in self.orders:
                res = fwd_llc_model(
                    vspec,
                    order,
                    snake_group=(
                        self.snake_group if order == "block_snake" else None
                    ),
                    n_workers=self.n_workers,
                    capacity_bytes=self.capacity_bytes,
                )
                verify_miss[order] = res.misses
                reg.gauge(
                    "llc.modeled_miss_bytes", order=order, model="verify"
                ).set(res.misses)

        # Shared-prefix decode model: evaluated when the pool actually holds
        # shared pages across >1 rows, and recorded into the history entry
        # alongside the fwd reading (with the live shared-page fraction) so
        # the order-adaptation controller can blend the two signals when
        # sharing dominates the footprint (DESIGN.md §11 follow-up).
        shared_miss: Optional[dict] = None
        shared_frac = (
            fp["shared_pages"] / fp["distinct_pages"] if fp["distinct_pages"] else 0.0
        )
        if fp["shared_pages"] and fp["active_rows"] > 1:
            prefix_pages = max(1, fp["shared_pages"])
            own = max(self.page, fp["max_len"] - prefix_pages * self.page)
            shared_miss = {}
            for order in self.orders:
                res = shared_prefix_llc_model(
                    order,
                    n_rows=fp["active_rows"],
                    prefix_pages=prefix_pages,
                    own_tokens=own,
                    n_steps=self.every,
                    page=self.page,
                    n_kv_heads=self.n_kv_heads,
                    head_dim=self.head_dim,
                    elem_bytes=self.elem_bytes,
                    capacity_bytes=self.capacity_bytes,
                    snake_group=(
                        self.snake_group if order == "block_snake" else None
                    ),
                )
                shared_miss[order] = res.misses
                reg.gauge(
                    "llc.modeled_miss_bytes", order=order, model="shared_prefix"
                ).set(res.misses)

        # ``current_order`` here is the order in effect when the sample was
        # taken; a controller that switches on this sample rewrites the
        # entry so the history reflects the order driving the *next* steps.
        self.history.append(
            {
                "sample": self.samples,
                "max_len": fp["max_len"],
                "footprint_bytes": fp["resident_bytes"],
                "active_rows": fp["active_rows"],
                "fwd_miss": dict(zip(self.orders, fwd_miss)),
                "shared_miss": shared_miss,
                "shared_frac": shared_frac,
                "step_q": 1 if step_q is None else int(step_q),
                "verify_miss": verify_miss,
                "current_order": self.current_order,
            }
        )
        if len(self.history) > self.history_cap:
            del self.history[: -self.history_cap]

        self.samples += 1
        reg.counter("llc.samples").inc()
        return True
