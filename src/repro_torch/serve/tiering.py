"""Tiered KV memory: a bounded host page tier under the device pool.

A port of the reference's ``serve/tiering.py``. The host side (which slot
is suspended, its host handles, its fetch queue, the prefetch accounting)
follows the reference line for line, and the parity tests drive both pools
in lock step. The device pool becomes a cache over a larger host tier: the
engine's pressure resolution is shed -> **spill** -> preempt, because a
spilled slot keeps its computed K/V (resume is a copy) where a preempted
one is recomputed.

* **Full-slot spill.** ``spill_slot`` gathers every device page of a slot
  (every pool leaf: int8 payloads and their float32 scale planes alike),
  copies them to one pinned host buffer and waits for the copy, then
  releases the slot's device pages and reservation and marks it
  suspended: ``lens`` is kept, the block-table row is dummied to page 0.
  The wait is what makes the release safe: the next replay may write the
  freed pages at once. Shared pages get a private host copy and a refcount
  decrement, so prefix donors keep serving adopters. Under a mesh each
  rank moves its own head shard of the pages (``PagedKVPool.local_pages``)
  to and from its own pinned buffers; which slot spills and when is
  decided on the host, the same on every rank.
* **Known-future prefetch.** The engine fixes a resuming slot's fetch
  order from ``core.schedule.future_visit_window`` (the next step's visit
  order) and stages ``prefetch_depth`` pages per step boundary, issued
  after the in-flight step's replay is launched: non-blocking copies from
  the pinned rows, on a side stream, each chunk closed by an event.
* **Atomic re-admission.** Staged rows live outside the pool until every
  page of the slot is staged; ``complete_resume`` then allocates pages,
  makes the current stream wait on the chunks' events, and writes the rows
  into the pool's own tensors in place (``_write_pages``): a captured step
  baked those tensors' addresses, so the pool never takes new ones.
* **Reuse-distance eviction.** ``select_spill_victim`` ranks candidates by
  ``core.cache_sim.slot_reuse_stats``.

Accounting as in the reference: every staged page counts one ``fetches``;
it becomes a ``prefetch_hits`` when the resumed slot advances and a
``prefetch_wasted`` when the slot is released first, so ``hits + wasted +
pending == fetches`` always holds (``check_invariants``). On the card the
pool also keeps each transfer's CUDA events (``transfer_stats``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.serve.kv_pool import PagedKVPool, PoolExhausted

__all__ = ["HostPageStore", "TieredPagePool", "select_spill_victim"]


def _write_pages(dst: torch.Tensor, rows: torch.Tensor, dst_ids: torch.Tensor) -> None:
    """In place: staged rows (L, k, ...) onto the physical pages ``dst_ids``
    (k,) of ``dst`` (L, P, ...), one call a leaf a staged chunk."""
    dst.index_copy_(1, dst_ids, rows)


def select_spill_victim(candidates) -> Optional[int]:
    """The spill victim among ``candidates``, tuples ``(slot, priority,
    shared_donor, mean_reuse_distance)``: the lowest priority, then a
    non-donor (spilling a donor copies pages that stay on the device for
    its adopters), then the largest mean reuse distance (the coldest page
    stream), then the lowest slot. None when there is no candidate."""
    if not candidates:
        return None
    return min(candidates, key=lambda c: (c[1], bool(c[2]), -c[3], c[0]))[0]


class HostPageStore:
    """Bounded store of spilled page rows. A row is one physical page across
    every pool leaf, ``{leaf name -> (L, page, ...) tensor}``; handles are
    increasing ints; capacity counts rows, the device pool's unit."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"host tier needs >= 1 page, got {capacity}")
        self.capacity = int(capacity)
        self._rows: dict[int, dict] = {}
        self._next = 0

    @property
    def used(self) -> int:
        return len(self._rows)

    @property
    def free(self) -> int:
        return self.capacity - len(self._rows)

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for row in self._rows.values() for a in row.values())

    def put(self, row: dict) -> int:
        if self.free <= 0:
            raise PoolExhausted(f"host page tier full: capacity {self.capacity}")
        h = self._next
        self._next += 1
        self._rows[h] = row
        return h

    def get(self, handle: int) -> dict:
        return self._rows[handle]

    def pop(self, handle: int) -> dict:
        return self._rows.pop(handle)


@dataclasses.dataclass
class _Suspended:
    """Host-side state of one spilled slot."""

    handles: list[int]            # host handle per logical page, in order
    reserved: int                 # device reservation to restore on resume
    queue: list[int] = dataclasses.field(default_factory=list)
                                  # logical pages awaiting fetch, in visit order
    staged: set[int] = dataclasses.field(default_factory=set)
                                  # logical pages already staged on the device
    chunks: list = dataclasses.field(default_factory=list)
                                  # (logical pages, {leaf -> (L, k, ...) staged
                                  # rows}, event or None), one per issue_fetches

    @property
    def started(self) -> bool:
        return bool(self.queue or self.staged)


class TieredPagePool(PagedKVPool):
    """``PagedKVPool`` over a :class:`HostPageStore`.

    Lifecycle verbs, all driven by the engine at step boundaries:
    :meth:`spill_slot`, :meth:`start_resume`, :meth:`issue_fetches`,
    :meth:`complete_resume`. ``advance`` and ``release`` are overridden
    only to classify pending prefetches; everything inherited works on
    suspended slots unchanged. ``reset`` also empties the host tier."""

    def __init__(self, *args, host_pages: int, **kwargs):
        self._host_capacity = int(host_pages)  # read by reset(), which builds the store
        self._side = None          # the fetch stream (on the card, made at first use)
        super().__init__(*args, **kwargs)
        if self._registry is not None:
            r = self._registry
            self._t_spills = r.counter("tier.spills")
            self._t_fetches = r.counter("tier.fetches")
            self._t_hits = r.counter("tier.prefetch_hits")
            self._t_wasted = r.counter("tier.prefetch_wasted")
            self._t_fetch_fail = r.counter("tier.fetch_failures")
            self._t_spill_b = r.counter("tier.spill_bytes")
            self._t_fetch_b = r.counter("tier.fetch_bytes")
            self.emit_gauges()

    def reset(self) -> None:
        super().reset()
        self.host = HostPageStore(self._host_capacity)
        self._suspended: dict[int, _Suspended] = {}
        self._pending: dict[int, int] = {}  # slot -> staged, unclassified fetches
        self.spills = 0
        self.fetches = 0
        self.prefetch_hits = 0
        self.prefetch_wasted = 0
        self.fetch_failures = 0
        self.spill_bytes = 0
        self.fetch_bytes = 0
        self._overlapped = 0
        self._transfers: dict[str, list] = {"spill": [], "fetch": []}

    @property
    def _device(self) -> torch.device:
        return next(iter(self.local_pages().values())).device

    # ---- queries -------------------------------------------------------------

    def suspended_slots(self) -> list[int]:
        return sorted(self._suspended)

    def is_suspended(self, slot: int) -> bool:
        return slot in self._suspended

    def shielded(self, slot: int) -> bool:
        """Resumed and not stepped yet (staged fetches unclassified): not a
        spill candidate, which would waste the fetches and ping-pong."""
        return slot in self._pending

    def fetch_backlog(self) -> int:
        """Host pages still queued for fetch across the resuming slots."""
        return sum(len(s.queue) for s in self._suspended.values())

    def resume_ready(self, slot: int) -> bool:
        sus = self._suspended.get(slot)
        return sus is not None and not sus.queue and len(sus.staged) == len(sus.handles)

    def resume_need(self, slot: int) -> int:
        """Device pages ``complete_resume`` claims (pages + reservation)."""
        sus = self._suspended[slot]
        return len(sus.handles) + sus.reserved

    def offslot_pages(self, slot: int) -> int:
        """Host pages of ``slot`` (0 unless it is suspended)."""
        sus = self._suspended.get(slot)
        return 0 if sus is None else len(sus.handles)

    def next_resume(self, watermark: float, runnable: bool) -> Optional[int]:
        """The suspended slot that may open its fetch queue now, or None:
        none while another resume has started, else the first the pool can
        cover, and only into calm (a resume that pushes occupancy back over
        ``watermark`` moves the pressure to another victim) unless no slot
        is ``runnable``."""
        if any(sus.started for sus in self._suspended.values()):
            return None
        n_alloc = self.alloc.n_pages - 1
        held = n_alloc - self.alloc.free_count
        for i in self.suspended_slots():
            calm = (held + self.offslot_pages(i)) / max(n_alloc, 1) < watermark
            if self.alloc.available >= self.resume_need(i) and (calm or not runnable):
                return i
        return None

    def can_spill(self, slot: int) -> bool:
        return (
            slot not in self._suspended
            and bool(self._slot_pages[slot])
            and self.host.free >= len(self._slot_pages[slot])
        )

    def step_lens(self) -> np.ndarray:
        """The lengths a step stages: a suspended row's are 0 (its block
        table is dummied; its logical length stays in ``lens``)."""
        if not self._suspended:
            return self.lens
        lens = self.lens.copy()
        lens[self.suspended_slots()] = 0
        return lens

    # ---- spill ---------------------------------------------------------------

    def spill_slot(self, slot: int) -> bool:
        """Move every device page of ``slot`` to the host tier and suspend
        it. False (nothing changed) when the slot holds no page, the host
        lacks room, or an injected ``tier.spill`` fault stalls the writer:
        the engine then preempts instead.

        One gather and one device-to-host copy a leaf for the whole slot,
        into pinned memory on the card; the copy is complete before any
        page is freed. Shared pages are copied and ref-decremented: the
        other holders keep serving, and the slot comes back on private
        copies, as if copy-on-write had forked them."""
        if not self.can_spill(slot):
            return False
        if self.faults is not None and self.faults.take("tier.spill"):
            return False
        pids = list(self._slot_pages[slot])
        dev = self._device
        on_card = dev.type == "cuda"
        idx = torch.as_tensor(pids, dtype=torch.long, device=dev)
        start = end = None
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        cols = {}
        for name, leaf in self.local_pages().items():
            # Page-major (k, L, page, ...): each page's row is contiguous, so
            # a fetch copies it without a host-side gather.
            block = leaf.index_select(1, idx).transpose(0, 1).contiguous()
            host = torch.empty(block.shape, dtype=block.dtype, pin_memory=on_card)
            host.copy_(block, non_blocking=on_card)
            cols[name] = host
        if on_card:
            end.record()
            end.synchronize()
        handles = []
        nbytes = 0
        for j in range(len(pids)):
            row = {name: col[j] for name, col in cols.items()}
            handles.append(self.host.put(row))
            nbytes += sum(a.nbytes for a in row.values())
        self.spill_bytes += nbytes
        if self._registry is not None:
            self._t_spill_b.inc(nbytes)
        if on_card:
            self._transfers["spill"].append((start, end, nbytes))
        for pid in pids:
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                self._unregister(pid)
                self.alloc.free([pid])
        res = self._slot_reserved[slot]
        self.alloc.reserved -= res
        self._slot_reserved[slot] = 0
        self._slot_pages[slot] = []
        self.block_tables[slot] = 0
        # lens[slot] is kept: the suspended row's logical length, the resume
        # target, covered in check_invariants through offslot_pages.
        self._suspended[slot] = _Suspended(handles=handles, reserved=res)
        self.spills += 1
        if self._registry is not None:
            self._t_spills.inc()
        return True

    # ---- fetch / resume ------------------------------------------------------

    def start_resume(self, slot: int, order=None) -> None:
        """Fix the fetch order of suspended ``slot`` and open its queue.
        ``order`` is a (possibly partial) permutation of its logical pages,
        the next step's visit window; unnamed pages follow in logical
        order. Already staged pages stay staged."""
        sus = self._suspended[slot]
        n = len(sus.handles)
        head = [int(p) for p in (order or []) if 0 <= int(p) < n]
        seen = set(head)
        full = head + [p for p in range(n) if p not in seen]
        sus.queue = [p for p in full if p not in sus.staged]

    def issue_fetches(self, slot: int, depth: int, *, overlapped: bool = False) -> int:
        """Stage up to ``depth`` queued host pages of ``slot`` on the device.
        Returns the pages staged. On the card each page row is one
        non-blocking copy from pinned memory on the pool's side stream,
        closed by an event: called while a step is in flight, the copies
        run beside it. An injected ``tier.fetch`` fault drops the transfer;
        the page stays queued for the next boundary, so the row resumes
        late with its bits intact."""
        sus = self._suspended.get(slot)
        if sus is None:
            return 0
        pgs: list[int] = []
        while sus.queue and len(pgs) < depth:
            if self.faults is not None and self.faults.take("tier.fetch"):
                self.fetch_failures += 1
                if self._registry is not None:
                    self._t_fetch_fail.inc()
                break
            pgs.append(sus.queue.pop(0))
        if not pgs:
            return 0
        rows = [self.host.get(sus.handles[pg]) for pg in pgs]
        dev = self._device
        on_card = dev.type == "cuda"
        ctx, start, end = contextlib.nullcontext(), None, None
        if on_card:
            if self._side is None:
                self._side = torch.cuda.Stream(dev)
            ctx = torch.cuda.stream(self._side)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        stack = {}
        nbytes = 0
        with ctx:
            if on_card:
                start.record()
            for name in rows[0]:
                first = rows[0][name]
                staged = torch.empty((len(rows), *first.shape), dtype=first.dtype, device=dev)
                for i, row in enumerate(rows):
                    staged[i].copy_(row[name], non_blocking=on_card)
                    nbytes += row[name].nbytes
                stack[name] = staged.transpose(0, 1)   # (L, k, page, ...)
            if on_card:
                end.record()
        sus.chunks.append((pgs, stack, end))
        if on_card:
            self._transfers["fetch"].append((start, end, nbytes))
        sus.staged.update(pgs)
        n = len(pgs)
        self.fetches += n
        self.fetch_bytes += nbytes
        self._pending[slot] = self._pending.get(slot, 0) + n
        if overlapped:
            self._overlapped += n
        if self._registry is not None:
            self._t_fetches.inc(n)
            self._t_fetch_b.inc(nbytes)
        return n

    def complete_resume(self, slot: int) -> bool:
        """Splice a fully staged slot back: allocate its pages, write every
        staged row into the pool's tensors in place (after the current
        stream waits for the fetches), restore the block table and the
        reservation, drop the host copies. Atomic: False, nothing changed,
        when the pool cannot cover pages + reservation now."""
        sus = self._suspended[slot]
        if sus.queue or len(sus.staged) < len(sus.handles):
            return False
        n = len(sus.handles)
        if self.alloc.available < n + sus.reserved:
            return False
        try:
            pids = self.alloc.alloc(n)
        except PoolExhausted:  # injected pool.alloc fault: retried later
            return False
        for pg in range(n):
            self._ref[pids[pg]] = 1
            self.block_tables[slot, pg] = pids[pg]
        dev = self._device
        main = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        pages = self.local_pages()
        for pgs, stack, done in sus.chunks:
            if done is not None:
                main.wait_event(done)
            ids = torch.as_tensor([pids[pg] for pg in pgs], dtype=torch.long, device=dev)
            for name, rows in stack.items():
                _write_pages(pages[name], rows, ids)
                if main is not None:
                    rows.record_stream(main)  # made on the side stream, read here
        self._slot_pages[slot] = list(pids)
        self._slot_reserved[slot] = sus.reserved
        self.alloc.reserved += sus.reserved
        for h in sus.handles:
            self.host.pop(h)
        del self._suspended[slot]
        # _pending stays: classified as hits at the slot's first advance.
        return True

    # ---- lifecycle overrides (prefetch classification) -----------------------

    def advance(self, slot: int, n: int = 1) -> None:
        super().advance(slot, n)
        if slot not in self._suspended:
            pend = self._pending.pop(slot, 0)
            if pend:
                self.prefetch_hits += pend
                if self._registry is not None:
                    self._t_hits.inc(pend)

    def release(self, slot: int) -> None:
        sus = self._suspended.pop(slot, None)
        if sus is not None:
            for h in sus.handles:
                self.host.pop(h)
        pend = self._pending.pop(slot, 0)
        if pend:
            self.prefetch_wasted += pend
            if self._registry is not None:
                self._t_wasted.inc(pend)
        super().release(slot)

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        """Admissible against both tiers: a worst case that overflows the
        device tier is admissible when the host tier can take the overflow
        through spills."""
        worst = self.pages_for(min(prompt_len + max_new, self.capacity))
        return self.alloc.available + self.host.free >= worst

    # ---- invariants ----------------------------------------------------------

    def check_invariants(self) -> None:
        super().check_invariants()
        all_handles: list[int] = []
        for slot, sus in self._suspended.items():
            assert not self._slot_pages[slot], f"suspended slot {slot} still holds device pages"
            assert self._slot_reserved[slot] == 0, (
                f"suspended slot {slot} still holds a reservation"
            )
            n = len(sus.handles)
            all_handles.extend(sus.handles)
            assert set(sus.staged).isdisjoint(sus.queue)
            if sus.started:
                assert sorted(sus.queue + list(sus.staged)) == list(range(n))
        assert len(all_handles) == len(set(all_handles)), "host handle aliased"
        assert self.host.used == len(all_handles), (
            f"host tier leak: stored {self.host.used}, referenced {len(all_handles)}"
        )
        assert all(v > 0 for v in self._pending.values())
        assert (
            self.fetches
            == self.prefetch_hits + self.prefetch_wasted + sum(self._pending.values())
        ), "prefetch accounting drift"

    # ---- telemetry -----------------------------------------------------------

    def emit_gauges(self, registry=None) -> None:
        super().emit_gauges(registry)
        registry = registry if registry is not None else self._registry
        if registry is None or not hasattr(self, "host"):
            return
        n_alloc = self.alloc.n_pages - 1
        registry.gauge("tier.device_pages").set(n_alloc - self.alloc.free_count)
        registry.gauge("tier.host_pages").set(self.host.used)
        registry.gauge("tier.suspended_slots").set(len(self._suspended))
        registry.gauge("tier.overlap_frac").set(self._overlapped / max(self.fetches, 1))

    def transfer_stats(self) -> dict:
        """Bytes, seconds and GB/s of this stream's spills (gather and
        device-to-host copy) and fetches (host-to-device copies), read from
        each transfer's CUDA events (waits for them); seconds and rates are
        None off the card or with no transfer."""
        out = {}
        for kind, recs in self._transfers.items():
            nbytes = sum(b for _, _, b in recs)
            secs = None
            if recs:
                for _, end, _ in recs:
                    end.synchronize()
                secs = sum(s.elapsed_time(e) for s, e, _ in recs) / 1e3
            out[kind] = {"transfers": len(recs), "bytes": nbytes, "seconds": secs,
                         "gb_per_s": nbytes / secs / 1e9 if secs else None}
        return out

