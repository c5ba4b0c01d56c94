"""Shared paged KV pool for continuous batching, with refcounted
copy-on-write prefix sharing.

A port of ``repro.serve.kv_pool``. The host side (free list, block tables,
lengths, refcounts, prefix registry, reservations) is numpy and Python and
follows the reference line for line; the parity tests drive both pools in
lock step. The device side is one K and one V tensor of shape
(L, n_pages, page, Hkv, hd), updated in place by the mixed step and by
copy-on-write forks (the JAX pool is functional and rebinds fresh arrays).
An int8 pool (``kv_cache_dtype="int8"``) holds int8 pages and, in the same
dict, their float32 scale planes (L, n_pages, page, Hkv), so a fork copies
both and a captured step bakes in both. Under a mesh (``mesh``, ``pcfg``)
every leaf is placed by ``dist.sharding.pool_shardings``: each rank holds,
writes, forks and reads only its own KV-head shard (a DTensor), or the
whole pool where the heads do not divide the tensor axis; the host side
is the same on every rank.

Page 0 is a reserved dummy: free slots and the invalid rows of a ragged
step point their writes at it. Full prompt pages are registered in a
content-hash registry (a rolling CRC over the chain of page tokens, with an
exact token comparison on every hit); ``admit`` adopts a matching prefix
(refcount bump, no compute) and the first write into a shared page forks it
(``ensure_writable``); ``rollback`` disowns a slot's rejected draft tokens
(speculative decoding). Two admission disciplines:

* ``admission="reserve"`` (default): each request's worst case is
  reserved, so lazy growth and forks never fail mid-flight;
* ``admission="optimistic"``: only the prompt's pages are reserved, and
  decode growth takes the unreserved rest, so the pool can be
  oversubscribed and growth can raise :class:`PoolExhausted`, which the
  engine answers by preempting a slot.

``faults`` (a ``serve.faults.FaultPlan``) drives the ``pool.alloc`` and
``pool.admit`` injection hooks; without one each hook is one ``is None``
test.
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.context import local
from repro_torch.models import transformer as T

__all__ = [
    "PagePool",
    "PagedKVPool",
    "assemble_cache_view",
    "PoolError",
    "PoolExhausted",
    "AdmissionError",
]


class PoolError(RuntimeError):
    """Base of the serve pool's typed failures."""


class PoolExhausted(PoolError):
    """Page allocation could not be satisfied from the free list: under
    ``admission="reserve"`` only through fault injection, under
    ``"optimistic"`` the pressure the engine answers with preemption."""


class AdmissionError(PoolError, ValueError):
    """Admission-path misuse (occupied slot, unusable pool geometry)."""


def assemble_cache_view(pages: dict, block_table, lens, q_lens=None, order_group=None) -> dict:
    """The cache dict ``decode_step`` takes: the pool tensors plus this
    step's block table (B, n_blocks), lengths (B,), valid chunk rows (B,)
    and effective reversal group (a 0-d int32 tensor), all device tensors,
    used as they are: the engine keeps them in a step's static buffers, so
    a captured step reads each replay's values, and a new reversal group
    needs no new capture. Unlike the JAX package the host arrays are not
    tiled across layers: the layer loop shares one copy."""
    view = dict(pages, block_table=block_table, len=lens)
    if q_lens is not None:
        view["q_len"] = q_lens
    if order_group is not None:
        view["order_group"] = order_group
    return view


class PagePool:
    """Host-side free-list allocator over physical page ids.

    Page 0 is never handed out (reserved dummy). ``reserved`` tracks pages
    promised to admitted-but-not-yet-written sequences; ``available`` is
    what a new admission may claim. With ``faults`` attached, an ``alloc``
    the plan schedules to fail raises :class:`PoolExhausted` as a real
    exhaustion would.
    """

    def __init__(self, n_pages: int, *, faults=None):
        if n_pages < 2:
            raise AdmissionError(f"pool needs >= 2 pages (1 dummy), got {n_pages}")
        self.n_pages = n_pages
        self._free: list[int] = list(range(n_pages - 1, 0, -1))  # pop() -> low ids
        self.reserved = 0
        self.faults = faults

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def available(self) -> int:
        return self.free_count - self.reserved

    def alloc(self, n: int) -> list[int]:
        if self.faults is not None and self.faults.take("pool.alloc"):
            raise PoolExhausted(
                f"injected pool exhaustion: want {n}, free {self.free_count}"
            )
        if n > self.free_count:
            raise PoolExhausted(
                f"page pool exhausted: want {n}, free {self.free_count}"
            )
        return [self._free.pop() for _ in range(n)]

    def free(self, ids) -> None:
        self._free.extend(int(i) for i in ids)


def _copy_page(dst: torch.Tensor, src_id: int, dst_id: int) -> None:
    """In place: physical page ``src_id`` of every layer copied onto
    ``dst_id`` (dst is (L, n_pages, ...): pages or scale planes, a rank's
    local block); O(page) traffic."""
    dst[:, dst_id].copy_(dst[:, src_id])


def _hash_step(h: int, page_tokens: np.ndarray) -> int:
    """One link of the rolling prompt-page content hash. Collisions are
    harmless — every registry hit is verified by exact token comparison."""
    return zlib.crc32(np.ascontiguousarray(page_tokens, np.int32).tobytes(), h)


class PagedKVPool:
    """Device page pool + host block tables / lengths / refcounts / registry."""

    def __init__(
        self,
        cfg: ModelConfig,
        n_layers: int,
        n_slots: int,
        max_len: int,
        *,
        device,
        dtype=None,
        prefix_sharing: bool = True,
        registry=None,
        admission: str = "reserve",
        n_pages: Optional[int] = None,
        faults=None,
        mesh=None,
        pcfg=None,
    ):
        """With ``mesh`` (a ``DeviceMesh``) and ``pcfg`` the pages are placed
        on it (``dist.sharding.pool_shardings``)."""
        if cfg.window is not None:
            raise ValueError("paged KV pools require full attention (window=None)")
        if admission not in ("reserve", "optimistic"):
            raise AdmissionError(f"unknown admission discipline {admission!r}")
        self.cfg = cfg
        self.n_slots = n_slots
        self.prefix_sharing = prefix_sharing
        self.admission = admission
        self.page, self.blocks_per_seq = T.page_geometry(cfg, max_len)
        self.capacity = self.blocks_per_seq * self.page
        # ``n_pages`` (allocatable, dummy excluded) defaults to every slot at
        # capacity; fewer oversubscribes the pool (optimistic admission).
        if n_pages is None:
            n_pages = n_slots * self.blocks_per_seq
        if n_pages < self.blocks_per_seq:
            raise AdmissionError(
                f"pool of {n_pages} pages cannot fit one {self.blocks_per_seq}"
                f"-page capacity row"
            )
        self.n_pages = n_pages
        self.faults = faults

        shape = (n_layers, n_pages + 1, self.page, cfg.n_kv_heads, cfg.hd)  # +1 dummy page 0
        self.pages: dict[str, torch.Tensor] = T.kv_buffers(
            cfg, ("k_pages", "v_pages"), shape, dtype=dtype, device=device, mesh=mesh, pcfg=pcfg)
        self.reset()
        self._registry = registry
        if registry is not None:
            self._m_adopted = registry.counter("pool.pages_adopted")
            self._m_adopted_tokens = registry.counter("pool.tokens_adopted")
            self._m_cow = registry.counter("pool.cow_forks")
            self.emit_gauges()

    def reset(self) -> None:
        """Every page free, no slot, an empty registry and zero counters.
        The device pages stay allocated (and their contents stale, behind
        lengths of 0): a captured step keeps their addresses, so an engine
        resets its pool between ``generate()`` calls instead of building a
        new one. The allocator takes the pool's current ``faults``."""
        n_slots = self.n_slots
        self.alloc = PagePool(self.n_pages + 1, faults=self.faults)  # +1 dummy page 0
        self.block_tables = np.zeros((n_slots, self.blocks_per_seq), np.int32)
        self.lens = np.zeros((n_slots,), np.int32)
        # Per-slot written high-water mark (the furthest position this slot
        # itself made writable); the registry-coverage invariant polices it.
        self._written = np.zeros((n_slots,), np.int32)
        self._ref = np.zeros((self.alloc.n_pages,), np.int32)
        self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        self._slot_reserved: list[int] = [0] * n_slots
        # Prefix registry: parent-chain-hash -> (physical page, its tokens).
        self._chain_next: dict[int, tuple[int, np.ndarray]] = {}
        self._page_parent: dict[int, int] = {}
        self.shared_hits = 0
        self.shared_tokens = 0
        self.cow_forks = 0

    # ---- admission / lifecycle ----------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page)

    def nbytes(self) -> int:
        """Device bytes of the pool: pages and scale planes, dummy included."""
        return sum(t.numel() * t.element_size() for t in self.pages.values())

    def local_pages(self) -> dict:
        """Every leaf as this rank holds it: a placed leaf's head shard (its
        local tensor, the same memory), a plain leaf itself."""
        return {name: local(t) for name, t in self.pages.items()}

    def rank_bytes(self) -> int:
        """Device bytes of the pool on this rank: :meth:`nbytes` over the
        tensor axis's size where the heads are split, all of it else."""
        return sum(t.numel() * t.element_size() for t in self.local_pages().values())

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        """Worst-case admissibility ignoring prefix sharing (sharing only
        lowers the need; ``admit`` checks the exact one)."""
        worst = self.pages_for(min(prompt_len + max_new, self.capacity))
        return self.alloc.available >= worst

    def match_prefix(self, prompt: np.ndarray) -> tuple[int, list[int]]:
        """Longest registered prefix of ``prompt``: (tokens covered, pages).
        A final partial page match is adopted too (its first write forks);
        coverage is capped at ``len(prompt) - 1`` so the last prompt token
        always runs through the model."""
        prompt = np.asarray(prompt, np.int32)
        if not self.prefix_sharing or len(prompt) <= 1:
            return 0, []
        page = self.page
        limit = min(len(prompt) - 1, self.capacity)
        h, covered, pids = 0, 0, []
        while covered < limit:
            ent = self._chain_next.get(h)
            if ent is None:
                break
            pid, ptoks = ent
            seg = prompt[covered : covered + page]
            if (
                len(seg) == page
                and covered + page <= limit
                and np.array_equal(ptoks, seg)
            ):
                pids.append(pid)
                covered += page
                h = _hash_step(h, ptoks)
                continue
            rem = prompt[covered:limit]
            if rem.size and np.array_equal(ptoks[: rem.size], rem):
                pids.append(pid)
                covered = limit
            break
        return covered, pids

    def admit(self, slot: int, prompt: np.ndarray, max_new: int) -> Optional[int]:
        """Admit a request into ``slot``: adopt the shared prefix and reserve
        the owned pages the discipline guarantees (reserve: prompt + full
        ``max_new``; optimistic: the prompt's only). Returns the number of
        prompt tokens adopted (0 if none), or None when the pool lacks pages
        (or an injected ``pool.admit`` fault refuses)."""
        if self._slot_pages[slot] or self._slot_reserved[slot] or self.lens[slot]:
            raise AdmissionError(f"slot {slot} is occupied")
        if self.faults is not None and self.faults.take("pool.admit"):
            return None
        prompt = np.asarray(prompt, np.int32)
        prompt_len = min(len(prompt), self.capacity)
        covered, pids = self.match_prefix(prompt)
        # Adopted pages strictly below the write boundary are never written
        # again; a partially covered tail page forks on its first write.
        n_safe = covered // self.page
        guaranteed = prompt_len + max_new if self.admission == "reserve" else prompt_len
        worst = self.pages_for(min(guaranteed, self.capacity))
        need = max(worst - n_safe, 0)
        if self.alloc.available < need:
            return None
        for pid in pids:
            self._ref[pid] += 1
        self.shared_hits += len(pids)
        self.shared_tokens += covered
        if self._registry is not None and pids:
            self._m_adopted.inc(len(pids))
            self._m_adopted_tokens.inc(covered)
        self._slot_pages[slot] = list(pids)
        self._slot_reserved[slot] = need
        self.alloc.reserved += need
        self.block_tables[slot] = 0
        self.block_tables[slot, : len(pids)] = pids
        self.lens[slot] = covered
        self._written[slot] = 0  # adopted prefix KV was written by the donor
        return covered

    def _take_page(self, slot: int) -> int:
        if self._slot_reserved[slot] > 0:
            (pid,) = self.alloc.alloc(1)
            self.alloc.reserved -= 1
            self._slot_reserved[slot] -= 1
        else:
            # Beyond the reservation: optimistic growth only, and only from
            # the unreserved rest (never a page promised to another slot).
            if self.admission == "reserve":
                raise AssertionError("allocation beyond reservation")
            if self.alloc.available < 1:
                raise PoolExhausted(
                    f"optimistic growth for slot {slot}: free "
                    f"{self.alloc.free_count}, reserved {self.alloc.reserved}"
                )
            (pid,) = self.alloc.alloc(1)
        self._ref[pid] = 1
        return pid

    def _unregister(self, pid: int) -> None:
        parent = self._page_parent.pop(pid, None)
        if parent is not None and self._chain_next.get(parent, (None,))[0] == pid:
            del self._chain_next[parent]

    def ensure_writable(self, slot: int, n: int = 1) -> None:
        """Make positions ``[len, len+n)`` of ``slot`` writable: materialize
        missing pages, copy-on-write-fork shared ones, unregister a
        sole-owned registered page about to diverge. Idempotent; raises
        :class:`PoolExhausted` only beyond a reservation (optimistic
        growth) or by injection, leaving what it made writable so far."""
        start = int(self.lens[slot])
        end = min(start + n, self.capacity)
        if end <= start:
            return
        held = self._slot_pages[slot]
        for pg in range(start // self.page, (end - 1) // self.page + 1):
            if pg < len(held):
                pid = held[pg]
                if self._ref[pid] > 1:
                    nid = self._take_page(slot)
                    self.cow_forks += 1
                    if self._registry is not None:
                        self._m_cow.inc()
                    for leaf in self.local_pages().values():
                        _copy_page(leaf, pid, nid)
                    self._ref[pid] -= 1
                    held[pg] = nid
                    self.block_tables[slot, pg] = nid
                elif pid in self._page_parent:
                    self._unregister(pid)
            else:
                pid = self._take_page(slot)
                held.append(pid)
                self.block_tables[slot, pg] = pid
        self._written[slot] = max(int(self._written[slot]), end)

    def advance(self, slot: int, n: int = 1) -> None:
        """Record ``n`` written tokens (host mirror of the device len+q_len)."""
        self.lens[slot] = min(self.lens[slot] + n, self.capacity)

    def rollback(self, slot: int, n: int) -> int:
        """Disown the last ``n`` tokens of ``slot`` (rejected drafts of
        speculative decoding): ``lens`` goes down and the tail pages that
        back no live token are released, on the host only; the device pages
        keep their stale rows behind the shorter length. Returns the pages
        freed.

        Only tokens the slot wrote itself may be rolled back; those went
        through :meth:`ensure_writable`, whose fork made their pages the
        slot's own. A page held by another slot (refcount > 1) among those
        to drop raises :class:`PoolError` before anything changes. Under
        ``"reserve"`` each freed page goes back to the slot's reservation,
        so growth over the same positions still cannot fail. A held page
        still registered whose content reaches past the new length into
        positions the slot wrote is unregistered: no later ``admit`` may
        adopt rejected-draft K/V."""
        n = min(int(n), int(self.lens[slot]))
        if n <= 0:
            return 0
        new_len = int(self.lens[slot]) - n
        keep = self.pages_for(new_len)
        held = self._slot_pages[slot]
        dropped = held[keep:]
        for pid in dropped:
            if self._ref[pid] > 1:
                raise PoolError(
                    f"rollback({slot}, {n}) would drop shared page {pid} "
                    f"(ref {int(self._ref[pid])}): only self-written tokens "
                    "may be rolled back"
                )
        for pid in dropped:
            self._ref[pid] -= 1
            self._unregister(pid)
            self.alloc.free([pid])
        del held[keep:]
        self.block_tables[slot, keep:] = 0
        self.lens[slot] = new_len
        if dropped and self.admission == "reserve":
            self._slot_reserved[slot] += len(dropped)
            self.alloc.reserved += len(dropped)
        for pg, pid in enumerate(held):
            end = (pg + 1) * self.page
            if pid in self._page_parent and new_len < end <= int(self._written[slot]):
                self._unregister(pid)
        return len(dropped)

    def register_prompt(self, slot: int, prompt: np.ndarray) -> None:
        """Publish ``slot``'s full prompt pages in the prefix registry (once,
        when the prompt is fully cached). A link already registered with the
        same content is refreshed to this slot's copy; a divergent chain on
        the hash link ends registration (first wins)."""
        if not self.prefix_sharing:
            return
        prompt = np.asarray(prompt, np.int32)
        page = self.page
        held = self._slot_pages[slot]
        h = 0
        for j in range(min(len(prompt) // page, len(held))):
            ptoks = prompt[j * page : (j + 1) * page]
            pid = held[j]
            ent = self._chain_next.get(h)
            if ent is not None and not np.array_equal(ent[1], ptoks):
                break
            if ent is None or ent[0] != pid:
                if ent is not None:
                    self._page_parent.pop(ent[0], None)
                self._chain_next[h] = (pid, ptoks.copy())
                self._page_parent[pid] = h
            h = _hash_step(h, ptoks)

    def shared_donor(self, slot: int) -> bool:
        """Whether ``slot`` holds a page other slots hold too (refcount >
        1): releasing it frees fewer pages than it holds, so preemption
        prefers other victims."""
        return any(self._ref[pid] > 1 for pid in self._slot_pages[slot])

    def step_lens(self) -> np.ndarray:
        """The lengths a step stages (a tiered pool zeroes a suspended slot's)."""
        return self.lens

    def occupancy(self) -> float:
        """Held fraction of the allocatable pool (admission watermark)."""
        n_alloc = self.alloc.n_pages - 1
        return (n_alloc - self.alloc.free_count) / max(n_alloc, 1)

    def release(self, slot: int) -> None:
        """Release every page ``slot`` holds. Idempotent."""
        if (
            not self._slot_pages[slot]
            and not self._slot_reserved[slot]
            and not self.lens[slot]
        ):
            self.block_tables[slot] = 0
            return
        for pid in self._slot_pages[slot]:
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                self._unregister(pid)
                self.alloc.free([pid])
        self.alloc.reserved -= self._slot_reserved[slot]
        self._slot_pages[slot] = []
        self._slot_reserved[slot] = 0
        self.block_tables[slot] = 0
        self.lens[slot] = 0
        self._written[slot] = 0

    # ---- invariants ----------------------------------------------------------

    def offslot_pages(self, slot: int) -> int:
        """Logical pages of ``slot`` held outside its block table: 0 here;
        the tiered pool counts a suspended slot's host pages, so the
        coverage invariant below holds across both tiers."""
        return 0

    def check_invariants(self) -> None:
        """Assert conservation and consistency: free + distinct-held ==
        allocatable pages, refcounts equal the number of holders,
        reservations agree, every block-table entry is a held page or the
        dummy, and no registered page extends past its slot's live len into
        positions that slot wrote."""
        held: dict[int, int] = {}
        for pages in self._slot_pages:
            assert len(set(pages)) == len(pages), "slot holds a page twice"
            for pid in pages:
                held[pid] = held.get(pid, 0) + 1
        assert self.alloc.free_count + len(held) == self.alloc.n_pages - 1, (
            f"page leak: free={self.alloc.free_count} held={len(held)} "
            f"of {self.alloc.n_pages - 1}"
        )
        for pid, cnt in held.items():
            assert pid != 0, "dummy page held by a slot"
            assert self._ref[pid] == cnt, (pid, self._ref[pid], cnt)
        assert (self._ref >= 0).all(), "negative refcount"
        for pid in range(1, self.alloc.n_pages):
            if pid not in held:
                assert self._ref[pid] == 0, f"freed page {pid} has refs"
                assert pid not in self._page_parent, f"freed page {pid} registered"
        assert self.alloc.reserved == sum(self._slot_reserved) >= 0
        for slot in range(self.n_slots):
            n_logical = -(-int(self.lens[slot]) // self.page)
            assert len(self._slot_pages[slot]) + self.offslot_pages(slot) >= n_logical, (
                slot, len(self._slot_pages[slot]), self.offslot_pages(slot), n_logical
            )
            for pg, pid in enumerate(self._slot_pages[slot]):
                assert self.block_tables[slot, pg] == pid
                end = (pg + 1) * self.page
                assert not (
                    pid in self._page_parent
                    and int(self.lens[slot]) < end <= int(self._written[slot])
                ), (
                    f"registered page {pid} of slot {slot} extends past live "
                    f"len {int(self.lens[slot])} into written tail "
                    f"(page end {end}, written {int(self._written[slot])})"
                )
            for pg in range(len(self._slot_pages[slot]), self.blocks_per_seq):
                assert self.block_tables[slot, pg] == 0
        for parent, (pid, _) in self._chain_next.items():
            assert self._page_parent.get(pid) == parent

    # ---- telemetry -----------------------------------------------------------

    def emit_gauges(self, registry=None) -> None:
        """Publish occupancy and sharing state as ``pool.*`` gauges."""
        registry = registry if registry is not None else self._registry
        if registry is None:
            return
        n_alloc = self.alloc.n_pages - 1  # dummy page 0 excluded
        held = n_alloc - self.alloc.free_count
        registry.gauge("pool.pages_free").set(self.alloc.free_count)
        registry.gauge("pool.pages_reserved").set(self.alloc.reserved)
        registry.gauge("pool.occupancy_frac").set(held / max(n_alloc, 1))
        registry.gauge("pool.shared_pages").set(int((self._ref > 1).sum()))
        registry.gauge("pool.registered_pages").set(len(self._page_parent))