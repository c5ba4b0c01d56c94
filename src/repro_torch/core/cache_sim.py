"""Trace-driven LRU cache simulator (tile granularity).

A port of ``repro.core.cache_sim``. It stands in for a hardware counter of
L2 hits (``ncu``): it replays the exact access stream a persistent-CTA
flash-attention kernel issues (paper Alg. 1+2+4) against an LRU cache of an
L2's size (``cache_model.GB10``, ``H100``) and reports hit/miss sector
counts.

Granularity: one entry per (tensor, batch·head, tile) — all sectors of a tile
are touched together by the tiled kernel, so tile-granularity LRU is exact
for this workload up to boundary tiles. Sector weights preserve the paper's
counter units (`lts__t_sectors.sum`).

Validated against the paper:
  * cold-miss floor 16S            (§3.3, Fig 5)
  * divergence at KV ≈ cache size  (§3.3)
  * hit rate ≈ 1 − 1/N_SM          (§3.4, Fig 6)
  * sawtooth ≈ 50 % fewer non-compulsory misses (§4.2, Fig 8)
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Iterable, Iterator, Sequence

from repro_torch.core import cache_model
from repro_torch.core.cache_model import AttentionWorkload, HWConfig
from repro_torch.core.schedule import (
    Order,
    kv_index_host,
    num_kv_tiles_for,
    step_page_visits,
)

__all__ = [
    "SimResult",
    "LRUCache",
    "simulate_trace",
    "attention_trace",
    "simulate_attention",
    "reuse_distances",
    "reuse_distance_stats",
    "reuse_distance_percentile",
    "slot_reuse_stats",
    "decode_page_trace",
    "simulate_paged_decode",
    "shared_prefix_decode_trace",
    "simulate_shared_prefix_decode",
]


@dataclasses.dataclass
class SimResult:
    accesses: float = 0.0      # sectors requested
    misses: float = 0.0        # sectors missed
    cold_misses: float = 0.0   # first-touch sectors (compulsory)

    @property
    def hits(self) -> float:
        return self.accesses - self.misses

    @property
    def hit_rate(self) -> float:
        return 0.0 if self.accesses == 0 else self.hits / self.accesses

    @property
    def non_compulsory_misses(self) -> float:
        return self.misses - self.cold_misses


class LRUCache:
    """Weighted-entry LRU. Entries carry a sector size; capacity in sectors."""

    def __init__(self, capacity_sectors: float):
        self.capacity = capacity_sectors
        self._entries: OrderedDict[tuple, float] = OrderedDict()
        self._used = 0.0
        self._seen: set[tuple] = set()

    def access(self, key: tuple, sectors: float, result: SimResult) -> bool:
        """Touch ``key``; returns True on hit. Updates ``result`` in place."""
        result.accesses += sectors
        entries = self._entries
        if key in entries:
            entries.move_to_end(key)
            return True
        result.misses += sectors
        if key not in self._seen:
            self._seen.add(key)
            result.cold_misses += sectors
        if sectors > self.capacity:
            return False  # un-cacheable entry: bypass
        entries[key] = sectors
        self._used += sectors
        while self._used > self.capacity:
            _, sz = entries.popitem(last=False)
            self._used -= sz
        return False


def simulate_trace(
    trace: Iterable[tuple[tuple, float]], capacity_sectors: float
) -> SimResult:
    """Replay (key, sectors) accesses through an LRU cache."""
    cache = LRUCache(capacity_sectors)
    result = SimResult()
    access = cache.access
    for key, sectors in trace:
        access(key, sectors, result)
    return result


def attention_trace(
    w: AttentionWorkload,
    hw: HWConfig,
    order: Order | str,
    n_workers: int,
    *,
    snake_group: int | None = None,
) -> Iterator[tuple[tuple, float]]:
    """Wavefront access trace for the full (batch × heads × tiles) problem.

    Work distribution follows paper Alg. 2: the global list of Q tiles (over
    batch·head·tile-index, batch/head-major as in the paper's linearised
    ``(Batch, Head, TileIndex)`` decoding) is claimed round-robin by
    ``n_workers`` persistent workers that progress in lock-step (§3.4's
    wavefront observation). Sawtooth parity is the *worker-local* iteration
    counter, exactly Alg. 4.

    Keys: ("Q"|"K"|"V"|"O", bh, tile).  K/V of one (b,h) are distinct tensors.
    """
    order = Order.parse(order)
    n_tiles = w.n_tiles
    spt = cache_model.sectors_per_tile(w, hw)
    bh_count = w.batch * w.heads
    total_q = bh_count * n_tiles

    # Worker w gets global q indices w, w+G, w+2G, ...
    n_workers = max(1, min(n_workers, total_q))
    positions = [0] * n_workers           # index into worker's assignment
    inner = [0] * n_workers               # inner kv step
    started = [False] * n_workers

    def q_of(worker: int, pos: int) -> int:
        return worker + pos * n_workers

    active = [q_of(wk, 0) < total_q for wk in range(n_workers)]
    while any(active):
        for wk in range(n_workers):
            if not active[wk]:
                continue
            gq = q_of(wk, positions[wk])
            bh, q_tile = divmod(gq, n_tiles)
            n_kv = num_kv_tiles_for(
                q_tile, n_tiles, causal=w.causal, q_block=w.tile, kv_block=w.tile
            )
            if not started[wk]:
                yield (("Q", bh, q_tile), spt)
                started[wk] = True
            j = inner[wk]
            kv = kv_index_host(order, positions[wk], j, n_kv, snake_group=snake_group)
            yield (("K", bh, kv), spt)
            yield (("V", bh, kv), spt)
            inner[wk] += 1
            if inner[wk] >= n_kv:
                yield (("O", bh, q_tile), spt)
                inner[wk] = 0
                started[wk] = False
                positions[wk] += 1
                if q_of(wk, positions[wk]) >= total_q:
                    active[wk] = False


def reuse_distances(keys: Iterable[tuple]) -> list[int]:
    """LRU stack distances of an access stream.

    For each access, the number of *distinct* keys touched since the
    previous access to the same key (0 = immediate re-touch). First-touch
    (compulsory) accesses carry no distance and are skipped. A stream's
    mean stack distance is the canonical locality figure: an LRU cache of
    capacity C hits exactly the accesses with distance < C.
    """
    stack: list[tuple] = []  # most-recent-first
    out: list[int] = []
    for key in keys:
        try:
            i = stack.index(key)
        except ValueError:
            stack.insert(0, key)
            continue
        out.append(i)
        del stack[i]
        stack.insert(0, key)
    return out


def reuse_distance_percentile(dists: Sequence[int], p: float) -> float:
    """Nearest-rank percentile of an LRU stack-distance list (0 if empty).

    ``p`` in [0, 100]. The p-th percentile distance is the smallest cache
    capacity (in entries) at which an LRU cache hits at least ``p`` percent
    of the stream's non-compulsory accesses — the operational reading that
    makes these percentiles an eviction-ranking signal."""
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile {p} outside [0, 100]")
    xs = sorted(dists)
    if not xs:
        return 0.0
    i = min(len(xs) - 1, max(0, round(p / 100 * (len(xs) - 1))))
    return float(xs[i])


def reuse_distance_stats(dists: Sequence[int]) -> dict:
    """Summary statistics of a :func:`reuse_distances` output.

    Returns ``{"n", "mean", "p50", "p90", "max"}`` (zeros for an empty
    list). The mean stack distance is the canonical locality figure; the
    percentiles bound it from both sides (p50 <= mean is the skew check,
    p90/max expose the tail that a capacity-sized LRU actually misses).
    The tiered serve engine ranks spill victims by these stats instead of
    plain last-touch LRU: a slot whose page stream carries the largest
    reuse distances is the one whose pages an LLC-sized device tier was
    going to miss anyway, so it is the cheapest resident set to lose.
    """
    xs = list(dists)
    if not xs:
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0, "max": 0}
    return {
        "n": len(xs),
        "mean": sum(xs) / len(xs),
        "p50": reuse_distance_percentile(xs, 50),
        "p90": reuse_distance_percentile(xs, 90),
        "max": max(xs),
    }


def slot_reuse_stats(
    order: Order | str,
    lens: Sequence[int],
    page: int,
    *,
    n_steps: int = 2,
    snake_group: int | None = None,
) -> list[dict]:
    """Per-slot :func:`reuse_distance_stats` over the interleaved decode
    page trace of all slots stepping together.

    Replays ``n_steps`` lock-step decode steps of rows with cache lengths
    ``lens`` (:func:`decode_page_trace`), splits the stream's stack
    distances by the slot that issued each access, and summarizes each
    slot's share. This is the tiered pool's spill-ranking signal: the trace
    is the measurement twin of the serve hot path, so a slot whose accesses
    land at the largest stack distances is the slot contributing least
    locality to the device tier — evicting (spilling) it first sacrifices
    the fewest would-have-hit residencies. Two steps are enough to expose
    every cross-step reuse pair; more steps only repeat the pattern.
    """
    trace = list(
        decode_page_trace(order, lens, n_steps, page, snake_group=snake_group)
    )
    # reuse_distances skips first touches; recompute with slot attribution.
    stack: list[tuple] = []
    per_slot: list[list[int]] = [[] for _ in lens]
    for key in trace:
        slot = key[1]
        try:
            i = stack.index(key)
        except ValueError:
            stack.insert(0, key)
            continue
        per_slot[slot].append(i)
        del stack[i]
        stack.insert(0, key)
    return [reuse_distance_stats(d) for d in per_slot]


def decode_page_trace(
    order: Order | str,
    lens: Sequence[int],
    n_steps: int,
    page: int,
    *,
    snake_group: int | None = None,
) -> Iterator[tuple]:
    """Page-granular access trace of a paged continuous-batching decode.

    Each decode step, every sequence streams all pages holding its current
    KV (K and V of page p are distinct pool entries), visiting them in
    schedule order with the *cache length* as the sawtooth parity driver —
    as the paged decode (``kernels.flash_decode``, B1 on the card) walks
    them one row at a time, so this trace is the measurement twin of the serving hot path.
    Sawtooth makes consecutive steps reverse direction: the tail pages of
    step t are re-touched first at t+1, halving the mean reuse distance vs
    a cyclic traversal that always restarts at page 0.

    Keys: ("K"|"V", seq, logical_page). Lengths grow by one per step.
    """
    order = Order.parse(order)
    cur = [int(l) for l in lens]
    for _ in range(n_steps):
        for s, length in enumerate(cur):
            n = max(1, -(-(length + 1) // page))  # incl. the token written now
            for j in range(n):
                # Parity matches the hot path exactly: the decode kernels are
                # called with cache_len = length + 1 (the just-written token
                # included), so that is the sawtooth driver here too.
                p = kv_index_host(order, length + 1, j, n, snake_group=snake_group)
                yield ("K", s, p)
                yield ("V", s, p)
            cur[s] = length + 1


def simulate_paged_decode(
    order: Order | str,
    lens: Sequence[int],
    n_steps: int,
    page: int,
    *,
    capacity_pages: float | None = None,
    snake_group: int | None = None,
) -> dict:
    """Replay a paged decode's page trace; report locality + LRU stats.

    Returns mean/max reuse (stack) distance over the page stream and, when
    ``capacity_pages`` is given, the LRU hit rate of a cache holding that
    many page entries. The reuse-distance delta between cyclic and sawtooth
    here is the serving-side analogue of the paper's prefill Fig. 8.
    """
    trace = list(decode_page_trace(order, lens, n_steps, page, snake_group=snake_group))
    dists = reuse_distances(trace)
    stats = {
        "accesses": len(trace),
        "mean_reuse_distance": (sum(dists) / len(dists)) if dists else 0.0,
        "max_reuse_distance": max(dists, default=0),
    }
    if capacity_pages is not None:
        res = simulate_trace(((k, 1.0) for k in trace), capacity_pages)
        stats["hit_rate"] = res.hit_rate
        stats["misses"] = res.misses
        stats["cold_misses"] = res.cold_misses
    return stats


def shared_prefix_decode_trace(
    order: Order | str,
    n_rows: int,
    prefix_pages: int,
    own_lens: Sequence[int],
    n_steps: int,
    page: int,
    *,
    shared: bool = True,
    snake_group: int | None = None,
) -> Iterator[tuple]:
    """Physical-page access trace of a mixed decode step stream whose rows
    share a prompt prefix.

    ``n_rows`` sequences each hold ``prefix_pages`` prompt pages plus their
    own suffix of ``own_lens[b]`` tokens (growing one per step). With
    ``shared=True`` the prefix pages are the *same physical pages* for
    every row (the ``serve.kv_pool`` hash-dedup layout); with False every
    row owns a private copy (the pre-sharing layout). Page walks follow the
    per-row ``Traversal`` (sawtooth parity keyed per row on the visited
    length) and rows interleave in lock-step via
    ``schedule.step_page_visits`` — the step-level shared-page visit order.

    Keys: ("K"|"V", physical_page). The reuse-distance delta between
    shared and unshared is the serving-side locality win of prefix dedup:
    a shared page is re-touched within ~2·n_rows accesses instead of once
    per row's full private walk.
    """
    order = Order.parse(order)
    if len(own_lens) != n_rows:
        raise ValueError(f"{n_rows} rows vs {len(own_lens)} own_lens")
    cur = [int(l) for l in own_lens]
    # Physical page ids: shared prefix pages 0..prefix_pages-1 (or a private
    # copy per row), then per-row suffix pages.
    def phys(row: int, logical: int) -> int:
        if logical < prefix_pages:
            return logical if shared else row * 10_000 + logical
        return 1_000_000 + row * 10_000 + logical
    for _ in range(n_steps):
        row_pages = []
        parities = []
        for b in range(n_rows):
            length = prefix_pages * page + cur[b] + 1  # incl. token written now
            n = max(1, -(-length // page))
            row_pages.append([phys(b, j) for j in range(n)])
            parities.append(length)
        for b, pid in step_page_visits(
            order, row_pages, parities, snake_group=snake_group
        ):
            yield ("K", pid)
            yield ("V", pid)
        cur = [l + 1 for l in cur]


def simulate_shared_prefix_decode(
    order: Order | str,
    n_rows: int,
    prefix_pages: int,
    own_lens: Sequence[int],
    n_steps: int,
    page: int,
    *,
    shared: bool = True,
    capacity_pages: float | None = None,
    snake_group: int | None = None,
) -> dict:
    """Replay a shared-prefix mixed decode stream; report locality + LRU
    stats (same schema as :func:`simulate_paged_decode`). Comparing
    ``shared=True`` vs ``False`` quantifies the cross-row LLC reuse that
    copy-on-write page dedup creates; comparing orders shows the paper's
    sawtooth/block_snake deltas surviving into the shared layout."""
    trace = list(
        shared_prefix_decode_trace(
            order, n_rows, prefix_pages, own_lens, n_steps, page,
            shared=shared, snake_group=snake_group,
        )
    )
    dists = reuse_distances(trace)
    stats = {
        "accesses": len(trace),
        "mean_reuse_distance": (sum(dists) / len(dists)) if dists else 0.0,
        "max_reuse_distance": max(dists, default=0),
    }
    if capacity_pages is not None:
        res = simulate_trace(((k, 1.0) for k in trace), capacity_pages)
        stats["hit_rate"] = res.hit_rate
        stats["misses"] = res.misses
        stats["cold_misses"] = res.cold_misses
    return stats


def simulate_attention(
    w: AttentionWorkload,
    hw: HWConfig,
    order: Order | str = Order.CYCLIC,
    n_workers: int | None = None,
    *,
    snake_group: int | None = None,
) -> SimResult:
    """End-to-end: build the wavefront trace and run it through the LRU L2."""
    n_workers = hw.n_workers if n_workers is None else n_workers
    capacity_sectors = hw.cache_bytes / hw.sector_bytes
    return simulate_trace(
        attention_trace(w, hw, order, n_workers, snake_group=snake_group),
        capacity_sectors,
    )
