"""Traffic models of the flash kernels' grids, lowered from the Traversal.

A port of ``repro.kernels.traffic`` (the reference's models of its own
grids), and beside it the port's models of the walks its CUDA kernels
really take.

* The **pipeline replays** (``pipeline_traffic``/``bwd_dq_traffic``/
  ``bwd_dkv_traffic``) walk ``fwd_grid_steps``/``stream_grid_steps`` of the
  reference's grid and count the bytes fetched when a fetch whose block
  index repeats the previous step's is elided.
* The **LLC wavefront models** (``fwd_llc_model``/``bwd_dkv_llc_model``/
  ``shared_prefix_llc_model``) replay ``Traversal.wavefront`` (the paper's
  persistent workers: Alg. 2 round robin, the lock step of §3.4, the
  worker-local parity of Alg. 4) through a finite shared LRU
  (``core.cache_sim``). ``obs.llc.LLCSampler`` evaluates ``fwd_llc_model``
  on the live paged pool.
* The **walk models** (``fwd_walk_llc_model``/``dkv_walk_llc_model``) play
  the walks the port's persistent kernels take: B2's work items
  (``kernels.flash_attention.fwd_schedule``, the k-th item of a CTA
  walking ``Traversal.kv_order(q_tile, local_iter=k)``, as ``fwd_walks``
  records it) and B6's (``dkv_schedule``/``dkv_walks``), at the kernels'
  own tiles, one CTA per SM in lock step, through the same LRU at an L2's
  size. Bytes of partial edge tiles count their valid rows only (the
  kernels' copies zero-fill the rest without reading it).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

from repro_torch.core.cache_sim import SimResult, shared_prefix_decode_trace, simulate_trace
from repro_torch.core.schedule import Order, Traversal
from repro_torch.kernels.flash_attention import dkv_schedule, fwd_schedule

__all__ = [
    "FlashGridSpec",
    "pipeline_traffic",
    "TrafficReport",
    "BwdTrafficReport",
    "bwd_dq_traffic",
    "bwd_dkv_traffic",
    "bwd_dkv_llc_model",
    "fwd_llc_model",
    "shared_prefix_llc_model",
    "fwd_walk_trace",
    "fwd_walk_llc_model",
    "dkv_walk_trace",
    "dkv_walk_llc_model",
]


@dataclasses.dataclass(frozen=True)
class FlashGridSpec:
    """Static description of one flash_attention_fwd launch (one bh slice)."""

    seq_q: int
    seq_kv: int
    n_groups: int = 1          # GQA G (q tiles folded per kv head)
    head_dim: int = 128
    q_block: int = 256
    kv_block: int = 256
    elem_bytes: int = 2
    causal: bool = False
    window: Optional[int] = None

    @property
    def nq(self) -> int:
        return -(-self.seq_q // self.q_block)

    @property
    def nkv(self) -> int:
        return -(-self.seq_kv // self.kv_block)

    def traversal(
        self, order: Order | str, snake_group: Optional[int] = None
    ) -> Traversal:
        """Compile the Traversal this launch's kernels would consume."""
        return Traversal(
            order=Order.parse(order),
            n_q=self.nq,
            n_kv=self.nkv,
            causal=self.causal,
            window=self.window,
            q_block=self.q_block,
            kv_block=self.kv_block,
            n_groups=self.n_groups,
            snake_group=snake_group,
        )


@dataclasses.dataclass
class TrafficReport:
    q_bytes: int = 0
    kv_bytes: int = 0
    out_bytes: int = 0
    elided_kv_fetches: int = 0
    total_kv_fetches: int = 0

    @property
    def total_bytes(self) -> int:
        return self.q_bytes + self.kv_bytes + self.out_bytes


def pipeline_traffic(
    spec: FlashGridSpec,
    order: Order | str,
    *,
    snake_group: Optional[int] = None,
) -> TrafficReport:
    """Count the bytes fetched when a fetch of the block the previous grid
    step fetched is elided (the reference's pipeline)."""
    tr = spec.traversal(order, snake_group)
    rep = TrafficReport()
    q_tile_bytes = spec.q_block * spec.head_dim * spec.elem_bytes
    kv_tile_bytes = 2 * spec.kv_block * spec.head_dim * spec.elem_bytes  # K and V
    last_q = None
    last_kv = None
    for i, jj, _valid in tr.fwd_grid_steps():
        if last_q != i:
            rep.q_bytes += q_tile_bytes
            rep.out_bytes += q_tile_bytes  # O written once per tile
            last_q = i
        rep.total_kv_fetches += 1
        if last_kv == jj:
            rep.elided_kv_fetches += 1
        else:
            rep.kv_bytes += kv_tile_bytes
            last_kv = jj
    return rep


# --------------------------------------------------------------------------
# backward grids
# --------------------------------------------------------------------------

# lse and delta are f32 per-row vectors; the reference's kernels stream them
# lane-replicated as (q_block, 128) f32 tiles, and these replays count the
# replicated bytes as the reference does.
LSE_BYTES = 4
RESIDUAL_LANES = 128


@dataclasses.dataclass
class BwdTrafficReport:
    """Byte counts for one backward grid (roles named, not Q/KV-fixed)."""

    resident_bytes: int = 0    # operands fetched once per resident tile
    stream_bytes: int = 0      # the streamed operand bundle (non-elided)
    write_bytes: int = 0       # gradient tiles written
    elided_stream_fetches: int = 0
    total_stream_fetches: int = 0

    @property
    def total_bytes(self) -> int:
        return self.resident_bytes + self.stream_bytes + self.write_bytes


def _row_vec_bytes(spec: FlashGridSpec) -> int:
    return spec.q_block * RESIDUAL_LANES * LSE_BYTES


def bwd_dq_traffic(
    spec: FlashGridSpec,
    order: Order | str,
    *,
    snake_group: Optional[int] = None,
) -> BwdTrafficReport:
    """dQ kernel traffic: the forward grid (Q-side resident, K/V streamed).

    Per resident row: q + do + lse + delta fetched once, dq written once;
    K/V tiles stream with the same schedule/elision as the forward.
    """
    tr = spec.traversal(order, snake_group)
    rep = BwdTrafficReport()
    q_tile_bytes = spec.q_block * spec.head_dim * spec.elem_bytes
    kv_tile_bytes = 2 * spec.kv_block * spec.head_dim * spec.elem_bytes
    last_q = None
    last_kv = None
    for i, jj, _valid in tr.fwd_grid_steps():
        if last_q != i:
            rep.resident_bytes += 2 * q_tile_bytes + 2 * _row_vec_bytes(spec)
            rep.write_bytes += q_tile_bytes
            last_q = i
        rep.total_stream_fetches += 1
        if last_kv == jj:
            rep.elided_stream_fetches += 1
        else:
            rep.stream_bytes += kv_tile_bytes
            last_kv = jj
    return rep


def bwd_dkv_traffic(
    spec: FlashGridSpec,
    order: Order | str,
    *,
    snake_group: Optional[int] = None,
) -> BwdTrafficReport:
    """dK/dV kernel traffic: the transposed grid (KV resident, Q streamed).

    Each resident KV tile streams one linearized sweep — all GQA groups
    over the trimmed Q range — of q + do + lse + delta bundles; K/V are
    fetched and dK/dV written once per KV tile. Sawtooth reverses the whole
    sweep on odd resident counters (``Traversal.stream_block_index``), so
    the sweep-boundary bundle is elided at every KV-tile transition, GQA
    included; block_snake reverses within ``snake_group``-sized windows of
    the sweep instead.
    """
    tr = spec.traversal(order, snake_group)
    rep = BwdTrafficReport()
    q_tile_bytes = spec.q_block * spec.head_dim * spec.elem_bytes
    kv_tile_bytes = 2 * spec.kv_block * spec.head_dim * spec.elem_bytes
    stream_bytes = 2 * q_tile_bytes + 2 * _row_vec_bytes(spec)  # q+do+lse+delta
    last_resident = None
    last_stream = None
    for jkv, gg, qi, _valid in tr.stream_grid_steps():
        if last_resident != jkv:
            rep.resident_bytes += kv_tile_bytes
            rep.write_bytes += kv_tile_bytes
            last_resident = jkv
        key = (gg, qi)
        rep.total_stream_fetches += 1
        if last_stream == key:
            rep.elided_stream_fetches += 1
        else:
            rep.stream_bytes += stream_bytes
            last_stream = key
    return rep


def bwd_dkv_llc_model(
    spec: FlashGridSpec,
    order: Order | str,
    *,
    snake_group: Optional[int] = None,
    n_workers: int = 4,
    capacity_frac: float = 0.5,
    capacity_bytes: Optional[float] = None,
):
    """LRU shared-buffer model of the dK/dV wavefront (paper §3.3/§4.2 shape).

    Plays the transposed wavefront trace (paper Alg. 2 round robin, one
    resident KV tile a worker) through an LRU whose capacity is
    ``capacity_frac`` of the distinct streamed Q-side bytes (or the absolute
    ``capacity_bytes`` when given — the fixed-hardware view a joint
    order/block sweep needs) — the regime where cyclic traversal thrashes
    (reuse distance = the whole Q stream) and sawtooth halves the
    non-compulsory misses. Returns a ``cache_sim.SimResult`` in bytes.
    """
    tr = spec.traversal(order, snake_group)
    q_tile_bytes = spec.q_block * spec.head_dim * spec.elem_bytes
    kv_tile_bytes = spec.kv_block * spec.head_dim * spec.elem_bytes
    weights = {
        "Q": q_tile_bytes,
        "dO": q_tile_bytes,
        "K": kv_tile_bytes,
        "V": kv_tile_bytes,
    }
    if capacity_bytes is None:
        # frac of the distinct streamed Q-side bytes (all GQA groups)
        capacity_bytes = capacity_frac * 2 * spec.n_groups * spec.nq * q_tile_bytes
    # dK/dV are streaming stores (written once, never re-read) — they bypass
    # the buffer, like the paper's L2 *read* sector model.
    trace = (
        ((tensor, key), weights[tensor])
        for _, tensor, key in tr.wavefront(n_workers, transposed=True)
        if tensor in weights
    )
    return simulate_trace(trace, capacity_bytes)


def fwd_llc_model(
    spec: FlashGridSpec,
    order: Order | str,
    *,
    snake_group: Optional[int] = None,
    n_workers: int = 8,
    capacity_frac: float = 0.75,
    capacity_bytes: Optional[float] = None,
):
    """LRU shared-buffer model of the *forward* wavefront, per order.

    Plays the forward persistent-worker wavefront (round-robin Q tiles,
    lock-step progress — ``KVSchedule.wavefront_trace``) through an LRU
    whose capacity is ``capacity_frac`` of the distinct K+V stream bytes.
    Q tiles are read through the buffer too; O tiles are streaming stores
    and bypass it. Returns a ``cache_sim.SimResult`` in bytes.

    This is the capacity-bound regime the ``block_snake`` order targets:
    with causal trimming the workers' pass lengths differ, the wavefront
    desynchronizes, and sawtooth's full-range opposite-direction sweeps
    spread concurrent accesses across the whole KV range — misses despite
    a buffer large enough to hold most of it. Bounding the reversal to
    ``snake_group`` tiles keeps co-resident accesses within ~one group of
    each other, so a group sized below the buffer capacity turns those
    spread accesses back into hits.
    """
    tr = spec.traversal(order, snake_group)
    q_tile_bytes = spec.q_block * spec.head_dim * spec.elem_bytes
    kv_tile_bytes = spec.kv_block * spec.head_dim * spec.elem_bytes
    weights = {"Q": q_tile_bytes, "K": kv_tile_bytes, "V": kv_tile_bytes}
    if capacity_bytes is None:
        capacity_bytes = capacity_frac * 2 * spec.nkv * kv_tile_bytes  # K+V bytes
    trace = (
        ((tensor, key), weights[tensor])
        for _, tensor, key in tr.wavefront(n_workers)
        if tensor in weights
    )
    return simulate_trace(trace, capacity_bytes)


def shared_prefix_llc_model(
    order: Order | str,
    *,
    n_rows: int = 8,
    prefix_pages: int = 8,
    own_tokens: int = 16,
    n_steps: int = 16,
    page: int = 16,
    n_kv_heads: int = 2,
    head_dim: int = 128,
    elem_bytes: int = 2,
    shared: bool = True,
    capacity_frac: float = 0.5,
    capacity_bytes: Optional[float] = None,
    snake_group: Optional[int] = None,
):
    """LRU shared-buffer model of a shared-prefix ragged serve step stream.

    Plays ``core.cache_sim.shared_prefix_decode_trace`` — n_rows sequences
    with a common ``prefix_pages``-page prompt prefix, interleaved in the
    step-level lock-step visit order (``schedule.step_page_visits``), each
    row's walk in its own sawtooth/block_snake parity — through an LRU of
    ``capacity_frac`` × the *unshared* distinct K+V page bytes. Returns a
    ``cache_sim.SimResult`` in bytes.

    With ``shared=True`` the prefix pages are single physical copies (the
    ``serve.kv_pool`` hash-dedup layout): every row past the first hits
    them both in the LLC *and* as deduplicated cold misses, so both the
    compulsory floor and the capacity misses drop versus the private-copy
    layout — the serving-side locality axis the paper's traversal orders
    act on once continuous batching shares pages across rows.
    """
    page_bytes = page * n_kv_heads * head_dim * elem_bytes
    if capacity_bytes is None:
        distinct = n_rows * (prefix_pages + -(-(own_tokens + n_steps) // page))
        capacity_bytes = capacity_frac * 2 * distinct * page_bytes  # K+V
    trace = (
        (key, page_bytes)
        for key in shared_prefix_decode_trace(
            order,
            n_rows,
            prefix_pages,
            [own_tokens] * n_rows,
            n_steps,
            page,
            shared=shared,
            snake_group=snake_group,
        )
    )
    return simulate_trace(trace, capacity_bytes)


# --------------------------------------------------------------------------
# the port's kernels: their persistent walks through the LRU
# --------------------------------------------------------------------------

_ROW_STAT_BYTES = 8  # lse and delta, float32 each, per Q row (B6's stream)


def _tile_bytes(n_tiles: int, block: int, seq: int, row_bytes: int) -> list[int]:
    """Bytes of each tile of ``block`` rows over ``seq`` rows: valid rows only."""
    return [max(0, min(block, seq - t * block)) * row_bytes for t in range(n_tiles)]


def _lockstep(per_worker: list) -> Iterator[tuple[tuple, float]]:
    """Interleave the workers' walks in lock step, as ``Traversal.wavefront``
    does: ``per_worker[w]`` is the worker's items in order, each an
    (entry accesses, [accesses of each inner step]) pair; at every global
    step each active worker issues its entry accesses on entering an item,
    then one inner step's accesses, in worker order."""
    pos = [0] * len(per_worker)
    inner = [0] * len(per_worker)
    started = [False] * len(per_worker)
    active = [w for w, items in enumerate(per_worker) if items]
    while active:
        still = []
        for w in active:
            enter, steps = per_worker[w][pos[w]]
            if not started[w]:
                yield from enter
                started[w] = True
            if steps:
                yield from steps[inner[w]]
                inner[w] += 1
            if not steps or inner[w] >= len(steps):
                inner[w] = 0
                started[w] = False
                pos[w] += 1
            if pos[w] < len(per_worker[w]):
                still.append(w)
        active = still


def fwd_walk_trace(
    tr: Traversal,
    n_slices: int,
    n_workers: int,
    *,
    head_dim: int,
    seq_q: Optional[int] = None,
    seq_kv: Optional[int] = None,
    elem_bytes: int = 2,
) -> Iterator[tuple[tuple, float]]:
    """(key, bytes) reads of B2's persistent walks over ``n_slices`` (batch,
    kv head) slices on ``n_workers`` CTAs: a CTA entering its k-th item
    (slice s, folded row i) reads Q tile ("Q", s, i), then each inner step
    the K and V tiles ("K"|"V", s, j) of ``tr.kv_order(i % n_q,
    local_iter=k)``; the output tile is a streaming store and is not
    played. ``tr`` is ``kernel_traversal(..., kernel="flash_fwd")``;
    ``seq_q``/``seq_kv`` (default whole tiles) trim the edge tiles."""
    row = head_dim * elem_bytes
    q_bytes = _tile_bytes(tr.n_q, tr.q_block, seq_q or tr.n_q * tr.q_block, row)
    kv_bytes = _tile_bytes(tr.n_kv, tr.kv_block, seq_kv or tr.n_kv * tr.kv_block, row)
    per_worker = []
    for items in fwd_schedule(tr, n_slices, n_workers):
        work = []
        for k, (s, i) in enumerate(items):
            q_tile = i % tr.n_q
            steps = [[(("K", s, j), kv_bytes[j]), (("V", s, j), kv_bytes[j])]
                     for j in tr.kv_order(q_tile, local_iter=k)]
            work.append(([(("Q", s, i), q_bytes[q_tile])], steps))
        per_worker.append(work)
    return _lockstep(per_worker)


def dkv_walk_trace(
    tr: Traversal,
    n_slices: int,
    n_workers: int,
    *,
    head_dim: int,
    seq_q: Optional[int] = None,
    seq_kv: Optional[int] = None,
    elem_bytes: int = 2,
) -> Iterator[tuple[tuple, float]]:
    """(key, bytes) reads of B6's persistent walks: a CTA entering its k-th
    item (slice s, KV tile j) reads ("K"|"V", s, j), then each inner step
    the Q and dO tiles and the lse/delta rows ("Q"|"dO"|"LD", s, group, q
    tile) of ``tr.stream_sweep(j, local_iter=k)``; dK and dV are streaming
    stores. ``tr`` is ``kernel_traversal(..., kernel="flash_bwd_dkv")``."""
    row = head_dim * elem_bytes
    n_q_rows = seq_q or tr.n_q * tr.q_block
    q_bytes = _tile_bytes(tr.n_q, tr.q_block, n_q_rows, row)
    stat_bytes = _tile_bytes(tr.n_q, tr.q_block, n_q_rows, _ROW_STAT_BYTES)
    kv_bytes = _tile_bytes(tr.n_kv, tr.kv_block, seq_kv or tr.n_kv * tr.kv_block, row)
    per_worker = []
    for items in dkv_schedule(tr, n_slices, n_workers):
        work = []
        for k, (s, j) in enumerate(items):
            steps = [[(("Q", s, g, qi), q_bytes[qi]), (("dO", s, g, qi), q_bytes[qi]),
                      (("LD", s, g, qi), stat_bytes[qi])]
                     for g, qi in tr.stream_sweep(j, local_iter=k)]
            work.append(([(("K", s, j), kv_bytes[j]), (("V", s, j), kv_bytes[j])], steps))
        per_worker.append(work)
    return _lockstep(per_worker)


def fwd_walk_llc_model(
    tr: Traversal, n_slices: int, n_workers: int, *, capacities: Sequence[float], **kw
) -> list[SimResult]:
    """:func:`fwd_walk_trace` through an LRU of each of ``capacities``
    (bytes); one ``SimResult`` in bytes each."""
    trace = list(fwd_walk_trace(tr, n_slices, n_workers, **kw))
    return [simulate_trace(trace, c) for c in capacities]


def dkv_walk_llc_model(
    tr: Traversal, n_slices: int, n_workers: int, *, capacities: Sequence[float], **kw
) -> list[SimResult]:
    """:func:`dkv_walk_trace` through an LRU of each of ``capacities``."""
    trace = list(dkv_walk_trace(tr, n_slices, n_workers, **kw))
    return [simulate_trace(trace, c) for c in capacities]
