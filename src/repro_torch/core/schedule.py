"""The paper's KV traversal: tile orders of the flash forward grid and page
visit orders of the paged serve path.

A port of ``repro.core.schedule`` (the Traversal IR): what the port's
flash attention (forward and backward) and ragged paged attention consume,
and the host wavefront models (:class:`KVSchedule`, :class:`BwdKVSchedule`,
:func:`step_page_visits`) that the cache models replay. The three order families are one grouped-reversal arithmetic with different
group sizes:

  cyclic        : group 1, every pass scans pages 0..n-1;
  sawtooth      : group n, odd passes scan n-1..0 (paper Alg. 4);
  block_snake(g): the reversal applied within groups of ``g`` pages.

On the forward grid (:class:`Traversal`) the parity key is the folded
grid row (GQA group x Q tile) and the range is the row's causal/SWA-trimmed
KV-tile range; on the transposed dK/dV grid of the backward it is the
resident KV tile, and the range is every (GQA group, Q tile) that sees it,
swept as one. During serving the parity key of a row is its cache
length after the step's write, so consecutive steps of one sequence reverse
direction and the tail pages of step t are the first pages of step t+1.
Every order is a permutation of the range; online softmax makes the result
invariant.

Each lowering works on Python ints (the host form, which the tests and the
CUDA kernel's recorded visit order are held to) and on int tensors (the
vectorized form of the reference's traced arithmetic).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, Optional, Sequence

import torch

__all__ = [
    "Order",
    "DEFAULT_SNAKE_GROUP",
    "resolve_order_group",
    "page_visit_order",
    "page_visit_order_dynamic",
    "kv_index",
    "kv_index_host",
    "future_visit_window",
    "num_kv_tiles_for",
    "q_tile_bounds_for",
    "step_page_visits",
    "Traversal",
    "KVSchedule",
    "BwdKVSchedule",
    "bwd_kv_schedule",
]

# Default block_snake group size (pages) when none is configured.
DEFAULT_SNAKE_GROUP = 8


class Order(str, enum.Enum):
    """Traversal order family of the KV inner loop."""

    CYCLIC = "cyclic"
    SAWTOOTH = "sawtooth"
    BLOCK_SNAKE = "block_snake"

    @classmethod
    def parse(cls, v: "Order | str") -> "Order":
        if isinstance(v, Order):
            return v
        try:
            return cls(str(v).lower())
        except ValueError:
            valid = ", ".join(repr(o.value) for o in cls)
            raise ValueError(
                f"unknown traversal order {v!r}; valid orders are: {valid}"
            ) from None


def _resolve_group(order: Order, snake_group: Optional[int], n: int) -> int:
    if order is Order.CYCLIC:
        return 1
    if order is Order.SAWTOOTH:
        return max(int(n), 1)
    g = DEFAULT_SNAKE_GROUP if snake_group is None else int(snake_group)
    if g < 1:
        raise ValueError(f"snake_group must be >= 1, got {snake_group}")
    return max(1, min(g, int(n)))


def resolve_order_group(
    order: Order | str, snake_group: Optional[int], n_kv: int
) -> int:
    """(order, snake_group, range) -> the effective reversal-group size, the
    one scalar that tells the order families apart (cyclic 1, sawtooth n,
    block_snake g). The serve engine passes it to every step."""
    return _resolve_group(Order.parse(order), snake_group, int(n_kv))


def _snake_pos_host(parity: int, j: int, n: int, group: int) -> int:
    """Grouped-snake position of step ``j`` in a range of ``n`` pages."""
    if group <= 1:
        return j
    base = (j // group) * group
    size = min(group, n - base)
    off = j - base
    return base + (off if parity % 2 == 0 else (size - 1) - off)


def _grouped_reversal(parity: torch.Tensor, n_kv: int, group) -> torch.Tensor:
    p = torch.atleast_1d(parity.to(torch.int32))[:, None]
    j = torch.arange(n_kv, dtype=torch.int32, device=p.device)[None, :]
    g = torch.clamp(torch.as_tensor(group, dtype=torch.int32, device=p.device), 1, n_kv)
    base = torch.div(j, g, rounding_mode="floor") * g
    size = torch.minimum(g, n_kv - base)
    rev = base + (size - 1) - (j - base)
    return torch.where(p % 2 == 0, j.expand_as(rev), rev)


def page_visit_order_dynamic(parity, n_kv: int, group) -> torch.Tensor:
    """(B, n_kv) int32 logical page ids in visit order, for per-row parity
    drivers ``parity`` (B,) or scalar, with the reversal ``group`` given as
    data (from :func:`resolve_order_group`; clamped to [1, n_kv])."""
    return _grouped_reversal(torch.as_tensor(parity), n_kv, group)


def page_visit_order(
    order: Order | str, parity, n_kv: int, *, snake_group: Optional[int] = None
) -> torch.Tensor:
    """:func:`page_visit_order_dynamic` with the order given by name."""
    order = Order.parse(order)
    return _grouped_reversal(
        torch.as_tensor(parity), n_kv, _resolve_group(order, snake_group, n_kv)
    )


def _is_host_int(*vals) -> bool:
    return all(isinstance(v, int) and not isinstance(v, bool) for v in vals)


def _snake_pos_tensor(parity, j, n, group) -> torch.Tensor:
    """Vectorized grouped-snake position; every argument may be an int
    tensor (broadcast together) or a Python int."""
    j = torch.as_tensor(j, dtype=torch.int32)
    group = torch.clamp(torch.as_tensor(group, dtype=torch.int32, device=j.device), min=1)
    n = torch.as_tensor(n, dtype=torch.int32, device=j.device)
    base = torch.div(j, group, rounding_mode="floor") * group
    size = torch.minimum(group, n - base)
    rev = base + (size - 1) - (j - base)
    parity = torch.as_tensor(parity, dtype=torch.int32, device=j.device)
    return torch.where(parity % 2 == 0, j, rev)


def kv_index(order: Order | str, i, j, n_kv: int, *, snake_group: Optional[int] = None):
    """KV tile index for parity key ``i``, inner step ``j``, range ``n_kv``
    (Python ints, or int tensors broadcast together)."""
    order = Order.parse(order)
    if order is Order.CYCLIC:
        return j
    group = _resolve_group(order, snake_group, n_kv)
    if _is_host_int(i, j):
        return _snake_pos_host(int(i), int(j), n_kv, group)
    return _snake_pos_tensor(i, j, n_kv, group)


def kv_index_host(
    order: Order | str, i: int, j: int, n_kv: int, *, snake_group: Optional[int] = None
) -> int:
    """Host (Python int) form of :func:`kv_index`."""
    order = Order.parse(order)
    if order is Order.CYCLIC:
        return j
    return _snake_pos_host(i, j, n_kv, _resolve_group(order, snake_group, n_kv))


def future_visit_window(parity, n_kv: int, depth: int, group: int) -> list[int]:
    """The first ``depth`` logical pages of the next step's visit order.

    ``parity`` is the current step's parity driver (the visited length), so
    ``parity + 1`` drives the step about to run; ``group`` is the effective
    reversal group (:func:`resolve_order_group`: 1 cyclic, ``n_kv``
    sawtooth, g block_snake). The tiered pool fetches a suspended row's
    host pages in this order, so the pages its next step reads first come
    back first; ``depth >= n_kv`` gives the whole walk."""
    n = int(n_kv)
    if n <= 0:
        return []
    g = max(1, min(int(group), n))
    p = int(parity) + 1
    return [_snake_pos_host(p, j, n, g) for j in range(min(int(depth), n))]


def step_page_visits(
    order: Order | str,
    row_pages: Sequence[Sequence[int]],
    parities: Sequence[int],
    *,
    snake_group: Optional[int] = None,
) -> Iterator[tuple[int, int]]:
    """Shared-page visit order of one ragged mixed serve step: row ``b``
    walks its physical pages ``row_pages[b]`` in its own order (parity
    ``parities[b]``, the visited length), and the rows advance in lock
    step, so at inner step ``j`` every row still walking visits its
    ``j``-th page. Yields ``(row, physical_page)`` in that interleaved
    order, the trace the cache simulator plays to model rows that share
    prefix pages."""
    order = Order.parse(order)
    rows = [list(p) for p in row_pages]
    if len(rows) != len(parities):
        raise ValueError(f"{len(rows)} rows vs {len(parities)} parities")
    orders = [
        [pages[kv_index_host(order, par, j, len(pages), snake_group=snake_group)]
         for j in range(len(pages))]
        for pages, par in zip(rows, parities)
    ]
    for j in range(max((len(o) for o in orders), default=0)):
        for b, visit in enumerate(orders):
            if j < len(visit):
                yield b, visit[j]


def num_kv_tiles_for(
    q_tile: int, n_kv: int, *, causal: bool, q_block: int, kv_block: int
) -> int:
    """Number of KV tiles Q tile ``q_tile`` touches under causal trimming."""
    if not causal:
        return n_kv
    last_row = (q_tile + 1) * q_block - 1
    return min(n_kv, last_row // kv_block + 1)


def q_tile_bounds_for(
    kv_tile: int, n_q: int, *, causal: bool, window: Optional[int], q_block: int,
    kv_block: int,
) -> tuple[int, int]:
    """Inclusive [lo, hi] Q-tile range that touches ``kv_tile`` (the
    transposed trimming of the dK/dV grid): causal raises ``lo`` with the
    tile, a window caps ``hi`` at the last row that still sees its last
    column. ``hi < lo`` when nothing sees the tile."""
    lo = (kv_tile * kv_block) // q_block if causal else 0
    if window is not None:
        hi = min(n_q - 1, ((kv_tile + 1) * kv_block + window - 2) // q_block)
    else:
        hi = n_q - 1
    return lo, hi


@dataclasses.dataclass(frozen=True)
class Traversal:
    """One attention problem's traversal: ``n_q``/``n_kv`` sequence tiles of
    ``q_block``/``kv_block`` rows, ``n_groups`` GQA query groups folded along
    the row axis (grid rows = ``n_groups * n_q``, row ``i`` covering Q tile
    ``i % n_q``), causal/SWA trimming. ``snake_group`` parameterizes
    ``block_snake`` and is ignored by the other orders.

    Two grids read it: the forward (and dQ) grid, where a folded Q row is
    resident and walks its KV tiles (``kv_*``), and the transposed dK/dV
    grid, where a KV tile is resident and streams every (GQA group, Q tile)
    that sees it as one sweep (``q_bounds``, ``stream_*``).
    """

    order: Order
    n_q: int
    n_kv: int
    causal: bool = False
    window: Optional[int] = None
    q_block: int = 128
    kv_block: int = 128
    n_groups: int = 1
    snake_group: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "order", Order.parse(self.order))
        if self.n_q <= 0 or self.n_kv <= 0:
            raise ValueError(f"empty traversal: n_q={self.n_q} n_kv={self.n_kv}")
        if self.n_groups <= 0:
            raise ValueError(f"n_groups must be positive, got {self.n_groups}")
        if self.snake_group is not None and self.snake_group < 1:
            raise ValueError(f"snake_group must be >= 1, got {self.snake_group}")

    @property
    def grid_rows(self) -> int:
        """Folded Q rows of the forward grid (GQA groups x sequence tiles)."""
        return self.n_groups * self.n_q

    def group_for(self, n: int) -> int:
        """Effective reversal-group size over a trimmed range of ``n`` tiles."""
        return _resolve_group(self.order, self.snake_group, n)

    # ---- index arithmetic of the forward grid ----------------------------------

    def kv_bounds_host(self, q_tile: int) -> tuple[int, int]:
        """Inclusive [lo, hi] KV-tile range visible to sequence tile
        ``q_tile`` (hi < lo when SWA leaves nothing)."""
        if self.causal:
            hi = min(self.n_kv - 1, (q_tile * self.q_block + self.q_block - 1) // self.kv_block)
        else:
            hi = self.n_kv - 1
        lo = (
            max(q_tile * self.q_block - (self.window - 1), 0) // self.kv_block
            if self.window is not None
            else 0
        )
        return lo, hi

    def kv_bounds(self, i) -> tuple[torch.Tensor, torch.Tensor]:
        """Vectorized [lo, hi] for folded grid rows ``i`` (an int tensor)."""
        q_tile = torch.as_tensor(i, dtype=torch.int32) % self.n_q
        if self.causal:
            last_row = q_tile * self.q_block + (self.q_block - 1)
            hi = torch.clamp(torch.div(last_row, self.kv_block, rounding_mode="floor"),
                             max=self.n_kv - 1)
        else:
            hi = torch.full_like(q_tile, self.n_kv - 1)
        if self.window is not None:
            first = torch.clamp(q_tile * self.q_block - (self.window - 1), min=0)
            lo = torch.div(first, self.kv_block, rounding_mode="floor")
        else:
            lo = torch.zeros_like(q_tile)
        return lo, hi

    def kv_block_index(self, i, j):
        """(KV tile, valid) fetched at forward grid step (row ``i``, step
        ``j``). Steps past the trimmed range clamp to its boundary tile with
        ``valid`` False (the TPU kernel's elided fetch); a degenerate trim
        gives one always-invalid boundary step. Python ints give ints; int
        tensors give tensors."""
        if _is_host_int(i, j):
            lo, hi = self.kv_bounds_host(i % self.n_q)
            raw = hi - lo + 1
            steps = max(raw, 1)
            jc = min(max(j, 0), steps - 1)
            if self.order is not Order.CYCLIC:
                jc = _snake_pos_host(i, jc, steps, self.group_for(steps))
            return min(max(lo + jc, 0), self.n_kv - 1), j < raw
        i = torch.as_tensor(i, dtype=torch.int32)
        j = torch.as_tensor(j, dtype=torch.int32)
        lo, hi = self.kv_bounds(i)
        raw = hi - lo + 1
        steps = torch.clamp(raw, min=1)
        jc = torch.minimum(torch.clamp(j, min=0), steps - 1)
        if self.order is Order.SAWTOOTH:
            jc = _snake_pos_tensor(i, jc, steps, steps)
        elif self.order is Order.BLOCK_SNAKE:
            g = torch.clamp(steps, max=self.snake_group or DEFAULT_SNAKE_GROUP)
            jc = _snake_pos_tensor(i, jc, steps, g)
        return torch.clamp(lo + jc, 0, self.n_kv - 1), j < raw

    def kv_step(self, i, j):
        """Untrimmed KV tile of step ``j`` of pass ``i`` over the full
        ``n_kv`` range: the blockwise path masks instead of trimming."""
        return kv_index(self.order, i, j, self.n_kv, snake_group=self.snake_group)

    def visit_order(self, parity) -> torch.Tensor:
        """(B, n_kv) visit-order rows over the full ``n_kv`` range for
        per-row ``parity`` drivers (the paged decode's page walk)."""
        return page_visit_order(self.order, parity, self.n_kv, snake_group=self.snake_group)

    # ---- index arithmetic of the transposed (dK/dV) grid ----------------------

    def q_bounds_host(self, kv_tile: int) -> tuple[int, int]:
        """Inclusive [lo, hi] Q-tile range that sees KV tile ``kv_tile``."""
        return q_tile_bounds_for(kv_tile, self.n_q, causal=self.causal, window=self.window,
                                 q_block=self.q_block, kv_block=self.kv_block)

    def q_bounds(self, jkv) -> tuple[torch.Tensor, torch.Tensor]:
        """Vectorized [lo, hi] for KV tiles ``jkv`` (an int tensor)."""
        jkv = torch.as_tensor(jkv, dtype=torch.int32)
        if self.causal:
            lo = torch.div(jkv * self.kv_block, self.q_block, rounding_mode="floor")
        else:
            lo = torch.zeros_like(jkv)
        if self.window is not None:
            last_row = (jkv + 1) * self.kv_block + (self.window - 2)
            hi = torch.clamp(torch.div(last_row, self.q_block, rounding_mode="floor"),
                             max=self.n_q - 1)
        else:
            hi = torch.full_like(jkv, self.n_q - 1)
        return lo, hi

    def stream_block_index(self, jkv, u):
        """(GQA group, Q tile, valid) streamed at dK/dV grid step (resident
        KV tile ``jkv``, step ``u``). All ``n_groups`` groups over the
        trimmed Q range form one sweep of ``n_groups * steps`` positions,
        reordered as one range with parity key ``jkv`` (sawtooth reverses it
        as a unit, block_snake within ``snake_group`` windows). Steps past
        the sweep clamp to its end with ``valid`` False; an empty Q range
        gives one always-invalid step. Python ints give ints; int tensors
        give tensors."""
        if _is_host_int(jkv, u):
            lo, hi = self.q_bounds_host(jkv)
            raw = hi - lo + 1
            steps = max(raw, 1)
            total = self.n_groups * steps
            uu = min(max(u, 0), total - 1)
            if self.order is not Order.CYCLIC:
                uu = _snake_pos_host(jkv, uu, total, self.group_for(total))
            qi = min(max(lo + uu % steps, 0), self.n_q - 1)
            return uu // steps, qi, u < self.n_groups * raw
        jkv = torch.as_tensor(jkv, dtype=torch.int32)
        u = torch.as_tensor(u, dtype=torch.int32)
        lo, hi = self.q_bounds(jkv)
        raw = hi - lo + 1
        steps = torch.clamp(raw, min=1)
        total = self.n_groups * steps
        uu = torch.minimum(torch.clamp(u, min=0), total - 1)
        if self.order is Order.SAWTOOTH:
            uu = _snake_pos_tensor(jkv, uu, total, total)
        elif self.order is Order.BLOCK_SNAKE:
            g = torch.clamp(total, max=self.snake_group or DEFAULT_SNAKE_GROUP)
            uu = _snake_pos_tensor(jkv, uu, total, g)
        gg = torch.div(uu, steps, rounding_mode="floor")
        qi = torch.clamp(lo + uu % steps, 0, self.n_q - 1)
        return gg, qi, u < self.n_groups * raw

    # ---- host iterators ------------------------------------------------------

    def kv_order(self, q_tile: int, local_iter: Optional[int] = None) -> list[int]:
        """KV tile ids visited for ``q_tile``, trimmed, in traversal order;
        ``local_iter`` is the parity key (default: ``q_tile``)."""
        li = q_tile if local_iter is None else local_iter
        lo, hi = self.kv_bounds_host(q_tile)
        n = hi - lo + 1
        return [
            lo + kv_index_host(self.order, li, j, n, snake_group=self.snake_group)
            for j in range(n)
        ]

    def q_order(self, kv_tile: int, local_iter: Optional[int] = None) -> list[int]:
        """Q tile ids streamed while KV tile ``kv_tile`` is resident (one
        group), trimmed, in traversal order; parity key default ``kv_tile``."""
        li = kv_tile if local_iter is None else local_iter
        lo, hi = self.q_bounds_host(kv_tile)
        n = hi - lo + 1
        return [
            lo + kv_index_host(self.order, li, j, n, snake_group=self.snake_group)
            for j in range(n)
        ]

    def stream_sweep(self, resident: int,
                     local_iter: Optional[int] = None) -> list[tuple[int, int]]:
        """The (GQA group, Q tile) sweep of resident KV tile ``resident`` on
        the transposed grid, in traversal order (``stream_block_index``'s
        valid steps); parity key default ``resident``, the worker-local
        resident counter in the wavefront model. Empty when nothing sees
        the tile."""
        li = resident if local_iter is None else local_iter
        lo, hi = self.q_bounds_host(resident)
        steps = hi - lo + 1
        total = self.n_groups * max(steps, 0)
        return [
            (uu // steps, lo + uu % steps)
            for uu in (
                kv_index_host(self.order, li, u, total, snake_group=self.snake_group)
                for u in range(total)
            )
        ]

    def fwd_grid_steps(self) -> Iterator[tuple[int, int, bool]]:
        """Replay the folded forward grid: yields (row, kv tile, valid) for
        every row and every one of the ``n_kv`` steps."""
        for i in range(self.grid_rows):
            for j in range(self.n_kv):
                jj, valid = self.kv_block_index(i, j)
                yield i, jj, valid

    def stream_grid_steps(self) -> Iterator[tuple[int, int, int, bool]]:
        """Replay the transposed dK/dV grid: yields (kv tile, group, Q tile,
        valid) for every KV tile and every one of the ``grid_rows`` steps."""
        for jkv in range(self.n_kv):
            for u in range(self.grid_rows):
                yield (jkv, *self.stream_block_index(jkv, u))

    def worker_assignments(self, n_workers: int, *,
                           transposed: bool = False) -> list[list[int]]:
        """Round-robin (grid-stride) assignment of residents to persistent
        workers (paper Alg. 2): folded Q rows on the forward grid, KV tiles
        on the transposed one."""
        if n_workers <= 0:
            raise ValueError("n_workers must be positive")
        n_residents = self.n_kv if transposed else self.grid_rows
        return [list(range(w, n_residents, n_workers)) for w in range(n_workers)]

    def wavefront(self, n_workers: int, *,
                  transposed: bool = False) -> Iterator[tuple[int, str, object]]:
        """Lock-step persistent-worker wavefront over the folded grid (paper
        Alg. 2 assignment, §3.4 lock step, Alg. 4 worker-local parity): at
        each global step every active worker issues its current access, in
        worker order. Forward: ('Q', row) on entry, ('K'|'V', kv tile) per
        step, ('O', row) at the end. Transposed: ('K'|'V', kv tile) on entry,
        ('Q'|'dO', (group, q tile)) per step, ('dK'|'dV', kv tile) at the
        end. A resident with an empty stream still emits its bookends."""
        assignments = self.worker_assignments(n_workers, transposed=transposed)
        n_w = len(assignments)
        pos = [0] * n_w
        inner = [0] * n_w
        started = [False] * n_w
        stream: list = [None] * n_w
        active = [len(a) > 0 for a in assignments]
        enter, step, leave = (("K", "V"), ("Q", "dO"), ("dK", "dV")) if transposed else (
            ("Q",), ("K", "V"), ("O",))
        while any(active):
            for w, assign in enumerate(assignments):
                if not active[w]:
                    continue
                res = assign[pos[w]]
                if not started[w]:
                    for name in enter:
                        yield (w, name, res)
                    stream[w] = (self.stream_sweep(res, local_iter=pos[w]) if transposed
                                 else self.kv_order(res % self.n_q, local_iter=pos[w]))
                    started[w] = True
                if stream[w]:
                    for name in step:
                        yield (w, name, stream[w][inner[w]])
                    inner[w] += 1
                if not stream[w] or inner[w] >= len(stream[w]):
                    for name in leave:
                        yield (w, name, res)
                    inner[w] = 0
                    started[w] = False
                    pos[w] += 1
                    if pos[w] >= len(assign):
                        active[w] = False


# ---- host wavefront models over the Traversal ----------------------------------


@dataclasses.dataclass(frozen=True)
class KVSchedule:
    """The forward traversal of one attention problem as a host model: a
    view of :class:`Traversal` (``.traversal``) with the paper's
    persistent-worker wavefront (Alg. 2 round-robin, the lock step of
    §3.4) on top. ``window`` trims the low end of each Q tile's KV range."""

    order: Order
    n_q: int
    n_kv: int
    causal: bool = False
    q_block: int = 128
    kv_block: int = 128
    snake_group: Optional[int] = None
    window: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "order", Order.parse(self.order))
        if self.n_q <= 0 or self.n_kv <= 0:
            raise ValueError(f"empty schedule: n_q={self.n_q} n_kv={self.n_kv}")

    @property
    def traversal(self) -> Traversal:
        return Traversal(order=self.order, n_q=self.n_q, n_kv=self.n_kv, causal=self.causal,
                         window=self.window, q_block=self.q_block, kv_block=self.kv_block,
                         snake_group=self.snake_group)

    def kv_range(self, q_tile: int) -> int:
        lo, hi = self.traversal.kv_bounds_host(q_tile)
        return max(hi - lo + 1, 0)

    def kv_order(self, q_tile: int, local_iter: Optional[int] = None) -> list[int]:
        """KV tiles visited for ``q_tile``; ``local_iter`` is the parity
        key (default the Q tile)."""
        return self.traversal.kv_order(q_tile, local_iter)

    def page_order(self, parity) -> torch.Tensor:
        """(B, n_kv) visit order over this schedule's KV tiles for per-row
        ``parity``."""
        return self.traversal.visit_order(parity)

    def worker_assignments(self, n_workers: int) -> list[list[int]]:
        return self.traversal.worker_assignments(n_workers)

    def wavefront_trace(self, n_workers: int) -> Iterator[tuple[int, str, int]]:
        """Lock-step wavefront access trace: (worker, tensor, tile) with
        'Q' once a Q tile, 'K' and 'V' each inner step, 'O' at its end."""
        yield from self.traversal.wavefront(n_workers)

    def flat_trace(self, n_workers: int = 1) -> list[tuple[str, int]]:
        return [(t, tile) for (_, t, tile) in self.wavefront_trace(n_workers)]

    def bwd(self, window: Optional[int] = None) -> "BwdKVSchedule":
        """The transposed (dK/dV) schedule over the same tile geometry."""
        return BwdKVSchedule(order=self.order, n_q=self.n_q, n_kv=self.n_kv, causal=self.causal,
                             window=self.window if window is None else window,
                             q_block=self.q_block, kv_block=self.kv_block,
                             snake_group=self.snake_group)


@dataclasses.dataclass(frozen=True)
class BwdKVSchedule:
    """The transposed (dK/dV) traversal as a host model: each worker keeps
    one KV tile resident and streams the Q tiles that see it, parity keyed
    on the worker-local resident counter. Causal trimming cuts the low end
    of each Q range, a window the high end."""

    order: Order
    n_q: int
    n_kv: int
    causal: bool = False
    window: Optional[int] = None
    q_block: int = 128
    kv_block: int = 128
    snake_group: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "order", Order.parse(self.order))
        if self.n_q <= 0 or self.n_kv <= 0:
            raise ValueError(f"empty schedule: n_q={self.n_q} n_kv={self.n_kv}")

    @property
    def traversal(self) -> Traversal:
        return Traversal(order=self.order, n_q=self.n_q, n_kv=self.n_kv, causal=self.causal,
                         window=self.window, q_block=self.q_block, kv_block=self.kv_block,
                         snake_group=self.snake_group)

    def q_bounds(self, kv_tile: int) -> tuple[int, int]:
        return q_tile_bounds_for(kv_tile, self.n_q, causal=self.causal, window=self.window,
                                 q_block=self.q_block, kv_block=self.kv_block)

    def q_range(self, kv_tile: int) -> int:
        lo, hi = self.q_bounds(kv_tile)
        return max(hi - lo + 1, 0)

    def q_order(self, kv_tile: int, local_iter: Optional[int] = None) -> list[int]:
        """Q tiles streamed while ``kv_tile`` is resident."""
        return self.traversal.q_order(kv_tile, local_iter)

    def worker_assignments(self, n_workers: int) -> list[list[int]]:
        return self.traversal.worker_assignments(n_workers, transposed=True)

    def wavefront_trace(self, n_workers: int) -> Iterator[tuple[int, str, int]]:
        """Lock-step wavefront trace of the dK/dV grid: 'K' and 'V' once a
        resident tile, 'Q' and 'dO' each inner step (Q tile ids), 'dK' and
        'dV' at its end."""
        for w, tensor, key in self.traversal.wavefront(n_workers, transposed=True):
            # One GQA group here: the stream keys (group, q tile) -> q tile.
            yield (w, tensor, key[1] if tensor in ("Q", "dO") else key)

    def flat_trace(self, n_workers: int = 1) -> list[tuple[str, int]]:
        return [(t, tile) for (_, t, tile) in self.wavefront_trace(n_workers)]


def bwd_kv_schedule(
    order: Order | str,
    n_q: int,
    n_kv: int,
    *,
    causal: bool = False,
    window: Optional[int] = None,
    q_block: int = 128,
    kv_block: int = 128,
    snake_group: Optional[int] = None,
) -> BwdKVSchedule:
    """The transposed (dK/dV) schedule from grid geometry."""
    return BwdKVSchedule(order=Order.parse(order), n_q=n_q, n_kv=n_kv, causal=causal,
                         window=window, q_block=q_block, kv_block=kv_block,
                         snake_group=snake_group)
