"""Page visit orders of the paper's KV traversal, for the paged serve path.

The subset of ``repro.core.schedule`` (the Traversal IR) that ragged paged
attention consumes. The three order families are one grouped-reversal
arithmetic with different group sizes:

  cyclic        : group 1, every pass scans pages 0..n-1;
  sawtooth      : group n, odd passes scan n-1..0 (paper Alg. 4);
  block_snake(g): the reversal applied within groups of ``g`` pages.

During serving the parity driver of a row is its cache length after the
step's write, so consecutive steps of one sequence reverse direction and the
tail pages of step t are the first pages of step t+1. Every order is a
permutation of the page range; online softmax makes the result invariant.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

__all__ = [
    "Order",
    "DEFAULT_SNAKE_GROUP",
    "resolve_order_group",
    "page_visit_order",
    "page_visit_order_dynamic",
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
