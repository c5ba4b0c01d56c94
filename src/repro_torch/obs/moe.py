"""The serve engine's expert-layer counters: what the dropless MoE's grouped
products compute, tallied on the device inside the captured steps.

A :class:`MoETally` holds three device buffers: ``rows`` and ``groups``
(L, E) and ``launches`` (L,), int64. A step function of the engine runs
its model under :meth:`MoETally.recording`; each dropless MoE layer it
runs passes its group sizes (E,) to :func:`record_groups`, layer by layer
in call order, and the block's end adds them in (one stack and three adds
for every layer of the step): ``rows`` += the sizes (the sorted choices
a grouped product runs, pad positions counted, as the kernel computes
them), ``groups`` += (size > 0), ``launches`` += 1 a layer (one grouped
product of each of the three expert products). On the card the adds are
recorded into the step's graph like every other op and run at each
replay; nothing is read on the host. Outside a ``recording`` block
``record_groups`` does nothing, so training and a bare ``LM`` record
none of this.

The engine zeroes the buffers at ``generate()``'s entry and reads them
once at its end (:meth:`MoETally.read`), after its last sync.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional

import torch

from repro_torch.dist.context import local, whole

__all__ = ["MoETally", "record_groups"]

# The group sizes of the layers run so far in the innermost recording block.
_PENDING: ContextVar[Optional[list]] = ContextVar("moe_pending", default=None)


def record_groups(sizes: torch.Tensor) -> None:
    """Hand one layer's group sizes (E,) to the recording block, if any."""
    pending = _PENDING.get()
    if pending is not None:
        pending.append(local(whole(sizes)))


class MoETally:
    def __init__(self, n_layers: int, n_experts: int, *, device):
        self.rows = torch.zeros((n_layers, n_experts), dtype=torch.int64, device=device)
        self.groups = torch.zeros_like(self.rows)
        self.launches = torch.zeros((n_layers,), dtype=torch.int64, device=device)

    def buffers(self) -> tuple[torch.Tensor, ...]:
        return self.rows, self.groups, self.launches

    def zero(self) -> None:
        for t in self.buffers():
            t.zero_()

    @contextlib.contextmanager
    def recording(self):
        """Tally the dropless MoE layers run in the block, added at its end
        (not where the block raises)."""
        pending: list = []
        token = _PENDING.set(pending)
        try:
            yield
        finally:
            _PENDING.reset(token)
        if pending:
            n = len(pending)
            sizes = torch.stack(pending)
            self.rows[:n].add_(sizes)
            self.groups[:n].add_(sizes.clamp(max=1))
            self.launches[:n].add_(1)

    def snapshot(self) -> list[torch.Tensor]:
        return [t.clone() for t in self.buffers()]

    def restore(self, saved: list[torch.Tensor]) -> None:
        for t, s in zip(self.buffers(), saved):
            t.copy_(s)

    def read(self) -> dict:
        """The totals on the host, in one copy: ``layers``, ``launches``
        (grouped products of one expert product), ``rows``, ``groups`` and
        ``rows_max`` (the largest (layer, expert) total of rows)."""
        flat = torch.cat([t.reshape(-1) for t in self.buffers()]).cpu()
        n = self.rows.numel()
        rows, groups, launches = flat[:n], flat[n:2 * n], flat[2 * n:]
        return {"layers": int(self.launches.shape[0]), "launches": int(launches.sum()),
                "rows": int(rows.sum()), "groups": int(groups.sum()),
                "rows_max": int(rows.max())}
