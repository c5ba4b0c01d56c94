"""Token-budget continuous batching scheduler (numpy and Python only).

A line-for-line port of ``repro.serve.scheduler.ContinuousScheduler``. Each
request gets a *slot* in a persistent ragged batch, and one mixed step is
planned at a time: every decoding slot contributes one q_len=1 row, and the
rest of the token budget is dealt to prompts as chunks of up to
``prefill_chunk`` tokens, round-robin across the slots still prefilling. A
long prompt advances chunk by chunk while decode rows keep emitting.
Admission is FIFO in arrival order; ``Request.arrival`` (a step number)
holds a request out of the queue until the engine's step counter reaches it.
A *suspended* slot stays placed (it counts against admission and keeps its
``Slot``) but is left out of step plans until it is resumed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = ["Slot", "StepItem", "ContinuousScheduler"]


@dataclasses.dataclass
class Slot:
    """One running sequence in the continuous batch."""

    request: object                   # serve.engine.Request
    eos_id: int
    new_limit: int                    # clamped max_new_tokens
    prompt: np.ndarray = None         # clamped prompt tokens (1D int32)
    prompt_pos: int = 0               # prompt tokens already in cache
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    n_prior: int = 0                  # generated tokens a restore put into
                                      # ``prompt``: a drafter's context is
                                      # prompt + generated[n_prior:]

    @property
    def prefilling(self) -> bool:
        """Still working through the prompt (no token sampled yet)."""
        return self.prompt is not None and self.prompt_pos < len(self.prompt)

    def record(self, token: int) -> bool:
        """Append a token; returns True when the sequence is finished."""
        self.generated.append(token)
        if token == self.eos_id or len(self.generated) >= self.new_limit:
            self.done = True
        return self.done


@dataclasses.dataclass(frozen=True)
class StepItem:
    """One row of a planned mixed step."""

    slot: int
    q_len: int
    is_prefill: bool
    finishes_prompt: bool = False     # the chunk covers the prompt's last
                                      # token -> the row samples this step
    n_draft: int = 0                  # draft tokens verified in this decode
                                      # row: q_len == 1 + n_draft


class ContinuousScheduler:
    """Admission queue + slot lifecycle + per-step token budgeting."""

    def __init__(
        self,
        n_slots: int,
        *,
        token_budget: Optional[int] = None,
        prefill_chunk: int = 64,
    ):
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.n_slots = n_slots
        self.prefill_chunk = prefill_chunk
        # Default: every decode row plus one full prefill chunk per step.
        self.token_budget = token_budget or (n_slots + prefill_chunk)
        if self.token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        self.waiting: list = []
        self.slots: list[Optional[Slot]] = [None] * n_slots
        # Placed slots excluded from step plans (``suspend``/``resume``).
        self.suspended: set[int] = set()
        self._rr = 0                  # round-robin cursor over prefill slots

    def submit(self, requests: Sequence) -> None:
        self.waiting.extend(requests)
        # FIFO in arrival order; the stable sort keeps submission order
        # within one arrival step.
        self.waiting.sort(key=lambda r: getattr(r, "arrival", 0))

    # ---- queries -------------------------------------------------------------

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def runnable_slots(self) -> list[int]:
        """Active slots eligible for step plans (suspended ones left out)."""
        return [i for i, s in enumerate(self.slots) if s is not None and i not in self.suspended]

    def next_arrival(self) -> Optional[int]:
        return getattr(self.waiting[0], "arrival", 0) if self.waiting else None

    def pop_admissible(self, step: int) -> Optional[object]:
        """Next waiting request whose arrival time has passed, if any."""
        if self.waiting and getattr(self.waiting[0], "arrival", 0) <= step:
            return self.waiting.pop(0)
        return None

    def requeue(self, request) -> None:
        """Put an admissible-but-unplaceable request back at the queue head
        (no pages free yet — admission stays FIFO, no overtaking). Preempted
        requests land here too: they restart before later arrivals."""
        self.waiting.insert(0, request)

    def drain_waiting(self, pred) -> list:
        """Remove and return every waiting request matching ``pred``."""
        hit = [r for r in self.waiting if pred(r)]
        if hit:
            self.waiting = [r for r in self.waiting if not pred(r)]
        return hit

    def shed_over(self, step: int, max_queue: int) -> list:
        """Load-shed: drop the newest *arrived* requests beyond ``max_queue``
        (FIFO order is preserved for the survivors)."""
        arrived = [r for r in self.waiting if getattr(r, "arrival", 0) <= step]
        if len(arrived) <= max_queue:
            return []
        shed = arrived[max_queue:]
        drop = set(map(id, shed))
        self.waiting = [r for r in self.waiting if id(r) not in drop]
        return shed

    # ---- step planning -------------------------------------------------------

    def plan_step(self, draft_lens: Optional[dict] = None) -> list[StepItem]:
        """Plan one ragged mixed step under the token budget.

        Decode rows come first (one token each); the leftover budget is
        dealt to prefilling slots round-robin in chunks of up to
        ``prefill_chunk`` tokens. When decode rows alone exhaust the budget,
        prefill waits — decode slots retire in bounded time and hand their
        budget back. If only prefill slots are active the budget is theirs.

        ``draft_lens`` (slot -> K draft tokens) makes decode rows ``q_len =
        1 + K`` verification chunks, K clamped to ``prefill_chunk - 1`` (the
        row fits the wide width) and to the budget left after every decode
        row's one token, so a draft never pushes a decode row out.
        """
        decode_rows: list[int] = []
        prefill_rows: list[int] = []
        for i, st in enumerate(self.slots):
            if st is None or st.done or i in self.suspended:
                continue
            (prefill_rows if st.prefilling else decode_rows).append(i)
        items = []
        spare = self.token_budget - len(decode_rows)
        for i in decode_rows:
            k = 0
            if draft_lens:
                k = min(max(int(draft_lens.get(i, 0)), 0), self.prefill_chunk - 1,
                        max(spare, 0))
                spare -= k
            items.append(StepItem(i, 1 + k, False, n_draft=k))
        left = self.token_budget - sum(it.q_len for it in items)
        if not prefill_rows or left <= 0:
            return items
        # Rotate so successive steps serve prefilling slots fairly.
        order = sorted(prefill_rows, key=lambda i: (i - self._rr) % self.n_slots)
        for slot in order:
            if left <= 0:
                break
            st = self.slots[slot]
            n = min(self.prefill_chunk, len(st.prompt) - st.prompt_pos, left)
            items.append(
                StepItem(
                    slot,
                    n,
                    True,
                    finishes_prompt=st.prompt_pos + n >= len(st.prompt),
                )
            )
            left -= n
            self._rr = (slot + 1) % self.n_slots
        return items

    # ---- lifecycle -----------------------------------------------------------

    def place(
        self,
        slot: int,
        request,
        *,
        eos_id: int,
        new_limit: int,
        prompt: Optional[np.ndarray] = None,
        prompt_pos: int = 0,
    ) -> Slot:
        assert self.slots[slot] is None, f"slot {slot} occupied"
        st = Slot(
            request=request,
            eos_id=eos_id,
            new_limit=new_limit,
            prompt=None if prompt is None else np.asarray(prompt, np.int32),
            prompt_pos=prompt_pos,
        )
        self.slots[slot] = st
        return st

    def suspend(self, slot: int) -> None:
        """Leave a placed slot out of step plans until :meth:`resume`."""
        assert self.slots[slot] is not None, f"slot {slot} is empty"
        self.suspended.add(slot)

    def resume(self, slot: int) -> None:
        """Return a suspended slot to step planning."""
        self.suspended.discard(slot)

    def retire(self, slot: int) -> Slot:
        st = self.slots[slot]
        assert st is not None
        self.slots[slot] = None
        self.suspended.discard(slot)
        return st
