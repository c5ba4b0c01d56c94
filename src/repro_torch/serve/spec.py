"""Speculative-decoding drafters for the continuous serve engine.

A port of the reference's ``serve/spec.py``. A :class:`Drafter` proposes up
to K draft tokens per decode row at each step boundary; the engine packs
``[cur, d_1..d_K]`` into the row as a ``q_len = K+1`` verification chunk
(the shape of a prefill chunk, so the engine keeps its two captured step
widths and B1 carries the chunk), reads the target token at every chunk
position from the one step, commits the longest matching draft prefix and
one token more, and rolls the rejected tail out of the pool
(``PagedKVPool.rollback``: a length decrement and a release of tail
pages, on the host).

* :class:`NgramDrafter`: prompt lookup, the continuation of the most recent
  earlier occurrence of the row's trailing n-gram in its own stream; numpy
  on the host, no device work.
* :class:`ModelDrafter`: a model drafting greedily from its own paged pool
  through its own two-width step, two ``StepGraph``s on the card with
  their own counter, so the target engine's ``compiled_step_count()``
  stays 2. The draft cache is synced lazily: before drafting, the tail it
  holds beyond the longest common prefix with the row's committed stream
  (drafts the target rejected) is rolled back, the rest of the stream is
  caught up in chunks, and K tokens are decoded greedily. Passing the
  target's own ``lm`` and ``params`` is self-speculation, with no second
  copy of the weights.

A drafter may return fewer than K tokens, or none, for a row; the row then
decodes as a plain ``q_len = 1`` row.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.schedule import resolve_order_group
from repro_torch.models.model import build_model
from repro_torch.serve.kv_pool import PagedKVPool, assemble_cache_view
from repro_torch.serve.step_graph import StepGraph

__all__ = ["Drafter", "NgramDrafter", "ModelDrafter", "make_drafter"]


class Drafter:
    """Draft-token proposer, one per engine. ``reset()`` at each
    ``generate`` stream's start, ``release(slot)`` whenever the engine
    retires a slot (finish, preempt, failure), ``draft_batch(items)`` once
    a step boundary with every eligible decode row. Per-slot state keys on
    the slot index: a released slot may serve another request next."""

    def reset(self) -> None:
        """A new stream begins: drop per-slot state."""

    def release(self, slot: int) -> None:
        """``slot`` was retired: drop its state."""

    def draft(self, slot: int, context: np.ndarray, k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing ``context`` (the row's whole
        committed stream, prompt + generated, its last token included)."""
        raise NotImplementedError

    def draft_batch(self, items: Sequence[tuple[int, np.ndarray, int]]) -> dict[int, list[int]]:
        """Drafts for every ``(slot, context, k)``; by default one
        :meth:`draft` each."""
        return {slot: self.draft(slot, ctx, k) for slot, ctx, k in items}


class NgramDrafter(Drafter):
    """Prompt-lookup drafter. For the longest n in ``[ngram_min,
    ngram_max]`` whose trailing n-gram of the context occurred earlier,
    copy from the most recent such occurrence at its lag, the read running
    into the drafts themselves: an L-periodic tail yields all k tokens even
    when fewer than k follow the match."""

    def __init__(self, *, ngram_max: int = 4, ngram_min: int = 1):
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(f"need 1 <= ngram_min <= ngram_max, got [{ngram_min}, {ngram_max}]")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    def draft(self, slot: int, context: np.ndarray, k: int) -> list[int]:
        ctx = np.asarray(context, np.int32)
        n = len(ctx)
        if k < 1 or n < self.ngram_min + 1:
            return []
        for n_gram in range(min(self.ngram_max, n - 1), self.ngram_min - 1, -1):
            pat = ctx[-n_gram:]
            windows = np.lib.stride_tricks.sliding_window_view(ctx, n_gram)
            hits = np.nonzero((windows == pat).all(axis=1))[0]
            hits = hits[hits + n_gram < n]   # not the trailing occurrence itself
            if hits.size:
                lag = n - n_gram - int(hits[-1])
                seq = [int(t) for t in ctx]
                for i in range(k):
                    seq.append(seq[n + i - lag])
                return seq[n:]
        return []


class ModelDrafter(Drafter):
    """A model drafting greedily from its own paged KV pool.

    ``lm``/``params`` share the target's vocabulary; ``lm`` is a
    full-attention token-only model (continuous serving's families). The
    pool keeps one slot per engine slot under ``admission="reserve"`` with
    full-capacity reservations, so draft-side growth never fails. The
    step, at width 1 or ``chunk``, is a :class:`StepGraph` each (captured
    at first use on the card); ``steps`` counts its runs and
    :meth:`compiled_step_count` its graphs."""

    def __init__(
        self,
        lm,
        params,
        *,
        n_slots: int,
        max_len: int,
        page_size: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
    ):
        cfg = lm.cfg
        if cfg.window is not None:
            raise ValueError("ModelDrafter needs full attention (window=None)")
        page = min(page_size or cfg.page_size or cfg.kv_block, max_len)
        paged = cfg.with_(kv_layout="paged", page_size=page)
        self.device = lm.device
        self.lm = build_model(paged, device=self.device)
        self.params = params
        self.n_slots = n_slots
        self.pool = PagedKVPool(paged, cfg.n_layers, n_slots, max_len, device=self.device,
                                prefix_sharing=False, admission="reserve")
        self.chunk = max(1, min(prefill_chunk or 4 * page, max_len))
        self.pad = cfg.eos_id
        # The config's order, staged as data as the engine's steps stage
        # theirs: a Python value in the step would be baked into a capture.
        self._group = resolve_order_group(cfg.attn_order, cfg.snake_group,
                                          self.pool.blocks_per_seq)
        # slot -> tokens whose K/V the draft pool holds (len == pool len)
        self._absorbed: dict[int, list[int]] = {}
        self._steps: dict[int, StepGraph] = {}
        self._graph_pool = None
        self.steps = 0

    # -- lifecycle -----------------------------------------------------------

    def reset(self) -> None:
        for slot in list(self._absorbed):
            self.release(slot)

    def release(self, slot: int) -> None:
        if slot in self._absorbed:
            self.pool.release(slot)
            del self._absorbed[slot]

    # -- the drafter's own ragged step (two widths) ---------------------------

    def compiled_step_count(self) -> int:
        return len(self._steps)

    def step_graphs(self) -> dict:
        return {f"draft/{w}": g for w, g in sorted(self._steps.items())}

    def _step(self, width: int) -> StepGraph:
        step = self._steps.get(width)
        if step is None:
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            pool = self.pool
            n = self.n_slots
            step = StepGraph(
                f"draft step (width {width})", self._step_fn(pool.pages),
                {"tokens": (n, width), "block_table": (n, pool.blocks_per_seq), "lens": (n,),
                 "q_lens": (n,), "order_group": ()},
                device=self.device, state=[t[:, 1:] for t in pool.pages.values()],
                pool=self._graph_pool,
            )
            step.capture()
            self._steps[width] = step
        return step

    def _step_fn(self, pages: dict):
        lm, params = self.lm, self.params

        def step(tokens, block_table, lens, q_lens, order_group):
            caches = assemble_cache_view(pages, block_table, lens, q_lens, order_group)
            logits, _ = lm.decode_step(params, tokens, caches)
            last = torch.clamp(q_lens.long() - 1, min=0)
            rows = logits.gather(1, last[:, None, None].expand(-1, 1, logits.shape[-1]))[:, 0]
            return (torch.argmax(rows, dim=-1).to(torch.int32),)
        return step

    # -- drafting ------------------------------------------------------------

    @torch.no_grad()
    def draft_batch(self, items: Sequence[tuple[int, np.ndarray, int]]) -> dict[int, list[int]]:
        pool = self.pool
        pending: dict[int, list[int]] = {}
        need: dict[int, int] = {}
        out: dict[int, list[int]] = {}
        for slot, ctx, k in items:
            ctx = [int(t) for t in np.asarray(ctx, np.int32)]
            # Drafting d_1..d_k absorbs ctx + d_1..d_{k-1}: clamp k to the
            # pool's capacity.
            k = min(int(k), pool.capacity - len(ctx) + 1)
            if k < 1:
                continue
            absorbed = self._absorbed.get(slot)
            if absorbed is None:
                # The worst case reserved (sharing off: nothing adopted).
                if pool.admit(slot, np.asarray(ctx, np.int32), pool.capacity) is None:
                    continue  # draft pool full: the row is not drafted
                absorbed = self._absorbed[slot] = []
            lcp = 0
            while lcp < len(absorbed) and lcp < len(ctx) and absorbed[lcp] == ctx[lcp]:
                lcp += 1
            if len(absorbed) > lcp:
                # The target rejected drafts (or a restore changed the
                # stream): disown the divergent tail.
                pool.rollback(slot, len(absorbed) - lcp)
                del absorbed[lcp:]
            pending[slot] = ctx[lcp:]
            need[slot] = k
            out[slot] = []
        # Rounds: rows still absorbing context feed a chunk, rows with d_i
        # feed it back (q_len 1) for d_{i+1}; a round's width is 1 or chunk.
        while True:
            feeds: dict[int, list[int]] = {}
            for slot in out:
                if pending[slot]:
                    feeds[slot] = pending[slot][: self.chunk]
                elif out[slot] and len(out[slot]) < need[slot]:
                    feeds[slot] = [out[slot][-1]]
            if not feeds:
                break
            width = 1 if all(len(f) == 1 for f in feeds.values()) else self.chunk
            tokens = np.full((self.n_slots, width), self.pad, np.int32)
            qlens = np.zeros((self.n_slots,), np.int32)
            for slot, seg in feeds.items():
                pool.ensure_writable(slot, len(seg))
                tokens[slot, : len(seg)] = seg
                qlens[slot] = len(seg)
            step = self._step(width)
            step.stage(tokens=tokens, block_table=pool.block_tables, lens=pool.lens, q_lens=qlens,
                       order_group=self._group)
            (toks,) = step()
            toks = toks.cpu().numpy()
            self.steps += 1
            for slot, seg in feeds.items():
                pool.advance(slot, len(seg))
                self._absorbed[slot].extend(seg)
                del pending[slot][: len(seg)]
                if not pending[slot]:
                    out[slot].append(int(toks[slot]))
        return {slot: d[: need[slot]] for slot, d in out.items()}


def make_drafter(
    kind: str,
    *,
    lm=None,
    params=None,
    n_slots: int = 8,
    max_len: int = 1024,
    ngram_max: int = 4,
    page_size: Optional[int] = None,
    prefill_chunk: Optional[int] = None,
) -> Optional[Drafter]:
    """``none`` -> None, ``ngram`` -> :class:`NgramDrafter`, ``model`` ->
    :class:`ModelDrafter` (needs ``lm`` and ``params``)."""
    if kind in (None, "none"):
        return None
    if kind == "ngram":
        return NgramDrafter(ngram_max=ngram_max)
    if kind == "model":
        if lm is None or params is None:
            raise ValueError("drafter kind 'model' needs lm and params")
        return ModelDrafter(lm, params, n_slots=n_slots, max_len=max_len, page_size=page_size,
                            prefill_chunk=prefill_chunk)
    raise ValueError(f"unknown drafter kind {kind!r}")
