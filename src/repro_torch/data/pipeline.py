"""Deterministic synthetic LM data pipeline with packing + host prefetch.

A copy of ``repro.data.pipeline`` (numpy only): the same counter-based
Philox stream keyed on (seed, host, step), so the port's batches equal the
reference's bit for bit.

Production shape without production data: token streams are generated from a
counter-based RNG keyed on (seed, host, step) so every host produces its own
disjoint shard deterministically — restartable from any step with no state
file (exactly how a real sharded webdataset reader would be keyed), which is
what checkpoint-resume and elastic re-mesh rely on.

Documents get Zipf-ish token statistics and geometric lengths, packed
into fixed-length rows with EOS separators (no padding waste). A background
thread keeps a small prefetch queue ahead of the training loop.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticPacked", "make_batch_iterator"]

EOS = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    host_index: int = 0
    host_count: int = 1


class SyntheticPacked:
    """Deterministic packed-batch source; index-addressable by step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.host_count:
            raise ValueError("global_batch must divide across hosts")
        self.per_host = cfg.global_batch // cfg.host_count

    def _rng(self, step: int) -> np.random.Generator:
        c = self.cfg
        seed_seq = np.random.SeedSequence(
            entropy=c.seed, spawn_key=(c.host_index, step)
        )
        return np.random.Generator(np.random.Philox(seed_seq))

    def batch(self, step: int) -> dict:
        """Tokens (per_host_batch, seq_len) int32, packed documents."""
        c = self.cfg
        rng = self._rng(step)
        rows = np.empty((self.per_host, c.seq_len), np.int32)
        for r in range(self.per_host):
            row = []
            while len(row) < c.seq_len:
                doc_len = 1 + min(
                    int(rng.geometric(1.0 / c.mean_doc_len)), 4 * c.mean_doc_len
                )
                # Zipf-ish: squash uniform^2 toward frequent ids; ids 0/1 reserved
                u = rng.random(doc_len)
                toks = 2 + (u * u * (c.vocab - 2)).astype(np.int64)
                row.extend(toks.tolist())
                row.append(EOS)
            rows[r] = np.asarray(row[: c.seq_len], np.int32)
        return {"tokens": rows}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_batch_iterator(
    cfg: DataConfig, *, start_step: int = 0, prefetch: int = 2
) -> Iterator[dict]:
    """Background-thread prefetching iterator, resumable at ``start_step``."""
    src = SyntheticPacked(cfg)
    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            try:
                q.put(src.batch(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _Iter()
