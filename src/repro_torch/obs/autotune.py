"""Persistent autotune cache: shared key normalization + engine-start reader.

A port of ``repro.obs.autotune``, reading the same JSONL schema (the
port's ``obs.export``: ``SCHEMA_VERSION``, ``load_jsonl``).

``benchmarks/hillclimb.py`` appends sweep winners to
``artifacts/hillclimb/autotune_cache.jsonl`` (one stamped JSONL record per
winner, ``obs.export.append_jsonl`` format). This module is the other
half of that contract — the *reader* a serve engine consults at startup to
seed its initial traversal order (DESIGN.md §11) — plus the key
normalization both sides share so writer-side keys and reader-side lookups
can never drift:

* :func:`canonicalize_key` — the canonical JSON-able form of a key dict
  (stable types, insertion-order-free); the hillclimb writer passes its
  keys through this before appending.
* :func:`normalize_autotune_key` — hashable ``(kind, key)`` identity used
  for last-writer-wins dedup on load.
* :func:`load_autotune_cache` — parse + dedup the JSONL; unknown
  ``schema_version`` entries are skipped with a warning, never a crash
  (a newer writer must not brick an older reader).
* :func:`lookup_order_winner` — nearest-bucket lookup for ``order_sweep``
  entries: exact arch match required, then closest (seq_bucket,
  capacity_mib) in log-space, backend match used as a tiebreaker. Sweeps
  are run at a handful of footprints; an engine serving max_len=4096 should
  still benefit from the s8192 sweep next door.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np

from repro_torch.obs.export import SCHEMA_VERSION, load_jsonl

__all__ = [
    "canonicalize_key",
    "normalize_autotune_key",
    "load_autotune_cache",
    "lookup_order_winner",
]


def canonicalize_key(key: dict) -> dict:
    """Canonical JSON-able form of an autotune-cache key dict.

    Ints stay ints (bools are rejected — a key field flipping between
    ``True`` and ``1`` is a schema bug, not a normalization job), floats are
    rounded to 6 places (capacity_mib arithmetic noise must not split cache
    entries), everything else becomes ``str``. Keys are emitted sorted so
    two writers building the same logical key serialize identically.
    """
    out = {}
    for k in sorted(key):
        v = key[k]
        if isinstance(v, bool):
            raise TypeError(f"autotune key field {k!r} is a bool; use an int or str")
        if isinstance(v, (int, np.integer)):
            out[str(k)] = int(v)
        elif isinstance(v, (float, np.floating)):
            out[str(k)] = round(float(v), 6)
        elif v is None:
            out[str(k)] = None
        else:
            out[str(k)] = str(v)
    return out


def normalize_autotune_key(kind: str, key: dict) -> tuple:
    """Hashable identity of one cache entry: ``(kind, sorted key items)``.

    Both the hillclimb writer (via :func:`canonicalize_key`) and the
    :func:`load_autotune_cache` dedup use this, so "same key" means the
    same thing on both sides of the JSONL file.
    """
    canon = canonicalize_key(key)
    return (str(kind), tuple(canon.items()))


def load_autotune_cache(path: str) -> list[dict]:
    """Load + dedup the autotune-cache JSONL; last writer wins per key.

    Returns the surviving records in file order (oldest first). Records
    with an unknown ``schema_version`` are skipped with a warning; records
    without a parseable key/kind are skipped silently (they cannot be
    addressed, so they cannot be looked up either). Missing file -> [].
    """
    try:
        rows = load_jsonl(path)
    except FileNotFoundError:
        return []
    dedup: dict[tuple, dict] = {}
    for rec in rows:
        sv = rec.get("schema_version")
        if sv != SCHEMA_VERSION:
            warnings.warn(
                f"{path}: skipping autotune-cache entry with unknown "
                f"schema_version={sv!r} (reader speaks {SCHEMA_VERSION})",
                stacklevel=2,
            )
            continue
        kind, key = rec.get("kind"), rec.get("key")
        if not isinstance(kind, str) or not isinstance(key, dict):
            continue
        dedup[normalize_autotune_key(kind, key)] = rec
    return list(dedup.values())


def _log_dist(a: float, b: float) -> float:
    """|log2(a/b)| with zero/negative guarded — bucket distances multiply
    across octaves, so nearest-bucket must compare ratios, not differences
    (4096 is 'one octave' from both 2048 and 8192)."""
    a, b = max(float(a), 1e-9), max(float(b), 1e-9)
    return abs(math.log2(a / b))


def lookup_order_winner(
    entries: list[dict],
    *,
    arch: str,
    seq_bucket: int,
    capacity_mib: float,
    backend: Optional[str] = None,
) -> Optional[dict]:
    """Best ``order_sweep`` winner for (arch, seq, capacity[, backend]).

    Exact arch match is required (traversal winners depend on head
    geometry); among those, the entry with the smallest log-space
    (seq_bucket, capacity_mib) distance wins, ties broken toward a matching
    backend. Returns the full record (``rec["winner"]`` holds
    order/snake_group) or None when no arch-matching sweep exists.
    """
    best, best_rank = None, None
    for rec in entries:
        if rec.get("kind") != "order_sweep":
            continue
        key = rec.get("key", {})
        if str(key.get("arch")) != str(arch):
            continue
        rank = (
            _log_dist(key.get("seq_bucket", 0), seq_bucket)
            + _log_dist(key.get("capacity_mib", 0), capacity_mib),
            0 if backend is None or key.get("backend") == backend else 1,
        )
        if best_rank is None or rank < best_rank:
            best, best_rank = rec, rank
    return best
