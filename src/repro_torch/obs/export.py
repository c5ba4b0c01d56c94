"""Sinks: registry → JSONL metrics dump, and a shared JSONL record format.

The reference's ``repro.obs.export``, with the same line format.

The registry/tracer never write anything themselves; these helpers (and
``Tracer.write`` for spans) are the only place bytes leave the process, so
the no-sink serve path stays free of I/O. Two consumers share one line
format:

* ``write_metrics_jsonl(registry, path)`` — one line per metric series
  (``{"schema_version", "ts", "kind", "name", "labels", ...value fields}``),
  written by the port's launchers (``launch/serve.py --metrics-out``);
  the benchmark (``bench/``) reads the engine's spans and results in
  memory and writes no file;
* ``append_jsonl(path, record)`` — append one stamped record: the
  autotune cache's format (``artifacts/hillclimb/autotune_cache.jsonl``),
  which ``obs.autotune`` reads at engine start to seed the traversal
  order.

``SCHEMA_VERSION`` covers both: bump it when a field changes meaning, and
trend-line tooling can partition on it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterator, Optional

from repro_torch.obs.metrics import Registry, render_series

__all__ = [
    "SCHEMA_VERSION",
    "metric_records",
    "write_metrics_jsonl",
    "append_jsonl",
    "load_jsonl",
]

SCHEMA_VERSION = 1


def metric_records(
    registry: Registry, *, ts: Optional[float] = None, extra: Optional[dict] = None
) -> Iterator[dict]:
    """One JSON-ready dict per registered series."""
    ts = time.time() if ts is None else ts
    for m in registry.series():
        rec = {
            "schema_version": SCHEMA_VERSION,
            "ts": ts,
            "kind": m.kind,
            "name": m.name,
            "labels": dict(m.labels),
            "series": render_series(m.name, m.labels),
        }
        if m.kind == "histogram":
            cum, buckets = 0, []
            for le, c in zip(m.buckets + ("+Inf",), m.counts):
                cum += c
                buckets.append([le, cum])
            rec.update(
                buckets=buckets, count=m.count, sum=m.sum, nan_count=m.nan_count
            )
        else:
            rec["value"] = m.value
        if extra:
            rec.update(extra)
        yield rec


def write_metrics_jsonl(
    registry: Registry, path: str, *, extra: Optional[dict] = None
) -> int:
    """Dump every series as one JSONL line; returns the line count."""
    n = 0
    with open(path, "w") as f:
        for rec in metric_records(registry, extra=extra):
            f.write(json.dumps(rec) + "\n")
            n += 1
    return n


def append_jsonl(path: str, record: dict, *, kind: str) -> dict:
    """Append one ``kind``-tagged record, stamped with schema version and
    wall time. Returns the stamped record."""
    rec = {"schema_version": SCHEMA_VERSION, "ts": time.time(), "kind": kind}
    rec.update(record)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return rec


def load_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
