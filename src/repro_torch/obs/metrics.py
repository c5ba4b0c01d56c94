"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

A copy of ``repro.obs.metrics`` (the port imports nothing of the JAX
package); series names and the snapshot schema are the same.

Zero dependencies, and deliberately *passive*: recording a metric is a plain
Python attribute update on a pre-resolved handle (no locks, no I/O, no
formatting), so the serve/train hot loops can instrument every step without
a measurable cost when no sink is attached. Exporters (``repro_torch.obs.export``)
pull a :meth:`Registry.snapshot` — a plain dict of plain values — whenever
*they* want one; nothing is pushed.

Series are identified by ``(name, labels)``; the rendered form is the
Prometheus-ish ``name{k=v,k2=v2}`` with labels sorted by key, so e.g.
``serve.step.tokens{kind=decode}`` and ``serve.step.tokens{kind=prefill}``
are two independent counters under one name. ``Registry.counter`` /
``gauge`` / ``histogram`` are get-or-create: call once in setup, keep the
handle, and ``inc``/``set``/``observe`` in the loop.

Histograms use fixed upper-bound buckets (cumulative counts at export, raw
per-bucket counts internally) with a default latency ladder spanning 100 µs
to 100 s. NaN observations are *dropped* (and tallied in ``nan_count``):
the engine reports TPOT as NaN for single-token generations, which must not
poison the distribution.
"""

from __future__ import annotations

import bisect
import math
from typing import Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "LATENCY_BUCKETS_S",
    "default_registry",
]

# Default histogram ladder for wall-clock seconds: 1e-4 .. 100 s, roughly
# 1-2-5 per decade — wide enough for CPU-smoke TTFTs and device step times.
LATENCY_BUCKETS_S = (
    1e-4, 2e-4, 5e-4,
    1e-3, 2e-3, 5e-3,
    1e-2, 2e-2, 5e-2,
    0.1, 0.2, 0.5,
    1.0, 2.0, 5.0,
    10.0, 20.0, 50.0, 100.0,
)


def render_series(name: str, labels: dict) -> str:
    """``name{k=v,...}`` with labels sorted by key (bare name if none)."""
    if not labels:
        return name
    body = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{body}}}"


class Counter:
    """Monotonically increasing value (floats allowed: byte counts)."""

    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} decremented by {n}")
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "value")
    kind = "gauge"

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram; ``buckets`` are inclusive upper bounds, with
    an implicit +inf overflow bucket. NaN observations are dropped (counted
    in ``nan_count``) so sentinel values can't skew sums or percentiles."""

    __slots__ = ("name", "labels", "buckets", "counts", "count", "sum", "nan_count")
    kind = "histogram"

    def __init__(self, name: str, labels: dict, buckets=LATENCY_BUCKETS_S):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(buckets):
            raise ValueError(f"histogram {name}: buckets must be strictly increasing")
        self.name = name
        self.labels = labels
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1: overflow
        self.count = 0
        self.sum = 0.0
        self.nan_count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            self.nan_count += 1
            return
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the bucket holding the
        q-th observation; +inf overflow reported as the last finite bound)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return float("nan")
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
        return self.buckets[-1]


class Registry:
    """Get-or-create store of metric handles, keyed by (name, labels)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, labels: dict, **kw):
        key = render_series(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls(name, dict(labels), **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"{key} already registered as a {m.kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets: Optional[tuple] = None, **labels) -> Histogram:
        if buckets is None:
            return self._get(Histogram, name, labels)
        m = self._get(Histogram, name, labels, buckets=buckets)
        if m.buckets != tuple(float(b) for b in buckets):
            raise ValueError(f"{render_series(name, labels)}: conflicting buckets")
        return m

    def series(self) -> list:
        """All registered metric handles, in registration order."""
        return list(self._metrics.values())

    def find(self, name: str, **labels):
        """The handle for an exact series, or None (no creation)."""
        return self._metrics.get(render_series(name, labels))

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Counter/gauge value of an exact series (``default`` if absent)."""
        m = self.find(name, **labels)
        return default if m is None else m.value

    def snapshot(self) -> dict:
        """Plain-dict view: ``{"counters": {series: value}, "gauges": {...},
        "histograms": {series: {"buckets": [[le, cumulative], ...],
        "count": n, "sum": s, "nan_count": k}}}`` — JSON-serializable,
        detached from the live handles."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, m in self._metrics.items():
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            else:
                cum, cumulative = 0, []
                # "+Inf" as a string: strict-JSON sinks reject Infinity.
                for le, c in zip(m.buckets + ("+Inf",), m.counts):
                    cum += c
                    cumulative.append([le, cum])
                out["histograms"][key] = {
                    "buckets": cumulative,
                    "count": m.count,
                    "sum": m.sum,
                    "nan_count": m.nan_count,
                }
        return out

    def reset(self) -> None:
        self._metrics.clear()


_default = Registry()


def default_registry() -> Registry:
    """The process-wide registry (components default to their own private
    registries; this one backs the module-level convenience handles)."""
    return _default
