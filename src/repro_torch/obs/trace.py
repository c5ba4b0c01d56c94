"""Span-based tracing with a ring buffer and Chrome-trace JSON export.

A copy of ``repro.obs.trace``; the port's engine records the same spans.

A :class:`Tracer` records *complete* spans (``ph="X"``: name, start, wall
duration) and *instant* events (``ph="i"``: compiles, admissions, watchdog
trips) into a bounded ``deque`` — long serve streams keep the most recent
``capacity`` events instead of growing without bound. Recording is a
``perf_counter_ns`` pair plus one ``deque.append``; no I/O happens until
:meth:`Tracer.write` exports the buffer as Chrome-trace JSON (the
``chrome://tracing`` / Perfetto "JSON Array Format": a ``traceEvents`` list
of events with microsecond ``ts``/``dur``), so a whole serve stream can be
opened as a timeline.

Span nesting needs no explicit parent ids: events on the same pid/tid nest
by timestamp containment, which is exactly how the engine uses it —
``serve.step`` wraps ``serve.plan_step`` and ``serve.device_step`` (the
device span is closed only after the step's outputs are materialized, so it
covers real device time, not async dispatch).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Optional

__all__ = ["SpanEvent", "Tracer", "default_tracer", "span", "instant"]


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    name: str
    ts_ns: int                    # perf_counter_ns at span start
    dur_ns: int                   # -1 for instant events
    tid: int
    args: Optional[dict] = None

    @property
    def end_ns(self) -> int:
        return self.ts_ns + max(self.dur_ns, 0)


class Tracer:
    """Bounded in-process span recorder + Chrome-trace exporter."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events: collections.deque[SpanEvent] = collections.deque(maxlen=capacity)
        self.dropped = 0              # events evicted by the ring buffer

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Record a complete span around the with-body (exceptions included:
        the span still closes, so a crashed step is visible in the trace)."""
        t0 = time.perf_counter_ns()
        try:
            yield self
        finally:
            self._append(
                SpanEvent(
                    name=name,
                    ts_ns=t0,
                    dur_ns=time.perf_counter_ns() - t0,
                    tid=threading.get_ident(),
                    args=args or None,
                )
            )

    def instant(self, name: str, **args) -> None:
        self._append(
            SpanEvent(
                name=name,
                ts_ns=time.perf_counter_ns(),
                dur_ns=-1,
                tid=threading.get_ident(),
                args=args or None,
            )
        )

    def _append(self, ev: SpanEvent) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    def events(self) -> list[SpanEvent]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0

    # ---- export --------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """Chrome-trace "JSON Object Format": ``{"traceEvents": [...]}``.

        Spans export as complete events (``ph="X"``, with ``dur``), instants
        as ``ph="i"`` with thread scope. ``ts``/``dur`` are microseconds
        (floats are legal per the spec); events are sorted by ``ts`` as the
        viewers expect.
        """
        pid = os.getpid()
        out = []
        for ev in sorted(self._events, key=lambda e: e.ts_ns):
            rec = {
                "name": ev.name,
                "cat": "obs",
                "pid": pid,
                "tid": ev.tid,
                "ts": ev.ts_ns / 1e3,
            }
            if ev.dur_ns >= 0:
                rec["ph"] = "X"
                rec["dur"] = ev.dur_ns / 1e3
            else:
                rec["ph"] = "i"
                rec["s"] = "t"
            if ev.args:
                rec["args"] = dict(ev.args)
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


_default = Tracer()


def default_tracer() -> Tracer:
    return _default


def span(name: str, **args):
    """``with obs.span("plan_step"):`` against the process-default tracer."""
    return _default.span(name, **args)


def instant(name: str, **args) -> None:
    _default.instant(name, **args)
