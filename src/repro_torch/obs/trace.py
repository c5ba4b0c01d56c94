"""Span-based tracing with a ring buffer and Chrome-trace JSON export.

The reference's ``repro.obs.trace``, with two additions: a span yields its
args dict, to which its body, or code it hands the dict to, may add (a
step's device times arrive once the card has run it), and the export is
on the Unix epoch's clock.

A :class:`Tracer` records *complete* spans (``ph="X"``: name, start, wall
duration) and *instant* events (``ph="i"``: compiles, admissions, request
lifecycles, watchdog trips) into a bounded ``deque`` — long serve streams
keep the most recent ``capacity`` events instead of growing without bound.
Recording is a ``perf_counter_ns`` pair plus one ``deque.append``; no I/O
happens until :meth:`Tracer.write` exports the buffer as Chrome-trace JSON
(the ``chrome://tracing`` / Perfetto "JSON Array Format": a
``traceEvents`` list of events with microsecond ``ts``/``dur``), so a
whole serve stream can be opened as a timeline.

Events keep ``perf_counter_ns`` stamps (``SpanEvent.ts_ns``); the tracer
holds the offset from that clock to Unix-epoch ns (``epoch_offset_ns``,
taken when it is created and when it is cleared), and :meth:`chrome_trace`
writes ``ts`` in epoch microseconds. ``torch.profiler``'s Chrome export
writes epoch microseconds less the ``baseTimeNanoseconds`` it records:
with that base added back, both lie on one timeline.

Span nesting needs no explicit parent ids: events on the same pid/tid nest
by timestamp containment. The port's serve engine (``serve/engine.py``)
records more spans than the reference's: ``serve.step`` wraps
``serve.admission``, ``serve.plan_step``, ``serve.device_step`` and
``serve.commit``, and each step span (``serve.device_step``,
``serve.decode_step``, ``serve.prefill``) wraps ``serve.stage``,
``serve.replay`` (eager: ``serve.forward``) and ``serve.sync``; a step span
closes only after the step's tokens reach the host, so it covers the
device's work, and on the card carries that work's window from CUDA events
(``device_ns``, ``gap_ns``). Each request's lifecycle is two instants,
``serve.request.admit`` and ``serve.request.finish``.

The port's readers: ``launch/serve.py`` and ``launch/train.py`` write the
buffer out (``--trace-out``); ``bench/`` reads the events in memory, its
per-layer metrics from the untraced waves' spans and its profiler's idle
gaps labelled by the innermost span open at each.
"""

from __future__ import annotations

import collections
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
        self.epoch_offset_ns = _epoch_offset_ns()

    def span(self, name: str, **args) -> "_Span":
        """Record a complete span around the with-body (exceptions included:
        the span still closes, so a crashed step is visible in the trace).
        The with-statement yields the span's args, a dict the body may add
        to; the event keeps that dict."""
        return _Span(self, name, args)

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
        self.epoch_offset_ns = _epoch_offset_ns()

    # ---- export --------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """Chrome-trace "JSON Object Format": ``{"traceEvents": [...]}``.

        Spans export as complete events (``ph="X"``, with ``dur``), instants
        as ``ph="i"`` with thread scope. ``ts``/``dur`` are microseconds
        (floats are legal per the spec), ``ts`` since the Unix epoch; events
        are sorted by ``ts`` as the viewers expect.
        """
        pid = os.getpid()
        out = []
        for ev in sorted(self._events, key=lambda e: e.ts_ns):
            rec = {
                "name": ev.name,
                "cat": "obs",
                "pid": pid,
                "tid": ev.tid,
                "ts": (ev.ts_ns + self.epoch_offset_ns) / 1e3,
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


class _Span:
    """The context manager :meth:`Tracer.span` returns (a class, not a
    generator: the engine opens several a step)."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: Tracer, name: str, args: dict):
        self._tracer, self._name, self._args = tracer, name, args

    def __enter__(self) -> dict:
        self._t0 = time.perf_counter_ns()
        return self._args

    def __exit__(self, *exc) -> bool:
        t0 = self._t0
        self._tracer._append(SpanEvent(name=self._name, ts_ns=t0,
                                       dur_ns=time.perf_counter_ns() - t0,
                                       tid=threading.get_ident(), args=self._args or None))
        return False


def _epoch_offset_ns() -> int:
    """Unix-epoch ns less ``perf_counter_ns``, now."""
    return time.time_ns() - time.perf_counter_ns()


_default = Tracer()


def default_tracer() -> Tracer:
    return _default


def span(name: str, **args):
    """``with obs.span("plan_step"):`` against the process-default tracer."""
    return _default.span(name, **args)


def instant(name: str, **args) -> None:
    _default.instant(name, **args)
