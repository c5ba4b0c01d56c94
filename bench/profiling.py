"""One call under ``torch.profiler`` with CUDA activity only, reduced in memory:
the device's busy time (the union of its operations' intervals), device
seconds by operation name, and the idle gaps labelled by the engine's span
that was open on the host at the gap's middle.

The raw Kineto events are read directly (``kineto_results.events()``):
a profiled wave holds up to a few million kernel records, which the
profiler's ``key_averages()`` would turn into Python objects one by one.
No host (CPU) activity is recorded: it slows the host's launches and so
widens the very gaps it would measure; the engine's own spans label them.
Nothing is exported to disk.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import torch

__all__ = ["DeviceProfile", "profile_call"]

_SHORT_GAP_NS = 20_000     # gaps below this are kernel-to-kernel launch gaps
_NAME = 120                # characters of an operation's name kept


@dataclasses.dataclass
class DeviceProfile:
    wall_s: float                    # the profiled call, host clock
    busy_s: float                    # union of device operation intervals in it
    records: int                     # device operation records
    op_s: dict[str, float]           # device seconds by operation name
    idle_by_host: dict[str, float]   # idle seconds by the host span open then

    def seconds_of(self, fragment: str) -> float:
        """Device seconds of the operations whose name holds ``fragment``."""
        return sum(s for name, s in self.op_s.items() if fragment in name)

    def breakdown(self, n: int = 10) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(self.op_s), "idle_gaps": top(self.idle_by_host)}


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _label(spans, starts, mid: int) -> str:
    """The innermost span (latest start) open at ``mid``."""
    i = bisect.bisect_right(starts, mid) - 1
    while i >= 0:
        name, a, b = spans[i]
        if b >= mid:
            return name
        i -= 1
    return "outside engine spans"


def profile_call(fn, tracer):
    """``fn()`` under the profiler; returns (its result, DeviceProfile).
    ``tracer`` is the engine's ``Tracer``, whose spans label the gaps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    offset = time.time_ns() - time.perf_counter_ns()   # Kineto stamps epoch ns
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        out = fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    w0, w1 = t0 + offset, t1 + offset
    op_s: dict[str, float] = {}
    intervals = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        a, b = e.start_ns(), e.end_ns()
        name = e.name()[:_NAME]
        op_s[name] = op_s.get(name, 0.0) + (b - a) / 1e9
        a, b = max(a, w0), min(b, w1)
        if b > a:
            intervals.append((a, b))
    busy = _union(intervals)
    spans = sorted(((ev.name, ev.ts_ns + offset, ev.end_ns + offset)
                    for ev in tracer.events() if ev.dur_ns >= 0), key=lambda s: s[1])
    starts = [s[1] for s in spans]
    idle: dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = ("kernel-to-kernel gaps under 20 us" if b - a < _SHORT_GAP_NS
                 else _label(spans, starts, (a + b) // 2))
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    prof_result = DeviceProfile(
        wall_s=(t1 - t0) / 1e9, busy_s=sum(b - a for a, b in busy) / 1e9,
        records=len(intervals), op_s=op_s, idle_by_host=idle)
    return out, prof_result
