"""The per-layer metrics read from the engine's own trace (``step_gap_share``,
``itl_p50_ms``, ``itl_p99_ms``, ``queue_wait_mean_ms``,
``wide_step_pad_share``, ``prefill_pad_share``): each reader on waves built
by hand, on the trace of an engine that records none of it (each returns
``None``), and on the CPU runs of the tiny cells, where every one but
``step_gap_share`` (CUDA events) reads; and the profiler's gap labels,
which name the innermost span (now a sub-span of the step) and never an
instant."""

import time

import numpy as np
import pytest
import torch

import portbench_cells
from bench import profiling
from bench.harness import Bench, RunRecord, WaveRecord, run_cell
from bench.spec import load_reader
from repro_torch.obs.trace import SpanEvent

NEW = ("step_gap_share", "itl_p50_ms", "itl_p99_ms", "queue_wait_mean_ms",
       "wide_step_pad_share", "prefill_pad_share")


def _span(name, ts, dur, **args):
    return SpanEvent(name=name, ts_ns=ts, dur_ns=dur, tid=0, args=args or None)


def _instant(name, ts, **args):
    return SpanEvent(name=name, ts_ns=ts, dur_ns=-1, tid=0, args=args)


def _run(*waves):
    """A RunRecord of waves given as (start_s, end_s, events)."""
    return RunRecord(None, None, [WaveRecord(a, b, [], ev, None) for a, b, ev in waves],
                     None, None)


def _read(name, run):
    return load_reader(name)(run)


def test_step_gap_share_by_hand():
    run = _run((0.0, 1.0, [_span("serve.device_step", 0, 10, width=1, gap_ns=10_000_000),
                           _span("serve.device_step", 20, 10, width=16, gap_ns=20_000_000),
                           _span("serve.step", 0, 40, gap_ns=999_000_000)]),
               (5.0, 6.0, [_span("serve.prefill", 0, 10, rows=8, bucket=4, gap_ns=30_000_000),
                           _span("serve.decode_step", 20, 10, t=0, gap_ns=40_000_000)]))
    assert _read("step_gap_share", run) == pytest.approx(0.1 / 2.0)


def test_token_gaps_by_hand():
    ok = [(0, 10, 30, 60), (5, 6)]
    run = _run((0.0, 1.0, [_instant("serve.request.finish", 0, rid=i, status="ok",
                                    token_ns=tuple(x * 1_000_000 for x in t))
                           for i, t in enumerate(ok)]
                + [_instant("serve.request.finish", 0, rid=9, status="deadline",
                            token_ns=(0, 10**9)),
                   _instant("serve.request.finish", 0, rid=8, status="ok", token_ns=(7,))]))
    gaps = [10, 20, 30, 1]
    assert _read("itl_p50_ms", run) == pytest.approx(np.percentile(gaps, 50))
    assert _read("itl_p99_ms", run) == pytest.approx(np.percentile(gaps, 99))


def test_queue_wait_mean_by_hand():
    admit = lambda rid, w: _instant("serve.request.admit", 0, rid=rid, slot=0, wait_ns=w)
    # rid 1 preempted once (its waits summed); rid 1 of the next wave is
    # another request
    run = _run((0.0, 1.0, [admit(1, 2_000_000), admit(2, 0), admit(1, 4_000_000)]),
               (1.0, 2.0, [admit(1, 3_000_000)]))
    assert _read("queue_wait_mean_ms", run) == pytest.approx((6 + 0 + 3) / 3)


def test_pad_shares_by_hand():
    run = _run((0.0, 1.0, [
        _span("serve.device_step", 0, 1, width=16, rows=2, tokens=8, positions=32),
        _span("serve.device_step", 2, 1, width=16, rows=2, tokens=24, positions=32),
        _span("serve.device_step", 4, 1, width=1, rows=2, tokens=2, positions=2),
        _span("serve.prefill", 6, 1, rows=8, bucket=3584, positions=28_672, tokens=14_069)]))
    assert _read("wide_step_pad_share", run) == pytest.approx(1 - 32 / 64)
    assert _read("prefill_pad_share", run) == pytest.approx(1 - 14_069 / 28_672)


def test_a_trace_without_them_reads_none():
    """An engine that records no device window, token time, wait or
    positions (the spans and args it had before): every reader returns
    None, and none raises."""
    run = _run((0.0, 1.0, [_span("serve.step", 0, 50, step=0),
                           _span("serve.device_step", 0, 40, width=16, rows=2, tokens=9),
                           _span("serve.prefill", 60, 40, rows=2, bucket=8),
                           _span("serve.decode_step", 110, 4, t=0),
                           _instant("serve.compile", 0, step="mixed", variants=1)]))
    assert {name: _read(name, run) for name in NEW} == dict.fromkeys(NEW)


@pytest.mark.parametrize("workload,reads", [
    ("deepseek-7b.chat", {"itl_p50_ms", "itl_p99_ms", "queue_wait_mean_ms",
                          "wide_step_pad_share"}),
    ("deepseek-7b.long-prompt", {"itl_p50_ms", "itl_p99_ms", "prefill_pad_share"}),
])
def test_run_cell_reports_them_on_the_cpu(workload, reads):
    cell = portbench_cells.tiny_cell(workload)
    assert {m["name"] for m in cell.per_layer} & set(NEW) == reads | {"step_gap_share"}
    out, _ = run_cell(cell, 2**32 + 3, 0.3, True, device="cpu")
    got = {name for name in out["metrics"] if name in NEW}
    assert got == reads  # step_gap_share needs the card's events
    for name in got:
        assert out["metrics"][name]["value"] >= 0.0
    for name in reads & {"wide_step_pad_share", "prefill_pad_share"}:
        assert 0.0 <= out["metrics"][name]["value"] < 1.0


def test_prefill_pad_share_is_the_served_padding():
    b = Bench(portbench_cells.tiny_cell("deepseek-7b.long-prompt"), "cpu")
    b.warm_up()
    wave, _ = b.serve(b.wave(2**31 + 7, 0))
    run = _run((wave.start, wave.end, wave.spans))
    groups = [wave.served[i:i + b.slots] for i in range(0, len(wave.served), b.slots)]
    positions = sum(b.slots * len(g[0].prompt) for g in groups)
    tokens = sum(min(s.prompt_len, len(s.prompt)) for s in wave.served)
    assert _read("prefill_pad_share", run) == pytest.approx(1 - tokens / positions)


class _DeviceOp:
    def __init__(self, a, b):
        self.a, self.b = a, b

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def name(self):
        return "kernel"


EPOCH = 1_760_000_000 * 10**9


class _Clock:
    """``profiling``'s clocks, whose ``time_ns() - perf_counter_ns()``
    (called in that order, as ``profile_call`` takes its offset) is EPOCH
    exactly: the admit gap's middle then falls on the instant itself."""

    def __init__(self):
        self.last = None

    def time_ns(self):
        self.last = time.perf_counter_ns()
        return self.last + EPOCH

    def perf_counter_ns(self):
        now, self.last = self.last, None
        return time.perf_counter_ns() if now is None else now


def test_gaps_are_named_by_the_sub_span_and_never_an_instant(monkeypatch):
    """``profile_call`` on the CPU with a stand-in profiler whose device is
    busy all through the wave but for two gaps: the middle half of a
    ``serve.replay`` and 30 us centred on a ``serve.request.admit`` instant
    (inside ``serve.admission``)."""
    b = Bench(portbench_cells.tiny_cell("deepseek-7b.chat"), "cpu")
    b.warm_up()
    reqs = b._requests(b.wave(2**31 + 11, 0))

    class Profile:
        def __init__(self, activities):
            self.profiler = self.kineto_results = self

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            ev = b.tracer.events()
            replay = next(e for e in ev if e.name == "serve.replay")
            admit = next(e for e in ev if e.name == "serve.request.admit")
            quarter = replay.dur_ns // 4
            gaps = sorted([(replay.ts_ns + quarter, replay.end_ns - quarter),
                           (admit.ts_ns - 15_000, admit.ts_ns + 15_000)])
            first, last = min(e.ts_ns for e in ev), max(e.end_ns for e in ev)
            edges = [first - 10**9] + [x for g in gaps for x in g] + [last + 10**9]
            return [_DeviceOp(a + EPOCH, c + EPOCH) for a, c in zip(edges[0::2], edges[1::2])]

    monkeypatch.setattr(profiling, "time", _Clock())
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    b.tracer.clear()
    _, prof = profiling.profile_call(lambda: b.engine.generate(reqs), b.tracer)
    assert set(prof.idle_by_host) == {"serve.replay", "serve.admission"}
    assert prof.idle_by_host["serve.admission"] == pytest.approx(30e-6, abs=1e-9)
