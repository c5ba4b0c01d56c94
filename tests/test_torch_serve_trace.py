"""What the serve engine records of itself (``repro_torch.serve.engine``,
``serve.step_graph.DeviceClock``, ``obs.trace``), on the CPU.

Both engines serve a few requests on deepseek-7b ``.reduced()`` and their
traces are held to what the engine promises:

* each step span (``serve.device_step``, ``serve.decode_step``,
  ``serve.prefill``) holds ``serve.stage``, ``serve.replay`` (the eager
  prefill: ``serve.forward``) and ``serve.sync``, in that order, and each
  ``serve.step`` its ``serve.admission`` before and ``serve.commit`` after
  its device step;
* each request has one ``serve.request.finish`` and at least one
  ``serve.request.admit`` under its rid; ``token_ns`` has one entry a
  token, never decreases, and its first entry is ``ttft_s``; ``wait_ns``
  is near 0 for a request admitted at the first boundary, covers the steps
  a request waited through for a slot, starts at the boundary of its
  arrival step, and a preempted request's waits are summed into
  ``queue_s``;
* ``positions`` and ``tokens`` count what each step computes and serves;
* the device windows: on the CPU no step carries ``device_ns``/``gap_ns``;
  with stand-in events that stamp the host clock where the card's would be
  recorded, every step carries both, each window lies where its step's
  staging and replay are, the static decode step's first window opens
  before the prefill's caches are copied in, and no event is recorded
  inside a capture;
* ``chrome_trace()`` stamps ``ts`` on the Unix epoch, and the request
  instants export as plain JSON;
* the captured steps, now recording events, still read no host value.
"""

import collections
import json
import math
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.obs import Tracer
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.step_graph import DeviceClock
from test_torch_step_graph import NoHostRead

ENGINES = {
    "continuous": dict(scheduler="continuous", batch_size=2, max_len=96, page_size=8,
                       prefill_chunk=16),
    "static": dict(scheduler="static", batch_size=2, max_len=64),
}
STEP = {"continuous": ("serve.device_step",), "static": ("serve.decode_step", "serve.prefill")}
# The optimistic geometry of tests/test_torch_resilience.py: 4 allocatable
# pages of 16 for 2 slots whose rows grow to 4 pages each.
TINY_POOL = dict(scheduler="continuous", batch_size=2, max_len=64, page_size=16,
                 prefill_chunk=16, pool_pages=4, admission="optimistic", max_preemptions=10)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _Event:
    """A stand-in for ``torch.cuda.Event``: ``record`` stamps the host
    clock (or the value of ``now``), ``elapsed_time`` in ms as CUDA's."""

    now = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns() if _Event.now is None else _Event.now

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def _stand_in_events(mp, clock: DeviceClock, capturing: bool = False) -> DeviceClock:
    """``clock`` as on the card, with stand-in events (``mp``: a
    MonkeyPatch for the CUDA calls it makes)."""
    clock.on_card = True
    clock._ring = [_Event() for _ in range(16)]
    mp.setattr(torch.cuda, "current_stream", lambda *a, **k: None)
    mp.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    return clock


@pytest.fixture(scope="module")
def model():
    lm = build_model(get_config("deepseek-7b").reduced(), device="cpu")
    return lm, lm.init(0)


def _requests(vocab, n=5, *, seed=3, plen=lambda i: 5 + 7 * i, new=lambda i: 3 + i, **kw):
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(2, vocab, size=plen(i)).astype(np.int32),
                    max_new_tokens=new(i), rid=10 + i, **{k: v(i) for k, v in kw.items()})
            for i in range(n)]


def _serve(model, engine_kw, requests, events=True):
    """One generate() of ``requests``: (engine, results, the trace's events,
    generate()'s wall in ns). ``events``: stand-in events on the clock."""
    lm, params = model
    eng = ServeEngine(lm, params, device="cpu", **engine_kw)
    with pytest.MonkeyPatch.context() as mp:
        if events:
            _stand_in_events(mp, eng._clock)
        t = time.perf_counter_ns()
        res = eng.generate(requests)
        wall = time.perf_counter_ns() - t
    return eng, res, eng.tracer.events(), wall


@pytest.fixture(scope="module")
def runs(model):
    vocab = model[0].cfg.vocab
    return {name: (_requests(vocab),) + _serve(model, kw, _requests(vocab))
            for name, kw in ENGINES.items()}


def _spans(events, *names):
    return [e for e in events if e.dur_ns >= 0 and (not names or e.name in names)]


def _instants(events, name):
    return [e for e in events if e.dur_ns < 0 and e.name == name]


def _inside(a, b) -> bool:
    return b.ts_ns <= a.ts_ns and a.end_ns <= b.end_ns


# ---- spans ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", list(ENGINES))
def test_sub_spans_nest_in_their_step(runs, scheduler):
    _, _, _, events, _ = runs[scheduler]
    steps = _spans(events, *STEP[scheduler])
    subs = _spans(events, "serve.stage", "serve.replay", "serve.forward", "serve.sync")
    assert steps and len(subs) == 3 * len(steps)
    for s in subs:
        assert sum(_inside(s, st) for st in steps) == 1, s
    for st in steps:
        inner = sorted((s for s in subs if _inside(s, st)), key=lambda s: s.ts_ns)
        middle = "serve.forward" if st.name == "serve.prefill" else "serve.replay"
        assert [s.name for s in inner] == ["serve.stage", middle, "serve.sync"]
        assert all(a.end_ns <= b.ts_ns for a, b in zip(inner, inner[1:]))
    if scheduler == "continuous":
        bounds = _spans(events, "serve.step")
        for b in bounds:
            within = sorted((s for s in _spans(events) if s is not b and _inside(s, b)
                             and s.name in ("serve.admission", "serve.device_step",
                                            "serve.commit")), key=lambda s: s.ts_ns)
            assert [s.name for s in within] == ["serve.admission", "serve.device_step",
                                                "serve.commit"]
            assert all(a.end_ns <= c.ts_ns for a, c in zip(within, within[1:]))


@pytest.mark.parametrize("scheduler", list(ENGINES))
def test_existing_spans_keep_their_args(runs, scheduler):
    _, _, _, events, _ = runs[scheduler]
    if scheduler == "continuous":
        for e in _spans(events, "serve.device_step"):
            assert {"width", "rows", "tokens", "positions"} <= set(e.args)
    else:
        assert all({"rows", "bucket"} <= set(e.args) for e in _spans(events, "serve.prefill"))
        assert all("t" in e.args for e in _spans(events, "serve.decode_step"))


# ---- requests ------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", list(ENGINES))
def test_each_request_is_admitted_and_finishes_once(runs, scheduler):
    reqs, _, res, events, _ = runs[scheduler]
    finishes = collections.Counter(e.args["rid"] for e in _instants(events, "serve.request.finish"))
    admits = collections.Counter(e.args["rid"] for e in _instants(events, "serve.request.admit"))
    rids = {r.rid for r in reqs}
    assert set(finishes) == set(admits) == rids
    assert all(n == 1 for n in finishes.values()) and all(n >= 1 for n in admits.values())
    by_rid = {e.args["rid"]: e.args for e in _instants(events, "serve.request.finish")}
    for r in res:
        assert by_rid[r.rid]["status"] == r.status == "ok"


@pytest.mark.parametrize("scheduler", list(ENGINES))
def test_token_times(runs, scheduler):
    _, _, res, events, wall = runs[scheduler]
    by_rid = {e.args["rid"]: e.args["token_ns"] for e in _instants(events, "serve.request.finish")}
    for r in res:
        ns = by_rid[r.rid]
        assert isinstance(ns, tuple) and all(isinstance(x, int) for x in ns)
        assert len(ns) == len(r.token_s) == len(r.tokens) == r.steps > 0
        assert list(ns) == sorted(ns) and 0 < ns[-1] <= wall
        assert r.token_s == tuple(x / 1e9 for x in ns)
        assert r.token_s[0] == r.ttft_s
    # one clock reading a step: a step's tokens share it, two steps differ
    steps = len(_spans(events, *STEP[scheduler]))
    assert len({x for ns in by_rid.values() for x in ns}) <= steps
    assert all(len(set(ns)) == len(ns) for ns in by_rid.values())


def test_queue_waits_of_the_continuous_engine(runs):
    _, _, res, events, _ = runs["continuous"]
    admits = {e.args["rid"]: e for e in _instants(events, "serve.request.admit")}
    steps = _spans(events, "serve.device_step")
    first, waiters = [admits[10], admits[11]], [admits[r] for r in (12, 13, 14)]
    for a in first:  # admitted at the first boundary, before any step
        assert a.ts_ns <= steps[0].ts_ns
        assert 0 <= a.args["wait_ns"] < min(w.args["wait_ns"] for w in waiters)
    for w in waiters:  # waited for a slot through every step before it
        before = sum(s.dur_ns for s in steps if s.end_ns <= w.ts_ns)
        assert w.args["wait_ns"] >= before > 0
    # every request arrived at generate()'s entry: one ready time
    ready = [a.ts_ns - a.args["wait_ns"] for a in admits.values()]
    assert max(ready) - min(ready) < 10_000_000
    for r in res:
        assert r.queue_s == admits[r.rid].args["wait_ns"] / 1e9


def test_queue_waits_of_the_static_engine(runs):
    _, _, res, events, _ = runs["static"]
    waits = {e.args["rid"]: e.args["wait_ns"] for e in _instants(events, "serve.request.admit")}
    prefills = _spans(events, "serve.prefill")
    assert waits[10] == waits[11] < waits[12] == waits[13] < waits[14]
    # a group waits until its prefill starts: through the groups before it
    t0 = prefills[0].ts_ns - waits[10]
    for g, rid in enumerate((10, 12, 14)):
        assert abs(prefills[g].ts_ns - (t0 + waits[rid])) < 10_000_000
    for r in res:
        assert r.queue_s == waits[r.rid] / 1e9


def test_arrival_step_sets_when_a_request_is_ready(model):
    reqs = _requests(model[0].cfg.vocab, 2, new=lambda i: 8, arrival=lambda i: 3 * i)
    _, res, events, _ = _serve(model, ENGINES["continuous"], reqs)
    late = next(e for e in _instants(events, "serve.request.admit") if e.args["rid"] == 11)
    boundary = next(e for e in _spans(events, "serve.step") if e.args["step"] == 3)
    assert boundary.ts_ns <= late.ts_ns - late.args["wait_ns"] <= late.ts_ns <= boundary.end_ns
    assert res[1].queue_s < boundary.dur_ns / 1e9


def test_a_preempted_request_sums_its_waits(model):
    reqs = _requests(model[0].cfg.vocab, 3, seed=11, plen=lambda i: 24, new=lambda i: 24)
    eng, res, events, _ = _serve(model, TINY_POOL, reqs)
    assert eng.last_stats.preemptions >= 2
    admits = collections.defaultdict(list)
    for e in _instants(events, "serve.request.admit"):
        admits[e.args["rid"]].append(e.args["wait_ns"])
    preempted = [r for r in res if r.n_preemptions]
    assert preempted and all(r.status == "ok" for r in res)
    for r in res:
        assert len(admits[r.rid]) == r.n_preemptions + 1
        assert r.queue_s == sum(admits[r.rid]) / 1e9
        assert len(r.token_s) == len(r.tokens) and list(r.token_s) == sorted(r.token_s)
    for r in preempted:  # each requeue waited behind a step at least
        assert min(admits[r.rid][1:]) > 0


# ---- counters ------------------------------------------------------------------------


def test_positions_and_tokens_of_the_continuous_step(runs):
    _, eng, _, events, _ = runs["continuous"]
    steps = _spans(events, "serve.device_step")
    for e in steps:
        assert e.args["positions"] == ENGINES["continuous"]["batch_size"] * e.args["width"]
        assert e.args["tokens"] <= e.args["positions"]
    planned = sum(e.args["tokens"] for e in steps)
    assert planned == (eng.obs.value("serve.step.tokens", kind="decode")
                       + eng.obs.value("serve.step.tokens", kind="prefill"))


def test_positions_and_tokens_of_the_static_prefill(runs):
    reqs, _, _, events, _ = runs["static"]
    b = ENGINES["static"]["batch_size"]
    prefills = _spans(events, "serve.prefill")
    assert len(prefills) == math.ceil(len(reqs) / b)
    for g, e in enumerate(prefills):
        group = reqs[g * b:(g + 1) * b]
        bucket = max(len(r.tokens) for r in group)
        assert e.args["bucket"] == bucket and e.args["positions"] == b * bucket
        assert e.args["tokens"] == sum(len(r.tokens) for r in group)


# ---- device windows ------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", list(ENGINES))
def test_no_device_window_off_the_card(model, scheduler):
    _, _, events, _ = _serve(model, ENGINES[scheduler], _requests(model[0].cfg.vocab, 3),
                             events=False)
    for e in _spans(events, *STEP[scheduler]):
        assert "device_ns" not in e.args and "gap_ns" not in e.args


@pytest.mark.parametrize("scheduler", list(ENGINES))
def test_device_windows_sit_at_their_steps(runs, scheduler):
    _, _, _, events, wall = runs[scheduler]
    steps = sorted(_spans(events, *STEP[scheduler]), key=lambda e: e.ts_ns)
    assert all(e.args["device_ns"] >= 0 and e.args["gap_ns"] >= 0 for e in steps)
    assert sum(e.args["device_ns"] + e.args["gap_ns"] for e in steps) <= wall

    def sub(step, name):
        return next(s for s in _spans(events, name) if _inside(s, step))

    for prev, cur in zip(steps, steps[1:]):
        prefill = cur.name == "serve.prefill"
        stage = sub(cur, "serve.stage")
        replay = sub(cur, "serve.forward" if prefill else "serve.replay")
        if prev.name == "serve.prefill" and not prefill:
            # the decode window opened in the prefill span, before the
            # caches were copied in; the prefill's closed before its sync
            assert cur.args["device_ns"] >= replay.ts_ns - prev.end_ns
            assert cur.args["gap_ns"] <= prev.end_ns - sub(prev, "serve.forward").end_ns
        else:
            assert cur.args["device_ns"] <= cur.dur_ns
            # this window opens in its staging (the prefill's: before it);
            # the previous one closed in its replay
            last = sub(prev, "serve.replay")
            begins = cur.ts_ns if prefill else stage.ts_ns
            assert begins - last.end_ns <= cur.args["gap_ns"] <= stage.end_ns - last.ts_ns


def test_clock_windows(monkeypatch):
    clock = _stand_in_events(monkeypatch, DeviceClock("cpu"))
    first, second, third = {}, {}, {}

    def at(*marks):
        for t, call in marks:
            monkeypatch.setattr(_Event, "now", t)
            call()

    at((0, clock.start), (1, lambda: clock.into(first)), (10, clock.begin), (15, clock.begin),
       (30, clock.end), (31, clock.end))
    clock.read()
    assert first == {"device_ns": 20, "gap_ns": 10}
    # a window still running is left for a later read; one sent nowhere
    # (no into) is read and dropped, and the next gap counts from it
    at((40, clock.begin), (50, clock.end), (55, lambda: clock.into(second)), (60, clock.begin),
       (75, clock.end))
    monkeypatch.setattr(clock._closed[-1][1], "query", lambda: False)
    clock.read()
    assert second == {} and len(clock._closed) == 1
    monkeypatch.setattr(clock._closed[-1][1], "query", lambda: True)
    clock.read()
    assert second == {"device_ns": 15, "gap_ns": 10} and not clock._closed
    at((80, lambda: clock.into(third)), (81, clock.begin), (90, clock.end), (100, clock.start))
    clock.read()
    assert third == {}  # start forgets what was not read
    _stand_in_events(monkeypatch, clock, capturing=True)
    n = clock._next
    at((110, clock.begin), (120, clock.end))
    assert clock._next == n and not clock._closed  # nothing inside a capture
    cpu = DeviceClock("cpu")
    for call in (cpu.start, cpu.begin, cpu.end, cpu.read):
        call()
    assert not cpu._closed


# ---- export --------------------------------------------------------------------------


def test_chrome_trace_is_on_the_epoch():
    tr = Tracer()
    with tr.span("serve.step", step=0) as args:
        tr.instant("serve.request.admit", rid=1, slot=0, wait_ns=5)
        args["gap_ns"] = 7
    now = time.time()
    events = tr.chrome_trace()["traceEvents"]
    assert all(abs(e["ts"] / 1e6 - now) < 1.0 for e in events)
    assert next(e for e in events if e["ph"] == "X")["args"] == {"step": 0, "gap_ns": 7}
    tr.clear()
    with tr.span("serve.step"):
        pass
    (ev,) = tr.chrome_trace()["traceEvents"]
    assert abs(ev["ts"] / 1e6 - time.time()) < 1.0


def test_a_span_closes_on_an_exception_with_what_its_body_added():
    tr = Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("serve.device_step", width=1) as args:
            args["device_ns"] = 3
            raise RuntimeError("step crashed")
    (ev,) = tr.events()
    assert ev.name == "serve.device_step" and ev.dur_ns >= 0
    assert ev.args == {"width": 1, "device_ns": 3}
    with tr.span("serve.stage"):
        pass
    assert tr.events()[-1].args is None


@pytest.mark.parametrize("scheduler", list(ENGINES))
def test_request_instants_export_as_json(runs, scheduler, tmp_path):
    _, eng, res, _, _ = runs[scheduler]
    path = tmp_path / "trace.json"
    eng.tracer.write(str(path))
    trace = json.loads(path.read_text(), parse_constant=lambda c: pytest.fail(c))
    finishes = {e["args"]["rid"]: e for e in trace["traceEvents"]
                if e["name"] == "serve.request.finish"}
    for r in res:
        ev = finishes[r.rid]
        assert ev["ph"] == "i" and ev["args"]["status"] == "ok"
        assert [x / 1e9 for x in ev["args"]["token_ns"]] == list(r.token_s)
    steps = [e for e in trace["traceEvents"] if e["name"] in STEP[scheduler]]
    assert all(isinstance(e["args"]["gap_ns"], int) for e in steps)


# ---- captures ------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", list(ENGINES))
def test_captured_steps_with_events_read_no_host_value(runs, scheduler):
    _, eng, _, _, _ = runs[scheduler]
    graphs = eng.step_graphs()
    assert graphs and all(g.clock is eng._clock for g in graphs.values())
    with pytest.MonkeyPatch.context() as mp:
        _stand_in_events(mp, eng._clock)
        for g in graphs.values():
            args = {}
            eng._clock.into(args)
            with NoHostRead():
                g.stage()
                logits, greedy = g()
            assert torch.isfinite(logits).all() and greedy.dtype == torch.int32
            eng._clock.read()
            assert set(args) == {"device_ns", "gap_ns"}
