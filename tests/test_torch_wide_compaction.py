"""The continuous engine's compact wide step (``serve.engine``, R rows a
replay of the chunk width, ``WIDE_POSITIONS``) against the JAX package's
full-width step, on the CPU.

Both engines serve deepseek-7b ``.reduced()`` (f32, the reference's weights
by ``params_from_jax``) with 12 slots; the module constant is lowered so
that R = 4 < 12, and a wave's plans hold steps of 1, R and R + 1 wide rows
and a step with no one-token row. Held to:

* the plans (every row's slot, ``q_len``, kind and drafts) equal the
  reference's, step for step, and the greedy streams and ``StepStats``
  equal its own;
* each wide ``serve.device_step`` carries ``replays`` = ceil(wide rows /
  R), plus 1 where one-token rows are left past the last group's spare
  rows (which they fill first), and ``positions`` = R x chunk a compact
  replay plus the slots where the narrow step runs; ``serve.wide_replays``
  sums them; a narrow step computes every slot once;
* two step graphs, ``mixed/1`` (12, 1) and ``mixed/<chunk>`` (R, chunk);
* nothing between a step's first replay and its sync reads a device value
  on the host (the step functions, each group's load, each replay's copies
  and draws, under ``test_torch_step_graph``'s guard), greedy and sampled;
  a sampled stream is the same whatever R;
* speculation with more verification rows than R in a step gives the
  reference's streams and counts and the port's own non-speculative ones;
* one device window a step, however many replays (the clock's ring takes
  two events a step).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import torch

import repro.serve.scheduler as ref_scheduler
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serve import NgramDrafter as RefNgramDrafter
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import NgramDrafter, Request, ServeEngine, StepStats
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import scheduler as port_scheduler
from repro_torch.serve.step_graph import StepGraph
from repro_torch.testing import params_from_jax
from test_torch_serve_trace import _stand_in_events
from test_torch_step_graph import NoHostRead

ROWS = 4   # R, by the lowered constant
SLOTS = 12
ENGINE = dict(scheduler="continuous", batch_size=SLOTS, max_len=96, page_size=8,
              prefill_chunk=16, token_budget=SLOTS * 16)
SPEC_ENGINE = dict(ENGINE, max_len=128, prefill_chunk=8, token_budget=SLOTS * 8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jlm = ref_build_model(ref_get_config("deepseek-7b").reduced())
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = build_model(get_config("deepseek-7b").reduced(), device="cpu")
    return jlm, jparams, lm, params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.fixture
def rows(monkeypatch):
    """R = ROWS for engines built under it: WIDE_POSITIONS = R x chunk."""
    def lower(chunk):
        monkeypatch.setattr(engine_mod, "WIDE_POSITIONS", ROWS * chunk)
    return lower


def _wave(cls, vocab, temperature=0.0):
    """Five prompts of two chunks at step 0 (two steps of R + 1 wide rows
    and no one-token row), four one-chunk prompts at step 5 (R wide rows
    beside the decoding five), one at step 9 (1 wide row), two long ones at
    step 11; every row runs to its limit (eos -1)."""
    rng = np.random.default_rng(5)
    lens = [20, 25, 30, 22, 28] + [10, 12, 14, 16] + [12] + [40, 45]
    arrival = [0] * 5 + [5] * 4 + [9] + [11] * 2
    return [cls(tokens=rng.integers(2, vocab, size=n).astype(np.int32), max_new_tokens=10,
                rid=i, arrival=a, eos_id=-1, temperature=temperature, seed=i)
            for i, (n, a) in enumerate(zip(lens, arrival))]


def _record_plans(monkeypatch, module) -> list:
    plans = []
    plan_step = module.ContinuousScheduler.plan_step

    def recorded(self, draft_lens=None):
        plan = plan_step(self, draft_lens)
        plans.append([(it.slot, it.q_len, it.is_prefill, it.n_draft) for it in plan])
        return plan

    monkeypatch.setattr(module.ContinuousScheduler, "plan_step", recorded)
    return plans


def _record_steps(eng) -> list:
    """Each mixed step's host q_lens and ladder, as ``_run_mixed`` gets
    them."""
    steps = []
    run = eng._run_mixed

    def recorded(width, tokens, pool, qlens, *rest):
        steps.append((width, qlens.copy(), rest[5].copy()))   # rest[5]: the ladder
        return run(width, tokens, pool, qlens, *rest)

    eng._run_mixed = recorded
    return steps


def _check_step_args(eng, steps):
    """The trace's wide steps against the formula, from the recorded
    q_lens; returns the wide-row counts of the wide steps."""
    spans = [e for e in eng.tracer.events() if e.name == "serve.device_step"]
    assert len(spans) == len(steps)
    chunk = eng._chunk
    counts = []
    for e, (width, qlens, _) in zip(spans, steps):
        assert e.args["width"] == width
        n_wide = int((qlens > 1).sum())
        if width == 1:
            assert n_wide == 0 and "replays" not in e.args and e.args["positions"] == SLOTS
            continue
        compact = -(-n_wide // ROWS)
        # one-token rows fill the last group's spare rows; the rest run narrow
        narrow = int((qlens == 1).sum()) > compact * ROWS - n_wide
        counts.append((n_wide, narrow))
        assert e.args["replays"] == compact + narrow, (e.args, n_wide, narrow)
        assert e.args["positions"] == ROWS * chunk * compact + SLOTS * narrow
        assert e.args["tokens"] <= e.args["positions"]
    assert eng.obs.value("serve.wide_replays") == sum(e.args.get("replays", 0) for e in spans)
    return counts


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_compact_wave(models, rows, monkeypatch, kind):
    """Greedy: the plans and streams equal the reference's, the step args
    follow the formula over steps of 1, R and R + 1 wide rows and a wide
    step with no one-token row, two graphs of their shapes, and the
    replays and copies between a step's stage and sync read no device
    value. Sampled: the same stream with R = 4 as with R = 12 (one group),
    under the same guard."""
    jlm, jparams, lm, params = models
    rows(ENGINE["prefill_chunk"])
    temperature = 0.0 if kind == "greedy" else 0.9
    port_plans = _record_plans(monkeypatch, port_scheduler)
    eng = ServeEngine(lm, params, device="cpu", **ENGINE)
    assert eng._rows == ROWS
    steps = _record_steps(eng)
    guarded = {"replays": 0, "loads": 0}
    replay, load = eng._replay, StepGraph.load

    def replay_guarded(*a, **k):
        guarded["replays"] += 1
        with NoHostRead():
            return replay(*a, **k)

    def load_guarded(self, g):
        guarded["loads"] += 1
        with NoHostRead():
            return load(self, g)

    eng._replay = replay_guarded
    monkeypatch.setattr(StepGraph, "load", load_guarded)
    got = eng.generate(_wave(Request, lm.cfg.vocab, temperature))
    assert all(r.status == "ok" and r.steps == 10 for r in got)
    counts = _check_step_args(eng, steps)
    assert {1, ROWS, ROWS + 1} <= {n for n, _ in counts}, counts
    assert (ROWS + 1, False) in counts and (1, True) in counts, counts
    spans = [e for e in eng.tracer.events() if e.name == "serve.device_step"]
    assert guarded["replays"] == sum(e.args.get("replays", 1) for e in spans)
    assert guarded["loads"] == sum(-(-n // ROWS) for n, _ in counts)
    assert eng.compiled_step_count() == 2
    assert {k: tuple(g.inputs["tokens"].shape) for k, g in eng.step_graphs().items()} == \
        {"mixed/1": (SLOTS, 1), "mixed/16": (ROWS, 16)}
    eng.last_pool.check_invariants()
    if kind == "sampled":
        monkeypatch.setattr(engine_mod, "WIDE_POSITIONS", SLOTS * ENGINE["prefill_chunk"])
        whole = ServeEngine(lm, params, device="cpu", **ENGINE)
        assert whole._rows == SLOTS
        want = whole.generate(_wave(Request, lm.cfg.vocab, temperature))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.tokens, a.tokens)
        return
    ref_plans = _record_plans(monkeypatch, ref_scheduler)
    ref = RefEngine(jlm, jparams, **ENGINE)
    want = ref.generate(_wave(RefRequest, lm.cfg.vocab))
    assert port_plans == ref_plans
    for a, b in zip(want, got):
        assert (b.rid, b.status, b.steps) == (a.rid, a.status, a.steps)
        np.testing.assert_array_equal(b.tokens, a.tokens)
    for f in dataclasses.fields(StepStats):
        assert getattr(eng.last_stats, f.name) == getattr(ref.last_stats, f.name), f.name
    assert eng.compiled_step_count() == ref.compiled_step_count()


def _spec_wave(cls):
    """Cyclic prompts prompt lookup drafts from, 10 of 12 slots."""
    reqs = []
    for i in range(10):
        rng = np.random.default_rng(100 + i)
        toks = np.tile(rng.integers(5, 20, size=4), 6).astype(np.int32)
        reqs.append(cls(tokens=toks, max_new_tokens=16, rid=i, seed=i))
    return reqs


def test_speculative_rows_past_one_group(models, rows):
    """N-gram speculation, K 4, chunk 8, R 4: steps with more verification
    rows than R run them in several groups, and the streams, StepStats and
    counters equal the reference's and the port's own run without a
    drafter."""
    jlm, jparams, lm, params = models
    rows(SPEC_ENGINE["prefill_chunk"])
    ref = RefEngine(jlm, jparams, drafter=RefNgramDrafter(ngram_max=4), **SPEC_ENGINE)
    eng = ServeEngine(lm, params, drafter=NgramDrafter(ngram_max=4), device="cpu", **SPEC_ENGINE)
    assert eng._rows == ROWS
    ref.draft_len = eng.draft_len = 4
    steps = _record_steps(eng)
    want = ref.generate(_spec_wave(RefRequest))
    got = eng.generate(_spec_wave(Request))
    base = ServeEngine(lm, params, device="cpu", **SPEC_ENGINE).generate(_spec_wave(Request))
    for a, b, c in zip(want, got, base):
        assert (b.rid, b.status, b.steps) == (a.rid, a.status, a.steps) and b.status == "ok"
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_array_equal(b.tokens, c.tokens)
    for f in dataclasses.fields(StepStats):
        assert getattr(eng.last_stats, f.name) == getattr(ref.last_stats, f.name), f.name
    assert eng.last_stats.draft_tokens > 0
    # verification rows (a ladder) past one group in some step
    assert max(int(ladder.sum()) for _, _, ladder in steps) > ROWS
    counts = _check_step_args(eng, steps)
    assert max(n for n, _ in counts) > ROWS
    assert eng.compiled_step_count() == ref.compiled_step_count() <= 2


def test_one_device_window_a_step_of_many_replays(models, rows):
    """With stand-in events, a step of up to R + 1 groups records two
    events (its window's ends) and carries one window, whatever its
    replays."""
    _, _, lm, params = models
    rows(ENGINE["prefill_chunk"])
    eng = ServeEngine(lm, params, device="cpu", **ENGINE)
    recorded = []
    with pytest.MonkeyPatch.context() as mp:
        clock = _stand_in_events(mp, eng._clock)
        record = clock._record
        mp.setattr(clock, "_record", lambda: recorded.append(1) or record())
        eng.generate(_wave(Request, lm.cfg.vocab))
    spans = [e for e in eng.tracer.events() if e.name == "serve.device_step"]
    assert max(e.args.get("replays", 1) for e in spans) >= 2
    assert len(recorded) == 1 + 2 * len(spans)   # generate()'s start, then 2 a step
    assert all(e.args["device_ns"] >= 0 and e.args["gap_ns"] >= 0 for e in spans)
