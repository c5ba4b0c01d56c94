"""The port's resilience layer (optimistic admission, preemption and
restore, step retry, fault injection) against the JAX package's.

The scenarios of ``tests/test_resilience.py`` and ``tests/test_faults.py``
run on both packages: deepseek-7b ``.reduced()`` (f32) with the
reference's weights (``params_from_jax``), the same requests and a
``FaultPlan`` built the same way in each. Statuses, preemption counts,
every ``StepStats`` field the port has, the resilience counters, the
fired faults and the greedy streams must be equal. ``FaultPlan`` itself
(arming, consumption, ``random`` plans) and the pool's optimistic
discipline (a lock-step random walk that preempts under real exhaustion)
are held to the reference the same way.

Two properties the reference does not need: the port writes the pool in
place, so one mixed step run twice on the pages it wrote must give equal
pages and logits (a retry is idempotent), and a preemption and a restore
must capture nothing, so a run that preempts and restores goes through
entirely under the dispatch mode that fails on any host read.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import torch
from hypothesis import given, settings, strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serve import FaultPlan as RefFaultPlan
from repro.serve import PagedKVPool as RefPool
from repro.serve import PoolExhausted as RefPoolExhausted
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro.serve import StepStats as RefStepStats
from repro.serve import select_victim as ref_select_victim
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import (
    FAULT_SITES,
    REQUEST_STATUSES,
    AdmissionError,
    Fault,
    FaultPlan,
    GenerationResult,
    PagedKVPool,
    PagePool,
    PoolError,
    PoolExhausted,
    Request,
    ServeEngine,
    StepFault,
    StepStats,
    select_victim,
)
from repro_torch.testing import params_from_jax

SETTINGS = settings(max_examples=15, deadline=None)
# test_resilience.py's oversubscription geometry: page 16, max_len 64 (4-page
# rows), 24-token prompts growing by 24, 4 allocatable pages for 2 slots.
GEO = dict(batch_size=2, max_len=64, scheduler="continuous", page_size=16,
           prefill_chunk=16, pool_pages=4)
# test_faults.py's engine.
FAULT_ENGINE = dict(batch_size=2, max_len=64, scheduler="continuous", page_size=16,
                    prefill_chunk=16)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jlm = ref_build_model(ref_get_config("deepseek-7b").reduced())
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = build_model(get_config("deepseek-7b").reduced(), device="cpu")
    return jlm, jparams, lm, params_from_jax(jax.tree.map(np.asarray, jparams))


def _specs(vocab, n, *, seed, plen=24, max_new=8, **kw):
    rng = np.random.default_rng(seed)
    return [dict(tokens=rng.integers(2, vocab, size=plen).astype(np.int32),
                 max_new_tokens=max_new, rid=i,
                 **{k: (v(i) if callable(v) else v) for k, v in kw.items()})
            for i in range(n)]


# ---- FaultPlan ------------------------------------------------------------------


def test_fault_sites_and_validation():
    assert FAULT_SITES == ("pool.alloc", "pool.admit", "device.step", "cancel", "tier.spill",
                           "tier.fetch")
    with pytest.raises(ValueError):
        Fault("pool.everything", 0)
    assert issubclass(StepFault, RuntimeError)


def _plan_trace(plan_cls):
    """One scripted sequence of FaultPlan calls, and what each returned."""
    plan = plan_cls().exhaust_pool(2, times=2).refuse_admission(0)
    plan.cancel(1, rid=7).cancel(1, rid=9).fail_device_step(1).spill_stall(4).fetch_fail(5, 2)
    out = [plan.take("pool.alloc")]
    for step in (0, 1, 3, 5):
        plan.begin_step(step)
        out += [plan.take("pool.admit"), plan.take("pool.alloc"), plan.take_cancels(),
                plan.fired_this_step, plan.take("tier.spill"), plan.take("tier.fetch")]
        try:
            plan.raise_if("device.step")
            out.append("no raise")
        except Exception as err:   # StepFault of either package
            out.append(str(err))
    out += [plan.exhausted, plan.fired, [(f.site, f.step, f.times, f.rid, f.note)
                                         for f in plan.faults]]
    return out


def test_fault_plan_protocol_equals_reference():
    assert _plan_trace(FaultPlan) == _plan_trace(RefFaultPlan)


@pytest.mark.parametrize("seed", [0, 3, 4, 11, 2024])
def test_random_plans_equal_reference(seed):
    for kw in (dict(n_steps=12, rids=(0, 1, 2)), dict(n_steps=10, rids=(0, 1, 2, 3)),
               dict(n_steps=1, rids=(), n_exhaust=3, n_step_fail=2, n_cancel=2)):
        got, want = FaultPlan.random(seed, **kw), RefFaultPlan.random(seed, **kw)
        assert [dataclasses.astuple(f) for f in got.faults] == \
            [dataclasses.astuple(f) for f in want.faults]


def test_injected_alloc_failure_raises_pool_exhausted():
    plan = FaultPlan().exhaust_pool(0)
    plan.begin_step(0)
    pool = PagePool(8, faults=plan)
    with pytest.raises(PoolExhausted, match="injected"):
        pool.alloc(1)
    assert pool.alloc(1) == [1]


# ---- pool -----------------------------------------------------------------------


def test_typed_errors_and_result_defaults():
    assert issubclass(PoolExhausted, PoolError) and issubclass(PoolExhausted, RuntimeError)
    assert issubclass(AdmissionError, PoolError) and issubclass(AdmissionError, ValueError)
    with pytest.raises(PoolExhausted):
        PagePool(4).alloc(4)
    r = GenerationResult(rid=0, tokens=np.zeros(0, np.int32), steps=0)
    assert r.status == "ok" and r.n_preemptions == 0 and r.status in REQUEST_STATUSES
    assert Request(tokens=np.zeros(1, np.int32)).priority == 0
    ref_fields = {f.name for f in dataclasses.fields(RefStepStats)}
    assert {f.name for f in dataclasses.fields(StepStats)} <= ref_fields


@pytest.mark.parametrize("cands", [
    [(0, 1, 0, False), (1, 0, 9, True)],
    [(0, 0, 3, True), (1, 0, 9, False)],
    [(0, 0, 5, False), (1, 0, 2, False)],
    [(2, 0, 4, False), (1, 0, 4, False)],
    [(3, 2, 1, True), (0, 2, 1, True), (5, 1, 7, True), (4, 1, 7, False)],
])
def test_select_victim_equals_reference(cands):
    assert select_victim(cands) == ref_select_victim(cands)


def _port_pool(**kw):
    cfg = get_config("deepseek-7b").reduced().with_(kv_layout="paged", page_size=4)
    return PagedKVPool(cfg, 1, 3, 32, device="cpu", **kw)


def _pools(**kw):
    jcfg = ref_get_config("deepseek-7b").reduced().with_(kv_layout="paged", page_size=4)
    return RefPool(jcfg, 1, 3, 32, **kw), _port_pool(**kw)


def _same_pools(ref, port):
    np.testing.assert_array_equal(port.block_tables, ref.block_tables)
    np.testing.assert_array_equal(port.lens, ref.lens)
    np.testing.assert_array_equal(port._ref, ref._ref)
    assert port._slot_pages == ref._slot_pages
    assert port._slot_reserved == ref._slot_reserved
    assert port.alloc._free == ref.alloc._free
    assert port.alloc.reserved == ref.alloc.reserved
    assert port._page_parent == ref._page_parent


def test_pool_admission_errors_and_idempotent_release():
    with pytest.raises(AdmissionError):
        _port_pool(admission="bogus")
    with pytest.raises(AdmissionError):
        _port_pool(n_pages=3)
    ref, port = _pools(admission="optimistic", n_pages=12)
    for pool in (ref, port):
        pool.release(1)
        assert pool.admit(0, np.arange(2, 12, dtype=np.int32), 6) == 0
        assert pool.can_admit(10, 6) == (pool.alloc.available >= 4)
        pool.ensure_writable(0, 9)
        pool.advance(0, 9)
        pool.release(0)
        pool.release(0)
        pool.check_invariants()
    _same_pools(ref, port)
    assert port.alloc.free_count == port.alloc.n_pages - 1 and port.alloc.reserved == 0


@SETTINGS
@given(seed=st.integers(0, 2**16))
def test_optimistic_pool_lock_step_random_walk(seed):
    """test_resilience.py's lifecycle walk on an oversubscribed optimistic
    pool (admit, grow, natural PoolExhausted answered by releasing the
    victim ``select_victim`` picks, cancel, restore of a preempted stream as
    a re-admission), on both pools in lock step: the same exhaustions, and
    equal host state and invariants after every operation."""
    rng = np.random.default_rng(seed)
    ref, port = _pools(admission="optimistic", n_pages=13)
    live: dict = {}
    preempted: list = []
    for _ in range(80):
        op = int(rng.integers(0, 5))
        free = [s for s in range(3) if s not in live]
        if op in (0, 3) and free and (op == 0 or preempted):
            slot = int(rng.choice(free))
            if op == 0:
                n, new = int(rng.integers(1, 20)), int(rng.integers(1, 12))
            else:
                n, new = preempted.pop()
            prompt = rng.integers(2, 5, size=n).astype(np.int32)
            got = [pool.admit(slot, prompt, new) for pool in (ref, port)]
            assert got[0] == got[1]
            if got[0] is not None:
                live[slot] = [int(port.lens[slot]), min(n + new, port.capacity)]
        elif op == 1 and live:
            slot = int(rng.choice(list(live)))
            n = min(int(rng.integers(1, 5)), live[slot][1] - live[slot][0])
            if n <= 0:
                continue
            raised = []
            for pool in (ref, port):
                try:
                    pool.ensure_writable(slot, n)
                    raised.append(False)
                except (PoolExhausted, RefPoolExhausted):   # each package its own
                    raised.append(True)
            assert raised[0] == raised[1]
            if raised[0]:
                cands = [(s, 0, live[s][0], port.shared_donor(s)) for s in live]
                assert [ref.shared_donor(s) for s in live] == [c[3] for c in cands]
                victim = select_victim(cands)
                length, total = live.pop(victim)
                preempted.append((max(length, 1), max(total - length, 1)))
                for pool in (ref, port):
                    pool.release(victim)
            else:
                for pool in (ref, port):
                    pool.advance(slot, n)
                live[slot][0] += n
        elif op == 2 and live:
            slot = int(rng.choice(list(live)))
            del live[slot]
            for pool in (ref, port):
                pool.release(slot)
        for pool in (ref, port):
            pool.check_invariants()
        _same_pools(ref, port)
        for slot, (length, _) in live.items():
            assert int(port.lens[slot]) == length


# ---- the engines ------------------------------------------------------------------

# Each scenario: (engine arguments, requests (n, seed, plen, max_new, extra),
# a builder of the fault plan from a FaultPlan class, or None).
SCENARIOS = {
    # test_resilience.py
    "preempt_restore": (dict(GEO, admission="optimistic", max_preemptions=10),
                        (3, 11, 24, 24, {}), None),
    "max_preemptions_zero": (dict(GEO, admission="optimistic", max_preemptions=0),
                             (3, 11, 24, 24, {}), None),
    "priority_shield": (dict(GEO, admission="optimistic", max_preemptions=10),
                        (2, 11, 24, 24, {"priority": lambda i: 1 if i == 0 else 0}), None),
    "admit_watermark": (dict(GEO, admission="optimistic", max_preemptions=10,
                             admit_watermark=0.5), (3, 11, 24, 24, {}), None),
    "per_request_bound": (dict(GEO, admission="optimistic", max_preemptions=10),
                          (3, 11, 24, 24, {"max_preemptions": lambda i: 0 if i == 1 else None}),
                          None),
    # test_faults.py
    "injected_exhaustion": (dict(FAULT_ENGINE, admission="optimistic", max_preemptions=5),
                            (2, 5, 24, 12, {}), lambda P: P().exhaust_pool(3)),
    "admission_refusal": (FAULT_ENGINE, (2, 5, 24, 8, {}), lambda P: P().refuse_admission(0)),
    "transient_step_failure": (FAULT_ENGINE, (2, 5, 24, 8, {}),
                               lambda P: P().fail_device_step(2)),
    "persistent_step_failure": (FAULT_ENGINE, (3, 5, 24, 8, {}),
                                lambda P: P().fail_device_step(2, times=2)),
    "seeded_chaos": (dict(FAULT_ENGINE, admission="optimistic", max_preemptions=5),
                     (4, 5, 24, 12, {}),
                     lambda P: P.random(11, n_steps=10, rids=(0, 1, 2, 3))),
    "exhaust_and_cancel": (dict(FAULT_ENGINE, admission="optimistic", max_preemptions=5),
                           (4, 5, 24, 12, {}), lambda P: P().exhaust_pool(4).cancel(6, rid=2)),
}
COUNTERS = [("serve.preemptions", {}), ("serve.restore_tokens", {}), ("serve.step_retries", {}),
            ("serve.failed", {}), ("serve.cancelled", {}), ("serve.requests", {"event": "requeued"}),
            ("serve.requests", {"event": "admitted"}), ("serve.tokens.generated", {})]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_resilience_scenarios_equal_reference(models, name):
    jlm, jparams, lm, params = models
    kw, (n, seed, plen, max_new, extra), plan_of = SCENARIOS[name]
    specs = _specs(lm.cfg.vocab, n, seed=seed, plen=plen, max_new=max_new, **extra)
    ref_plan = plan_of(RefFaultPlan) if plan_of else None
    plan = plan_of(FaultPlan) if plan_of else None
    ref = RefEngine(jlm, jparams, faults=ref_plan, **kw)
    eng = ServeEngine(lm, params, faults=plan, device="cpu", **kw)
    assert eng._watermark == ref._watermark
    want = ref.generate([RefRequest(**s) for s in specs])
    got = eng.generate([Request(**s) for s in specs])
    for a, b in zip(want, got):
        assert (b.rid, b.status, b.steps, b.n_preemptions) == \
            (a.rid, a.status, a.steps, a.n_preemptions), name
        np.testing.assert_array_equal(b.tokens, a.tokens)
    for f in dataclasses.fields(StepStats):
        assert getattr(eng.last_stats, f.name) == getattr(ref.last_stats, f.name), f.name
    for key, labels in COUNTERS:
        assert eng.obs.value(key, **labels) == ref.obs.value(key, **labels), (key, labels)
    if plan is not None:
        assert plan.fired == ref_plan.fired and plan.exhausted == ref_plan.exhausted
    assert eng.compiled_step_count() == ref.compiled_step_count() <= 2
    eng.last_pool.check_invariants()
    instants = {ev.name for ev in eng.tracer.events()}
    if eng.last_stats.preemptions:
        assert {"serve.preempt", "serve.preempt_restore"} <= instants
    if eng.obs.value("serve.step_retries"):
        assert "serve.step_retry" in instants


def test_scenarios_cover_what_they_name(models):
    """The scenarios exercise what they are named for (on the reference's
    own numbers): real preemption and restore, a failure past the bound, a
    retry, failed rows and a cancel."""
    jlm, jparams, lm, _ = models
    seen = {}
    for name in ("preempt_restore", "max_preemptions_zero", "persistent_step_failure",
                 "exhaust_and_cancel"):
        kw, (n, seed, plen, max_new, extra), plan_of = SCENARIOS[name]
        ref = RefEngine(jlm, jparams, faults=plan_of(RefFaultPlan) if plan_of else None, **kw)
        res = ref.generate([RefRequest(**s) for s in _specs(lm.cfg.vocab, n, seed=seed,
                                                            plen=plen, max_new=max_new)])
        seen[name] = (ref.last_stats, [r.status for r in res])
    stats, _ = seen["preempt_restore"]
    assert stats.preemptions >= 1 and stats.restore_tokens > 0
    assert "failed" in seen["max_preemptions_zero"][1]
    assert seen["persistent_step_failure"][1] == ["failed", "failed", "ok"]
    stats, statuses = seen["exhaust_and_cancel"]
    assert stats.preemptions >= 1 and statuses.count("cancelled") == 1


@pytest.mark.parametrize("scheduler", ["static", "continuous"])
@pytest.mark.parametrize("case", ["deadline", "cancel_before_start"])
def test_lifecycle_on_both_engines_equals_reference(models, scheduler, case):
    """test_resilience.py's deadline and cancel scenarios on both engines."""
    jlm, jparams, lm, params = models
    kw = dict(batch_size=2, max_len=64, scheduler=scheduler, page_size=16)
    ref = RefEngine(jlm, jparams, **kw)
    eng = ServeEngine(lm, params, device="cpu", **kw)
    if case == "deadline":
        specs = _specs(lm.cfg.vocab, 2, seed=11, deadline_s=lambda i: 0.0 if i == 0 else None)
    else:
        specs = _specs(lm.cfg.vocab, 3, seed=11)
        ref.cancel(1)
        eng.cancel(1)
    want = ref.generate([RefRequest(**s) for s in specs])
    got = eng.generate([Request(**s) for s in specs])
    assert [r.status for r in got] == [r.status for r in want]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    for key in ("serve.deadline_miss", "serve.cancelled"):
        assert eng.obs.value(key) == ref.obs.value(key)


def test_engine_rejects_unknown_admission(models):
    _, _, lm, params = models
    with pytest.raises(AdmissionError):
        ServeEngine(lm, params, scheduler="continuous", admission="bogus", device="cpu")


# ---- what the port adds ---------------------------------------------------------------


def test_a_step_run_twice_is_idempotent(models):
    """The retry's premise on a pool written in place: at every mixed step
    of a run that preempts and restores, the step run a second time on the
    pages the first run wrote (the same inputs, ``len`` not advanced) gives
    the same logits at every replay, the same tokens, and leaves the same
    pages."""
    _, _, lm, params = models
    eng = ServeEngine(lm, params, device="cpu", admission="optimistic", max_preemptions=10,
                      **GEO)
    run, replay = eng._run_mixed, eng._replay
    seen, checked = [], []

    def replay_rec(*args):
        logits = replay(*args)
        seen.append(logits.clone())
        return logits

    def twice(width, tokens, pool, *rest):
        seen.clear()
        toks = run(width, tokens, pool, *rest)
        first, pages = list(seen), [t.clone() for t in pool.pages.values()]
        seen.clear()
        again = run(width, tokens, pool, *rest)
        np.testing.assert_array_equal(toks, again)
        assert len(seen) == len(first) > 0
        assert all(torch.equal(a, b) for a, b in zip(first, seen))
        for a, b in zip(pages, pool.pages.values()):
            assert torch.equal(a[:, 1:], b[:, 1:])   # page 0: invalid rows, any order
        checked.append(True)
        return toks

    eng._replay, eng._run_mixed = replay_rec, twice
    res = eng.generate([Request(**s) for s in _specs(lm.cfg.vocab, 3, seed=11, max_new=24)])
    assert all(r.status == "ok" for r in res) and eng.last_stats.preemptions >= 1
    assert len(checked) == eng.last_stats.mixed_steps


class NoHostRead(TorchDispatchMode):
    """Fails on any read of a tensor's value by the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("host read inside a captured step")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kv_cache_dtype", ["bfloat16", "int8"])
def test_preempt_and_restore_read_no_host_value(models, kv_cache_dtype):
    """A run that preempts (real pressure and an injected exhaustion) and
    restores through the two captured widths, every mixed step under the
    host-read guard: preemption changes only the staged block tables,
    lengths and q_lens, so it captures nothing."""
    _, _, lm, params = models
    lm = build_model(lm.cfg.with_(kv_cache_dtype=kv_cache_dtype), device="cpu")
    eng = ServeEngine(lm, params, device="cpu", admission="optimistic", max_preemptions=10,
                      faults=FaultPlan().exhaust_pool(9), **GEO)
    graphs = {}
    mixed = eng._mixed_step

    def guarded(width, pool):
        step = mixed(width, pool)
        if step not in graphs.values():
            fn = step.fn

            def under_guard(**inputs):
                with NoHostRead():
                    return fn(**inputs)

            step.fn = under_guard
            graphs[width] = step
        return step

    eng._mixed_step = guarded
    res = eng.generate([Request(**s) for s in _specs(lm.cfg.vocab, 3, seed=11, max_new=24)])
    assert all(r.status == "ok" for r in res)
    assert eng.last_stats.preemptions >= 2 and eng.last_stats.restore_tokens > 0
    assert sorted(graphs) == [1, 16] and eng.compiled_step_count() == 2
