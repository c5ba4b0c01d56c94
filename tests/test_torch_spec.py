"""The port's speculative decoding (``serve.spec``, ``PagedKVPool.rollback``,
``plan_step(draft_lens)``) against the JAX package's.

* A verification chunk (q_len K+1) through B1's plain version equals K+1
  sequential one-token decodes over the same pools, for every order, with
  and without a window.
* ``rollback``'s contract (the reservation given back under "reserve",
  pages freed under "optimistic", the shared-page refusal, the registry
  refresh and the invariant that pins it) on both pools in lock step, the
  accept/rollback random walk, and the walk interleaved with the tier's
  spills and resumes; ``plan_step`` clamping on both schedulers; the
  n-gram drafter's lag copy on both packages.
* The engine on deepseek-7b ``.reduced()`` (f32, the reference's weights by
  ``params_from_jax``): n-gram and model drafters give the reference's
  greedy streams and its draft, accepted and rolled-back counts, equal to
  the port's own non-speculative streams, greedy and sampled (the port's
  draws cannot replay ``jax.random``, so sampled runs are held to the port
  itself); across orders and on int8 pages; with two step graphs; through a
  step failure in the middle of verification; self-speculation with the
  reference's counts (its test holds acceptance to 0.99; both packages
  accept 42 of 48 there, the other 6 drafted past an EOS, see ROADMAP
  "Note for A11"); the n-gram drafter on olmoe-1b-7b (MoE); and a tiered,
  speculative run whose every step, the drafter's too, reads no device
  value on the host.
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
from repro.serve import ContinuousScheduler as RefScheduler
from repro.serve import FaultPlan as RefFaultPlan
from repro.serve import ModelDrafter as RefModelDrafter
from repro.serve import NgramDrafter as RefNgramDrafter
from repro.serve import PagedKVPool as RefPool
from repro.serve import PoolExhausted as RefPoolExhausted
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro.serve import TieredPagePool as RefTiered
from repro_torch.configs import get_config
from repro_torch.core.attention import paged_decode_attention
from repro_torch.core.schedule import Order
from repro_torch.kernels.flash_decode import paged_flash_decode_fwd
from repro_torch.models import build_model
from repro_torch.serve import (
    ContinuousScheduler,
    FaultPlan,
    ModelDrafter,
    NgramDrafter,
    PagedKVPool,
    PoolError,
    PoolExhausted,
    Request,
    ServeEngine,
    StepStats,
    TieredPagePool,
    make_drafter,
)
from repro_torch.testing import params_from_jax

SETTINGS = settings(max_examples=10, deadline=None)
TOL = dict(atol=2e-5, rtol=0)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jlm = ref_build_model(ref_get_config("deepseek-7b").reduced())
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = build_model(get_config("deepseek-7b").reduced(), device="cpu")
    return jlm, jparams, lm, params_from_jax(jax.tree.map(np.asarray, jparams))


# ---- a verification chunk against sequential decode ---------------------------------


def _verify_problem(seed=0, b=3, hq=8, hkv=2, d=16, page=8, nb=4, c=6):
    """test_spec.py's ragged step: GQA, shuffled block tables, a decode row
    (q_len 1) beside two verification chunks (q_len 6 and 4)."""
    rng = np.random.default_rng(seed)
    n_pages = b * nb + 1
    kp = rng.normal(size=(n_pages, page, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages, page, hkv, d)).astype(np.float32)
    bt = rng.permutation(np.arange(1, n_pages))[: b * nb].reshape(b, nb).astype(np.int32)
    q = rng.normal(size=(b, c, hq, d)).astype(np.float32)
    lens = np.asarray([9, 21, nb * page], np.int32)
    qls = np.asarray([1, c, 4], np.int32)
    return q, kp, vp, bt, lens, qls


@pytest.mark.parametrize("order", list(Order))
@pytest.mark.parametrize("window", [None, 11])
def test_verification_chunk_matches_sequential_decode(order, window):
    q, kp, vp, bt, lens, qls = _verify_problem()
    kw = dict(order=order, window=window)
    if order is Order.BLOCK_SNAKE:
        kw["snake_group"] = 2
    t = torch.from_numpy
    chunk = paged_flash_decode_fwd(t(q), t(kp), t(vp), t(lens), t(bt), q_lens=t(qls), **kw)
    plain = paged_decode_attention(t(q), t(kp), t(vp), t(lens), t(bt), q_lens=t(qls), **kw)
    for i in range(q.shape[0]):
        for j in range(int(qls[i])):
            pos_len = torch.tensor([int(lens[i]) - int(qls[i]) + j + 1], dtype=torch.int32)
            seq = paged_flash_decode_fwd(
                t(q[i : i + 1, j : j + 1]), t(kp), t(vp), pos_len, t(bt[i : i + 1]),
                q_lens=torch.tensor([1], dtype=torch.int32), **kw)[0, 0]
            np.testing.assert_allclose(chunk[i, j].numpy(), seq.numpy(), **TOL)
            np.testing.assert_allclose(plain[i, j].numpy(), seq.numpy(), **TOL)


# ---- rollback on both pools ------------------------------------------------------------


def _pools(admission="reserve", n_slots=3, max_len=32, **kw):
    jcfg = ref_get_config("deepseek-7b").reduced().with_(kv_layout="paged", page_size=4)
    cfg = get_config("deepseek-7b").reduced().with_(kv_layout="paged", page_size=4)
    return (RefPool(jcfg, 1, n_slots, max_len, admission=admission, **kw),
            PagedKVPool(cfg, 1, n_slots, max_len, device="cpu", admission=admission, **kw))


def _same_pools(ref, port):
    np.testing.assert_array_equal(port.block_tables, ref.block_tables)
    np.testing.assert_array_equal(port.lens, ref.lens)
    np.testing.assert_array_equal(port._ref, ref._ref)
    np.testing.assert_array_equal(port._written, ref._written)
    assert port._slot_pages == ref._slot_pages
    assert port._slot_reserved == ref._slot_reserved
    assert port.alloc._free == ref.alloc._free
    assert port.alloc.reserved == ref.alloc.reserved
    assert port._page_parent == ref._page_parent
    assert {h: p for h, (p, _) in port._chain_next.items()} == \
        {h: p for h, (p, _) in ref._chain_next.items()}


def _both(pools, fn):
    got = [fn(p) for p in pools]
    assert got[0] == got[1], got
    return got[0]


def _grow(pool, slot, n):
    pool.ensure_writable(slot, n)
    pool.advance(slot, n)


def _each(pools, fn):
    for p in pools:
        fn(p)
    _same_pools(*pools)


def test_rollback_reserve_restores_reservation():
    pools = _pools("reserve", n_slots=1, max_len=16)
    assert _both(pools, lambda p: p.admit(0, np.arange(2, 8, dtype=np.int32), 10)) == 0
    _each(pools, lambda p: (_grow(p, 0, 6), _grow(p, 0, 9)))
    assert _both(pools, lambda p: p.rollback(0, 7)) == 2
    _same_pools(*pools)
    assert int(pools[1].lens[0]) == 8 and len(pools[1]._slot_pages[0]) == 2
    _each(pools, lambda p: _grow(p, 0, 8))   # regrowth cannot fail: reserved again
    assert int(pools[1].lens[0]) == 16
    _each(pools, lambda p: p.check_invariants())


def test_rollback_optimistic_frees_pages():
    pools = _pools("optimistic", n_slots=2, max_len=16, n_pages=6)
    assert _both(pools, lambda p: p.admit(0, np.arange(2, 6, dtype=np.int32), 12)) == 0
    _each(pools, lambda p: (_grow(p, 0, 4), _grow(p, 0, 11)))
    free = pools[1].alloc.free_count
    assert _both(pools, lambda p: p.rollback(0, 10)) == 2
    _same_pools(*pools)
    assert pools[1].alloc.free_count == free + 2 and int(pools[1].lens[0]) == 5
    _each(pools, lambda p: p.check_invariants())


def test_rollback_refuses_shared_pages():
    pools = _pools("reserve", n_slots=2, max_len=16)
    prompt = np.append(np.tile(np.arange(2, 6, dtype=np.int32), 2), np.int32(6))
    _each(pools, lambda p: (p.admit(0, prompt, 4), _grow(p, 0, 9), p.register_prompt(0, prompt)))
    assert _both(pools, lambda p: p.admit(1, prompt, 4)) >= 8
    _each(pools, lambda p: _grow(p, 1, len(prompt) - int(p.lens[1]) + 2))
    before = int(pools[1].lens[1])
    assert _both(pools, lambda p: p.rollback(1, 2)) == 0
    for p in pools:
        with pytest.raises(Exception, match="shared page"):
            p.rollback(1, int(p.lens[1]) - 4)
    with pytest.raises(PoolError):
        pools[1].rollback(1, int(pools[1].lens[1]) - 4)
    _same_pools(*pools)
    assert int(pools[1].lens[1]) == before - 2
    _each(pools, lambda p: p.check_invariants())


def test_rollback_refreshes_prefix_registry():
    pools = _pools("reserve", n_slots=2, max_len=32)
    prompt = np.tile(np.arange(2, 6, dtype=np.int32), 3)
    _each(pools, lambda p: (p.admit(0, prompt, 12), _grow(p, 0, 12),
                            p.register_prompt(0, prompt)))
    registered = [pid for pid in pools[1]._slot_pages[0] if pid in pools[1]._page_parent]
    assert len(registered) == 3
    assert _both(pools, lambda p: p.rollback(0, 2)) == 0
    _same_pools(*pools)
    assert registered[-1] not in pools[1]._page_parent and registered[0] in pools[1]._page_parent
    _each(pools, lambda p: p.check_invariants())
    assert _both(pools, lambda p: p.admit(1, prompt, 4)) == 8
    _each(pools, lambda p: p.check_invariants())


def test_check_invariants_catches_registry_overhang():
    pools = _pools("reserve", n_slots=1, max_len=16)
    prompt = np.tile(np.arange(2, 6, dtype=np.int32), 2)
    _each(pools, lambda p: (p.admit(0, prompt, 8), _grow(p, 0, 8), p.register_prompt(0, prompt),
                            p.check_invariants()))
    for p in pools:
        p.lens[0] = 6   # a length cut without the registry refresh
        with pytest.raises(AssertionError):
            p.check_invariants()


def test_rollback_noop_and_clamp():
    pools = _pools("reserve", n_slots=1, max_len=16)
    _each(pools, lambda p: (p.admit(0, np.arange(2, 6, dtype=np.int32), 8), _grow(p, 0, 4)))
    assert _both(pools, lambda p: p.rollback(0, 0)) == 0
    assert _both(pools, lambda p: p.rollback(0, -3)) == 0
    _both(pools, lambda p: p.rollback(0, 99))
    _same_pools(*pools)
    assert int(pools[1].lens[0]) == 0
    _each(pools, lambda p: p.check_invariants())


@pytest.mark.parametrize("draft_lens", [{0: 10, 1: 2, 2: 1}, {0: 1, 1: 9, 2: 9}, {2: 3}, {}, None])
def test_plan_step_clamps_draft_lens(draft_lens):
    """Clamped to the wide width and the budget left after every decode
    row's one token, as the reference's planner; prefill rows get the
    rest."""
    plans = []
    for sched_cls, req_cls in ((RefScheduler, RefRequest), (ContinuousScheduler, Request)):
        sched = sched_cls(5, token_budget=8, prefill_chunk=4)
        prompt = np.arange(2, 6, dtype=np.int32)
        for i in range(3):
            sched.place(i, req_cls(tokens=prompt, rid=i), eos_id=1, new_limit=8, prompt=prompt,
                        prompt_pos=len(prompt))
        sched.place(3, req_cls(tokens=prompt, rid=3), eos_id=1, new_limit=8, prompt=prompt)
        plans.append([(it.slot, it.q_len, it.is_prefill, it.finishes_prompt, it.n_draft)
                      for it in sched.plan_step(draft_lens)])
    assert plans[0] == plans[1]
    assert sum(q for _, q, *_ in plans[1]) <= 8
    if draft_lens == {0: 10, 1: 2, 2: 1}:
        assert [p[1] for p in plans[1][:3]] == [4, 3, 1]


@SETTINGS
@given(seed=st.integers(0, 10_000))
def test_accept_rollback_lock_step_walk(seed):
    """test_spec.py's admit/grow/rollback/release walk (rollback of
    self-written tokens only, every finished prompt registered) on both
    pools in lock step: equal host state, invariants and lengths after
    every operation."""
    rng = np.random.default_rng(seed)
    pools = _pools("reserve" if seed % 2 else "optimistic", n_slots=3, max_len=32)
    port = pools[1]
    live: dict[int, dict] = {}
    for _ in range(50):
        op = int(rng.integers(0, 5))
        free = [s for s in range(3) if s not in live]
        if op == 0 and free:
            slot = int(rng.choice(free))
            plen = int(rng.integers(1, 12))
            prompt = rng.integers(2, 5, size=plen).astype(np.int32)
            new = int(rng.integers(1, 12))
            if _both(pools, lambda p: p.admit(slot, prompt, new)) is not None:
                live[slot] = {"len": int(port.lens[slot]), "written": 0,
                              "total": min(plen + new, port.capacity), "prompt": prompt}
        elif op == 1 and live:
            slot = int(rng.choice(list(live)))
            n = min(int(rng.integers(1, 6)), live[slot]["total"] - live[slot]["len"])
            if n <= 0:
                continue
            raised = []
            for p in pools:
                try:
                    _grow(p, slot, n)
                    raised.append(False)
                except (PoolExhausted, RefPoolExhausted):   # each package its own
                    raised.append(True)
            assert raised[0] == raised[1]
            if raised[0]:
                del live[slot]
                for p in pools:
                    p.release(slot)
            else:
                live[slot]["len"] += n
                live[slot]["written"] += n
                if live[slot]["len"] == len(live[slot]["prompt"]):
                    for p in pools:
                        p.register_prompt(slot, live[slot]["prompt"])
        elif op == 2 and live:
            slot = int(rng.choice(list(live)))
            n = min(int(rng.integers(1, 6)), live[slot]["written"])
            if n <= 0:
                continue
            _both(pools, lambda p: p.rollback(slot, n))
            live[slot]["len"] -= n
            live[slot]["written"] -= n
        elif op == 3 and live:
            slot = int(rng.choice(list(live)))
            del live[slot]
            for p in pools:
                p.release(slot)
        for p in pools:
            p.check_invariants()
        _same_pools(*pools)
        for slot, led in live.items():
            assert int(port.lens[slot]) == led["len"]
    for slot in list(live):
        for p in pools:
            p.release(slot)
    _each(pools, lambda p: p.check_invariants())
    assert port.alloc.free_count == port.alloc.n_pages - 1


@SETTINGS
@given(seed=st.integers(0, 10_000))
def test_rollback_interleaves_with_tiering_walk(seed):
    """test_spec.py's walk of the same name on both tiered pools in lock
    step: a slot spilled mid-stream, resumed, then rolled back; both tiers'
    invariants and the ledger after every operation."""
    rng = np.random.default_rng(seed)
    jcfg = ref_get_config("deepseek-7b").reduced().with_(kv_layout="paged", page_size=4)
    cfg = get_config("deepseek-7b").reduced().with_(kv_layout="paged", page_size=4)
    kw = dict(admission="optimistic", n_pages=13, host_pages=12)
    pools = (RefTiered(jcfg, 1, 3, 32, **kw), TieredPagePool(cfg, 1, 3, 32, device="cpu", **kw))
    port = pools[1]
    live: dict[int, dict] = {}
    for _ in range(50):
        op = int(rng.integers(0, 6))
        free = [s for s in range(3) if s not in live]
        active = [s for s in live if not port.is_suspended(s)]
        if op == 0 and free:
            slot = int(rng.choice(free))
            prompt = rng.integers(2, 5, size=int(rng.integers(1, 12))).astype(np.int32)
            new = int(rng.integers(1, 10))
            if _both(pools, lambda p: p.admit(slot, prompt, new)) is not None:
                live[slot] = {"len": int(port.lens[slot]), "written": 0}
        elif op == 1 and active:
            slot = int(rng.choice(active))
            n = int(rng.integers(1, 5))
            if live[slot]["len"] + n > port.capacity:
                continue
            raised = []
            for p in pools:
                try:
                    p.ensure_writable(slot, n)
                    raised.append(False)
                except (PoolExhausted, RefPoolExhausted):   # each package its own
                    raised.append(True)
            assert raised[0] == raised[1]
            if raised[0]:
                victim = next((v for v in active if port.can_spill(v)), None)
                if victim is not None:
                    assert _both(pools, lambda p: p.spill_slot(victim))
                else:
                    victim = active[0]
                    del live[victim]
                    for p in pools:
                        p.release(victim)
            else:
                for p in pools:
                    p.advance(slot, n)
                live[slot]["len"] += n
                live[slot]["written"] += n
        elif op == 2 and active:
            slot = int(rng.choice(active))
            n = min(int(rng.integers(1, 6)), live[slot]["written"])
            if n <= 0:
                continue
            _both(pools, lambda p: p.rollback(slot, n))
            live[slot]["len"] -= n
            live[slot]["written"] -= n
        elif op == 3 and active:
            slot = int(rng.choice(active))
            if _both(pools, lambda p: p.can_spill(slot)):
                assert _both(pools, lambda p: p.spill_slot(slot))
        elif op == 4:
            sus = port.suspended_slots()
            if not sus:
                continue
            slot = int(rng.choice(sus))
            if not port._suspended[slot].started:
                for p in pools:
                    p.start_resume(slot)
            depth = int(rng.integers(1, 4))
            _both(pools, lambda p: p.issue_fetches(slot, depth))
            if _both(pools, lambda p: p.resume_ready(slot)):
                _both(pools, lambda p: p.complete_resume(slot))
        elif op == 5 and live:
            slot = int(rng.choice(list(live)))
            del live[slot]
            for p in pools:
                p.release(slot)
        for p in pools:
            p.check_invariants()
        _same_pools(*pools)
        assert port.suspended_slots() == pools[0].suspended_slots()
        for slot, led in live.items():
            assert int(port.lens[slot]) == led["len"]
    for slot in list(live):
        for p in pools:
            p.release(slot)
    _each(pools, lambda p: p.check_invariants())


# ---- drafters ---------------------------------------------------------------------------


def test_ngram_drafter_copy_from_lag():
    d, ref = NgramDrafter(ngram_max=4), RefNgramDrafter(ngram_max=4)
    ctx = np.tile(np.arange(1, 5, dtype=np.int32), 3)
    assert d.draft(0, ctx, 6) == [1, 2, 3, 4, 1, 2]
    assert d.draft(0, ctx, 10) == [1, 2, 3, 4, 1, 2, 3, 4, 1, 2]
    assert d.draft(0, np.arange(1, 9, dtype=np.int32), 4) == []
    assert d.draft(0, np.asarray([7], dtype=np.int32), 4) == []
    rng = np.random.default_rng(0)
    for n in range(0, 40):
        ctx = rng.integers(0, 4, size=n).astype(np.int32)
        for k in (0, 1, 4):
            assert d.draft(0, ctx, k) == ref.draft(0, ctx, k), (ctx, k)
    with pytest.raises(ValueError):
        NgramDrafter(ngram_max=1, ngram_min=2)
    assert make_drafter("none") is None and isinstance(make_drafter("ngram"), NgramDrafter)
    with pytest.raises(ValueError, match="needs lm"):
        make_drafter("model")
    with pytest.raises(ValueError, match="unknown"):
        make_drafter("oracle")


# ---- the engine -------------------------------------------------------------------------

ENGINE = dict(batch_size=2, max_len=128, scheduler="continuous", page_size=8, prefill_chunk=8)
SPEC_COUNTERS = ("serve.spec.draft_tokens", "serve.spec.accepted_tokens",
                 "serve.spec.rollback_tokens", "serve.step_retries", "serve.tokens.generated")


def _spec_requests(request_cls, max_new=32, temperature=0.0, seeds=(5, 8)):
    """test_spec.py's stream: short cyclic prompts prompt lookup can draft."""
    reqs = []
    for i, s in enumerate(seeds):
        rng = np.random.default_rng(s)
        toks = np.tile(rng.integers(5, 20, size=4), 6).astype(np.int32)
        reqs.append(request_cls(tokens=toks, max_new_tokens=max_new, temperature=temperature,
                                rid=i, seed=i))
    return reqs


def _conserved(eng, before=0.0):
    v = eng.obs.value
    drafted = v("serve.spec.draft_tokens") - before
    assert drafted > 0
    assert eng.last_stats.accepted_tokens + eng.last_stats.rollback_tokens == \
        eng.last_stats.draft_tokens == drafted


@pytest.fixture(scope="module")
def engines(models):
    """Speculative engines of both packages, one pair per (drafter kind,
    config), kept across tests that differ only in ``draft_len`` or the
    fault plan (engine attributes read at each ``generate``), so the
    reference compiles its steps once per pair; and the port's
    non-speculative streams per (config, temperature, tokens)."""
    jlm, jparams, lm, params = models
    pairs, plain = {}, {}

    def models_for(cfg_kw):
        if not cfg_kw:
            return jlm, lm
        return (ref_build_model(jlm.cfg.with_(**cfg_kw)),
                build_model(lm.cfg.with_(**cfg_kw), device="cpu"))

    def pair(kind, cfg_kw=()):
        key = (kind, cfg_kw)
        if key not in pairs:
            j, m = models_for(dict(cfg_kw))
            if kind == "ngram":
                rd, pd = RefNgramDrafter(ngram_max=4), NgramDrafter(ngram_max=4)
            else:
                kw = dict(n_slots=2, max_len=128, page_size=8, prefill_chunk=8)
                rd, pd = RefModelDrafter(j, jparams, **kw), ModelDrafter(m, params, **kw)
            pairs[key] = (RefEngine(j, jparams, drafter=rd, **ENGINE),
                          ServeEngine(m, params, drafter=pd, device="cpu", **ENGINE))
        return pairs[key]

    def base(cfg_kw=(), temperature=0.0, max_new=32):
        key = (cfg_kw, temperature, max_new)
        if key not in plain:
            _, m = models_for(dict(cfg_kw))
            plain[key] = ServeEngine(m, params, device="cpu", **ENGINE).generate(
                _spec_requests(Request, temperature=temperature, max_new=max_new))
        return plain[key]

    return pair, base


def _against_reference(engines, kind="ngram", draft_len=4, cfg_kw=(), plan_of=None,
                       max_new=32):
    """The same speculative run on both packages: streams, statuses, every
    StepStats field and the counters equal; the streams also equal to the
    port's own run without a drafter. Returns the port's engine."""
    pair, base = engines
    ref, eng = pair(kind, cfg_kw)
    ref.draft_len = eng.draft_len = draft_len
    ref.faults = ref_plan = plan_of(RefFaultPlan) if plan_of else None
    eng.faults = plan = plan_of(FaultPlan) if plan_of else None
    before = {k: (ref.obs.value(k), eng.obs.value(k)) for k in SPEC_COUNTERS}
    want = ref.generate(_spec_requests(RefRequest, max_new=max_new))
    got = eng.generate(_spec_requests(Request, max_new=max_new))
    for a, b, c in zip(want, got, base(cfg_kw, 0.0, max_new)):
        assert (b.rid, b.status, b.steps) == (a.rid, a.status, a.steps) and b.status == "ok"
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_array_equal(b.tokens, c.tokens)
    for f in dataclasses.fields(StepStats):
        assert getattr(eng.last_stats, f.name) == getattr(ref.last_stats, f.name), f.name
    for key, (r0, e0) in before.items():
        assert eng.obs.value(key) - e0 == ref.obs.value(key) - r0, key
    if plan is not None:
        assert plan.fired == ref_plan.fired
    _conserved(eng, before["serve.spec.draft_tokens"][1])
    assert eng.compiled_step_count() == ref.compiled_step_count() <= 2
    eng.last_pool.check_invariants()
    return eng


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_engine_streams_and_counts_equal_reference(engines, kind):
    eng = _against_reference(engines, kind)
    if kind == "model":
        assert eng.drafter.compiled_step_count() == 2 and eng.drafter.steps > 0


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_sampled_speculative_stream_equals_non_speculative(engines, kind):
    """Sampled rows: position p of a verification chunk draws with sample
    index count + p, the draw sequential steps make, so the speculative
    stream equals the port's non-speculative one."""
    pair, base = engines
    _, eng = pair(kind)
    eng.draft_len, eng.faults = 4, None
    drafted = eng.obs.value("serve.spec.draft_tokens")
    got = eng.generate(_spec_requests(Request, temperature=0.8))
    for a, b in zip(base((), 0.8), got):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    _conserved(eng, drafted)
    assert eng.compiled_step_count() == 2


@pytest.mark.parametrize("order", ["block_snake"])
def test_engine_equals_reference_across_orders(engines, order):
    _against_reference(engines, cfg_kw=(("attn_order", order), ("snake_group", 2)), max_new=24)


def test_engine_equals_reference_on_int8_pages(engines):
    _against_reference(engines, cfg_kw=(("kv_cache_dtype", "int8"),), max_new=24)


def test_step_fault_mid_verification_equals_reference(engines):
    """A device-step failure in the middle of verification is retried
    once; the drafts of the failed step are verified again."""
    retries = engines[0]("ngram")[1].obs.value("serve.step_retries")
    eng = _against_reference(engines, plan_of=lambda P: P(seed=0).fail_device_step(6))
    assert eng.obs.value("serve.step_retries") - retries == 1


def test_self_speculation_equals_reference(engines):
    """The target as its own draft model at K 7 (the reference test's
    case): the streams and the draft, accepted and rolled-back counts equal
    to the reference's (42 of 48 accepted on both: every draft matches its
    target, but one row emits the EOS with 6 drafts after it), and the
    steps fewer than half the non-speculative run's."""
    eng = _against_reference(engines, kind="model", draft_len=7)
    st_ = eng.last_stats
    assert (st_.draft_tokens, st_.accepted_tokens, st_.rollback_tokens) == (48, 42, 6)
    base = ServeEngine(eng.lm, eng.params, device="cpu", **ENGINE)
    base.generate(_spec_requests(Request))
    assert st_.mixed_steps < base.last_stats.mixed_steps / 2


def test_ngram_engine_equals_reference_on_olmoe():
    """The MoE family under speculation (olmoe-1b-7b ``.reduced()``, its
    reference init): every verification row routed through the dropless
    grouped products gives the reference's streams, StepStats and drafted,
    accepted and rolled-back counts, equal to the port's own run without a
    drafter."""
    jlm = ref_build_model(ref_get_config("olmoe-1b-7b").reduced())
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = build_model(get_config("olmoe-1b-7b").reduced(), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    ref = RefEngine(jlm, jparams, drafter=RefNgramDrafter(ngram_max=4), **ENGINE)
    eng = ServeEngine(lm, params, drafter=NgramDrafter(ngram_max=4), device="cpu", **ENGINE)
    ref.draft_len = eng.draft_len = 4
    want = ref.generate(_spec_requests(RefRequest))
    got = eng.generate(_spec_requests(Request))
    base = ServeEngine(lm, params, device="cpu", **ENGINE).generate(_spec_requests(Request))
    for a, b, c in zip(want, got, base):
        assert (b.rid, b.status, b.steps) == (a.rid, a.status, a.steps) and b.status == "ok"
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_array_equal(b.tokens, c.tokens)
    for f in dataclasses.fields(StepStats):
        assert getattr(eng.last_stats, f.name) == getattr(ref.last_stats, f.name), f.name
    _conserved(eng)
    assert eng.compiled_step_count() == ref.compiled_step_count() <= 2


@pytest.mark.parametrize("draft_len", [2, 7])
def test_speculative_keeps_two_step_graphs(models, draft_len):
    _, _, lm, params = models
    eng = ServeEngine(lm, params, drafter=NgramDrafter(ngram_max=4), draft_len=draft_len,
                      device="cpu", **ENGINE)
    eng.generate(_spec_requests(Request))
    assert eng.compiled_step_count() == 2
    eng.generate(_spec_requests(Request, max_new=16))
    assert eng.compiled_step_count() == 2 and eng.last_stats.draft_tokens > 0


class NoHostRead(TorchDispatchMode):
    """Fails on any read of a tensor's value by the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("host read inside a captured step")
        return func(*args, **(kwargs or {}))


def _guard(step):
    fn = step.fn

    def under_guard(**inputs):
        with NoHostRead():
            return fn(**inputs)

    step.fn = under_guard
    return step


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_tiered_speculative_steps_read_no_host_value(models, kind):
    """A run that spills, resumes and verifies drafts on a pool below its
    working set, every mixed step (and the model drafter's steps) under
    the dispatch mode that fails on a host read: the tier and the
    verification change only staged inputs and pool contents, so a
    capture holds them. Its streams equal the untiered non-speculative
    run's."""
    jlm, jparams, lm, params = models
    kw = dict(ENGINE, max_len=64)
    drafter = NgramDrafter() if kind == "ngram" else ModelDrafter(
        lm, params, n_slots=2, max_len=64, page_size=8, prefill_chunk=8)
    eng = ServeEngine(lm, params, drafter=drafter, device="cpu", admission="optimistic",
                      pool_pages=8, host_pages=24, prefetch_depth=4, max_preemptions=50, **kw)
    guarded = []
    for owner, attr in ((eng, "_mixed_step"), (drafter, "_step")):
        inner = getattr(owner, attr, None)
        if inner is None:
            continue

        def wrap(*args, _inner=inner):
            step = _inner(*args)
            if step not in guarded:
                guarded.append(_guard(step))
            return step

        setattr(owner, attr, wrap)
    got = eng.generate(_spec_requests(Request, max_new=16, seeds=(5, 8, 9)))
    base = ServeEngine(lm, params, device="cpu", **kw).generate(
        _spec_requests(Request, max_new=16, seeds=(5, 8, 9)))
    for a, b in zip(base, got):
        assert b.status == "ok"
        np.testing.assert_array_equal(b.tokens, a.tokens)
    st_ = eng.last_stats
    assert st_.spills >= 1 and st_.draft_tokens > 0 and eng.compiled_step_count() <= 2
    drafted = drafter.compiled_step_count() if kind == "model" else 0
    assert len(guarded) == eng.compiled_step_count() + drafted
    eng.last_pool.check_invariants()
