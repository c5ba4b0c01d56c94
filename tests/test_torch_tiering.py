"""The port's host KV tier (``serve.tiering``) against the JAX package's.

The cases of ``tests/test_tiering.py`` run on both packages: the same
operations on the reference's ``TieredPagePool`` and the port's, in lock
step, with the same random page payloads. Host state is compared exactly
after every operation (block tables, lengths, refcounts, reservations,
host handles, the suspended set, fetch queues, the prefetch accounting and
the byte counters), and so are the page rows a spill and resume carry, on
every leaf, int8 payloads and scale planes included. The fetch order
(``future_visit_window``) and the spill victim policy equal the
reference's for every case given. Then the engine: deepseek-7b
``.reduced()`` (f32, the reference's weights by ``params_from_jax``) on a
pool below its working set, its spills, resumes, counters and greedy
streams equal to the reference's (bf16-free: f32 and int8 pages), the
streams also equal to the port's own untiered run, with two step graphs;
a stalled spill falls back to preemption and dropped fetches resume late,
both as the reference does.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as ref_get_config
from repro.core.cache_sim import slot_reuse_stats as ref_slot_reuse_stats
from repro.core.schedule import future_visit_window as ref_future_visit_window
from repro.models import build_model as ref_build_model
from repro.serve import FaultPlan as RefFaultPlan
from repro.serve import HostPageStore as RefHostPageStore
from repro.serve import PoolExhausted as RefPoolExhausted
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro.serve import TieredPagePool as RefTiered
from repro.serve import select_spill_victim as ref_select_spill_victim
from repro_torch.configs import get_config
from repro_torch.core.cache_sim import slot_reuse_stats
from repro_torch.core.schedule import Order, future_visit_window, resolve_order_group
from repro_torch.models import build_model
from repro_torch.serve import (
    FaultPlan,
    HostPageStore,
    PoolExhausted,
    Request,
    ServeEngine,
    StepStats,
    TieredPagePool,
    select_spill_victim,
)
from repro_torch.testing import params_from_jax

SETTINGS = settings(max_examples=10, deadline=None)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jlm = ref_build_model(ref_get_config("deepseek-7b").reduced())
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = build_model(get_config("deepseek-7b").reduced(), device="cpu")
    return jlm, jparams, lm, params_from_jax(jax.tree.map(np.asarray, jparams))


# ---- pools in lock step ----------------------------------------------------------


def _pools(n_pages=13, host_pages=16, n_slots=3, **cfg_kw):
    """test_tiering.py's pool (page 4, one layer, max_len 32, optimistic)
    on both packages."""
    kw = dict(kv_layout="paged", page_size=4, **cfg_kw)
    jcfg = ref_get_config("deepseek-7b").reduced().with_(**kw)
    cfg = get_config("deepseek-7b").reduced().with_(**kw)
    common = dict(admission="optimistic", n_pages=n_pages, host_pages=host_pages)
    return (RefTiered(jcfg, 1, n_slots, 32, **common),
            TieredPagePool(cfg, 1, n_slots, 32, device="cpu", **common))


def _same_pools(ref, port):
    np.testing.assert_array_equal(port.block_tables, ref.block_tables)
    np.testing.assert_array_equal(port.lens, ref.lens)
    np.testing.assert_array_equal(port._ref, ref._ref)
    assert port._slot_pages == ref._slot_pages
    assert port._slot_reserved == ref._slot_reserved
    assert port.alloc._free == ref.alloc._free
    assert port.alloc.reserved == ref.alloc.reserved
    assert port._page_parent == ref._page_parent
    assert port.suspended_slots() == ref.suspended_slots()
    for slot, sus in ref._suspended.items():
        mine = port._suspended[slot]
        assert (mine.handles, mine.reserved, mine.queue, mine.staged) == \
            (sus.handles, sus.reserved, sus.queue, sus.staged), slot
    assert port._pending == ref._pending
    assert port.host.used == ref.host.used and port.host.nbytes == ref.host.nbytes
    for key in ("spills", "fetches", "prefetch_hits", "prefetch_wasted", "fetch_failures",
                "spill_bytes", "fetch_bytes", "_overlapped"):
        assert getattr(port, key) == getattr(ref, key), key


def _fill_random(ref, port, seed=0):
    """The same recognisable payloads in every leaf of both pools."""
    rng = np.random.default_rng(seed)
    for name, leaf in port.pages.items():
        if leaf.dtype.is_floating_point:
            arr = rng.standard_normal(tuple(leaf.shape)).astype(np.float32)
        else:
            arr = rng.integers(-100, 100, size=tuple(leaf.shape)).astype(np.int8)
        ref.pages[name] = jnp.asarray(arr, dtype=ref.pages[name].dtype)
        leaf.copy_(torch.from_numpy(arr).to(leaf.dtype))


def _slot_rows(pool, slot):
    pids = list(pool._slot_pages[slot])
    return {name: np.asarray(leaf)[:, pids] for name, leaf in pool.pages.items()}


def _same_rows(a: dict, b: dict):
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _both(pools, fn):
    """``fn`` on each pool; the two results must be equal."""
    got = [fn(p) for p in pools]
    assert got[0] == got[1], got
    return got[0]


def _grow(pool, slot, n):
    pool.ensure_writable(slot, n)
    pool.advance(slot, n)


def _resume(pool, slot, depth=2, order=None):
    pool.start_resume(slot, order=order)
    while not pool.resume_ready(slot):
        assert pool.issue_fetches(slot, depth) > 0
    assert pool.complete_resume(slot)


# ---- the store, the victim policy, the fetch order -----------------------------------


def test_host_store_bounded_roundtrip():
    """The bound, the handles and the byte count as the reference's store
    (which holds numpy rows; the port's holds tensors)."""
    for store_cls, make in ((RefHostPageStore, lambda shape: np.ones(shape, np.float32)),
                            (HostPageStore, torch.ones)):
        store = store_cls(2)
        h0 = store.put({"k": make((1, 8))})
        h1 = store.put({"k": 2 * make((1, 8))})
        assert (h0, h1, store.used, store.free, store.nbytes) == (0, 1, 2, 0, 2 * 8 * 4)
        with pytest.raises(Exception, match="host page tier full"):
            store.put({"k": make((1, 8))})
        assert float(store.pop(h1)["k"].sum()) == 16.0
        assert store.free == 1 and store.put({"k": make((1, 8))}) == 2
    s = HostPageStore(1)
    s.put({})
    with pytest.raises(PoolExhausted):
        s.put({})
    with pytest.raises(ValueError):
        HostPageStore(0)


@pytest.mark.parametrize("cands", [
    [],
    [(0, 1, False, 99.0), (1, 0, True, 0.0)],
    [(0, 0, True, 99.0), (1, 0, False, 1.0)],
    [(0, 0, False, 2.0), (1, 0, False, 7.0), (2, 0, False, 4.0)],
    [(2, 0, False, 3.0), (0, 0, False, 3.0), (1, 0, False, 3.0)],
])
def test_select_spill_victim_equals_reference(cands):
    assert select_spill_victim(cands) == ref_select_spill_victim(cands)


@pytest.mark.parametrize("order", ["sawtooth", "cyclic", "block_snake"])
def test_reuse_distance_ranking_equals_reference(order):
    """The ranking signal and the victim it picks: sawtooth spills the
    shortest stream first, cyclic ties and falls to the slot index."""
    lens = [8, 16, 32, 0, 20]
    got = slot_reuse_stats(order, lens, 4, snake_group=2)
    want = ref_slot_reuse_stats(order, lens, 4, snake_group=2)
    assert [s["mean"] for s in got] == [s["mean"] for s in want]
    cands = [(i, 0, False, s["mean"]) for i, s in enumerate(got)]
    assert select_spill_victim(cands) == ref_select_spill_victim(cands)
    if order == "sawtooth":
        assert got[0]["mean"] > got[1]["mean"] > got[2]["mean"]


def test_future_visit_window_equals_reference():
    """Every order and group, parities, page counts and depths."""
    for n_kv in range(0, 11):
        groups = {resolve_order_group(o, g, max(n_kv, 1)) for o in Order for g in (1, 2, 3)}
        for group in sorted(groups | {0, 1, 4, 64}):
            for parity in range(0, 5):
                for depth in (0, 1, 3, n_kv, n_kv + 5):
                    assert future_visit_window(parity, n_kv, depth, group) == \
                        ref_future_visit_window(parity, n_kv, depth, group), \
                        (parity, n_kv, depth, group)


# ---- spill and resume ------------------------------------------------------------------


@pytest.mark.parametrize("kv_cache_dtype", ["float32", "int8"])
def test_spill_resume_roundtrip_equals_reference(kv_cache_dtype):
    """A spill and a resume in a noisy visit order: the same host state as
    the reference's at every stage, every leaf's rows back to the bit
    (int8 payloads and scale planes too), and the accounting closed."""
    pools = _pools(kv_cache_dtype=kv_cache_dtype)
    ref, port = pools
    prompt = np.random.default_rng(3).integers(2, 5, size=10).astype(np.int32)
    _both(pools, lambda p: p.admit(0, prompt, 8))
    for p in pools:
        _grow(p, 0, len(prompt))
    _fill_random(ref, port)
    before = _slot_rows(port, 0)
    _same_rows(before, _slot_rows(ref, 0))
    n_pages = len(port._slot_pages[0])
    free_before = port.alloc.free_count

    assert _both(pools, lambda p: p.spill_slot(0))
    for p in pools:
        p.check_invariants()
    _same_pools(ref, port)
    assert port.is_suspended(0) and not port.can_spill(0)
    assert port.host.used == n_pages and not port._slot_pages[0]
    assert port.alloc.free_count == free_before + n_pages
    assert port.spill_bytes == port.host.nbytes
    want = ref.host.get(ref._suspended[0].handles[0])
    got = port.host.get(port._suspended[0].handles[0])
    _same_rows({k: v.numpy() for k, v in got.items()}, want)

    assert _both(pools, lambda p: p.resume_need(0)) == n_pages
    for p in pools:
        p.start_resume(0, order=[n_pages - 1, 99, -1])
    _same_pools(ref, port)
    while not port.resume_ready(0):
        assert _both(pools, lambda p: p.issue_fetches(0, 2)) > 0
        _same_pools(ref, port)
    assert _both(pools, lambda p: p.complete_resume(0))
    for p in pools:
        p.check_invariants()
    _same_pools(ref, port)
    after = _slot_rows(port, 0)
    _same_rows(before, after)
    _same_rows(after, _slot_rows(ref, 0))
    assert port.fetches == n_pages and port.fetch_bytes == port.spill_bytes

    assert port.shielded(0)
    for p in pools:
        _grow(p, 0, 1)
    _same_pools(ref, port)
    assert not port.shielded(0) and port.prefetch_hits == n_pages
    for p in pools:
        p.release(0)
        p.check_invariants()
    _same_pools(ref, port)
    assert port.alloc.free_count == port.alloc.n_pages - 1


def test_release_while_suspended_counts_wasted():
    pools = _pools()
    for p in pools:
        assert p.admit(0, np.arange(2, 10).astype(np.int32), 4) is not None
        _grow(p, 0, 8)
        assert p.spill_slot(0)
        p.start_resume(0)
    assert _both(pools, lambda p: p.issue_fetches(0, 1)) == 1
    for p in pools:
        p.release(0)
        p.check_invariants()
    _same_pools(*pools)
    ref, port = pools
    assert port.host.used == 0 and port.prefetch_wasted == 1
    assert port.fetches == port.prefetch_hits + port.prefetch_wasted


def test_next_resume_picks_one_slot_into_calm():
    """``next_resume``, the tier's resume policy: with two suspended slots,
    the first the pool can cover; none while another resume has started;
    none where the pool cannot cover the slot's pages and reservation; and
    under the spill watermark only (calm) while a slot is runnable, the
    rule waived when none is."""
    _, pool = _pools(n_pages=10)
    rng = np.random.default_rng(3)
    for slot in (0, 1):
        assert pool.admit(slot, rng.integers(2, 100, size=8).astype(np.int32), 8) == 0
        _grow(pool, slot, 8)
        assert pool.spill_slot(slot)
    assert pool.suspended_slots() == [0, 1] and pool.resume_need(0) == 2
    assert pool.next_resume(0.5, runnable=True) == 0
    # Slot 2 holds 6 of 10 pages: a resume of 2 would bring occupancy to 0.8.
    assert pool.admit(2, rng.integers(2, 100, size=24).astype(np.int32), 8) == 0
    _grow(pool, 2, 24)
    assert pool.occupancy() == 0.6 and pool.alloc.available == 4
    assert pool.next_resume(0.85, runnable=True) == 0
    assert pool.next_resume(0.75, runnable=True) is None
    assert pool.next_resume(0.75, runnable=False) == 0
    pool.start_resume(0)
    for wm, runnable in ((1.0, True), (1.0, False), (0.5, False)):
        assert pool.next_resume(wm, runnable=runnable) is None
    assert pool.issue_fetches(0, 8) == 2 and pool.complete_resume(0)
    assert pool.next_resume(1.0, runnable=True) is None   # 8 + 2 of 10 pages
    assert pool.next_resume(1.0, runnable=False) == 1
    # Slot 2 grows to take every free page: slot 1 cannot be covered.
    _grow(pool, 2, 8)
    assert pool.alloc.available < pool.resume_need(1)
    assert pool.next_resume(1.0, runnable=False) is None
    pool.release(2)
    assert pool.next_resume(1.0, runnable=False) == 1
    pool.check_invariants()


def test_complete_resume_is_atomic_under_pressure():
    pools = _pools(n_pages=13)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, 200, size=n).astype(np.int32) for n in (16, 20, 16)]
    for p in pools:
        assert p.admit(0, prompts[0], 4) is not None
        _grow(p, 0, 16)
        assert p.spill_slot(0)
        assert p.admit(1, prompts[1], 4) is not None
        _grow(p, 1, 20)
        _grow(p, 1, 4)
        assert p.admit(2, prompts[2], 4) is not None
        _grow(p, 2, 16)
        p.start_resume(0)
        while p.issue_fetches(0, 4):
            pass
    _same_pools(*pools)
    ref, port = pools
    assert port.resume_ready(0) and port.alloc.available < port.resume_need(0)
    assert not _both(pools, lambda p: p.complete_resume(0))
    for p in pools:
        p.check_invariants()
    _same_pools(ref, port)
    assert port.is_suspended(0) and port.host.used == 4
    for p in pools:
        p.release(2)
    assert _both(pools, lambda p: p.complete_resume(0))
    for p in pools:
        p.check_invariants()
    _same_pools(ref, port)
    assert len(port._slot_pages[0]) == 4 and port.host.used == 0


def test_spill_donor_keeps_serving_adopters():
    """Spilling a prefix donor: the adopter's pages untouched to the bit,
    the donor back on private copies with the same bits, both pools
    alike."""
    pools = _pools()
    ref, port = pools
    prompt = np.arange(2, 10).astype(np.int32)
    for p in pools:
        assert p.admit(0, prompt, 4) is not None
        _grow(p, 0, len(prompt))
        p.register_prompt(0, prompt)
    _fill_random(ref, port, seed=1)
    assert _both(pools, lambda p: p.admit(1, prompt, 4))
    shared = set(port._slot_pages[0]) & set(port._slot_pages[1])
    assert shared
    donor, adopter = _slot_rows(port, 0), _slot_rows(port, 1)
    assert _both(pools, lambda p: p.spill_slot(0))
    for p in pools:
        p.check_invariants()
    _same_pools(ref, port)
    assert all(port._ref[pid] >= 1 for pid in shared)
    _same_rows(adopter, _slot_rows(port, 1))
    for p in pools:
        _resume(p, 0)
        p.check_invariants()
    _same_pools(ref, port)
    _same_rows(donor, _slot_rows(port, 0))
    _same_rows(_slot_rows(port, 0), _slot_rows(ref, 0))
    assert all(port._ref[pid] == 1 for pid in port._slot_pages[0])
    for p in pools:
        p.release(0)
        p.release(1)
        p.check_invariants()
    _same_pools(ref, port)


@pytest.mark.parametrize("host_pages,admissible", [(16, True), (2, False)])
def test_can_admit_counts_both_tiers(host_pages, admissible):
    pools = _pools(n_pages=8, host_pages=host_pages)
    prompt = np.random.default_rng(1).integers(2, 200, size=16).astype(np.int32)
    for p in pools:
        assert p.admit(0, prompt, 16) is not None
        _grow(p, 0, 16)
    assert _both(pools, lambda p: p.can_admit(16, 16)) == admissible


@SETTINGS
@given(seed=st.integers(0, 2**16))
def test_cross_tier_lifecycle_lock_step_walk(seed):
    """test_tiering.py's random walk (admit, grow with a spill or a release
    under real exhaustion, proactive spill, staged resume in a random
    partial order, release in either state) on both pools in lock step:
    the same refusals and exhaustions, equal host state and invariants
    after every operation, lengths conserved across suspension, and a
    drained pool all free on both tiers with the accounting closed."""
    rng = np.random.default_rng(seed)
    pools = _pools(n_pages=13, host_pages=10)
    ref, port = pools
    live: dict[int, list] = {}   # slot -> [len, total]
    for _ in range(60):
        op = int(rng.integers(0, 6))
        free = [s for s in range(3) if s not in live]
        active = [s for s in live if not port.is_suspended(s)]
        if op == 0 and free:
            slot = int(rng.choice(free))
            n = int(rng.integers(1, 20))
            prompt = rng.integers(2, 5, size=n).astype(np.int32)
            new = int(rng.integers(1, 12))
            if _both(pools, lambda p: p.admit(slot, prompt, new)) is not None:
                live[slot] = [int(port.lens[slot]), min(n + new, port.capacity)]
        elif op == 1 and active:
            slot = int(rng.choice(active))
            n = min(int(rng.integers(1, 5)), live[slot][1] - live[slot][0])
            if n <= 0:
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
                assert victim == next((v for v in active if ref.can_spill(v)), None)
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
                live[slot][0] += n
        elif op == 2 and active:
            slot = int(rng.choice(active))
            if _both(pools, lambda p: p.can_spill(slot)):
                assert _both(pools, lambda p: p.spill_slot(slot))
        elif op == 3:
            sus = port.suspended_slots()
            if not sus:
                continue
            slot = int(rng.choice(sus))
            if not port._suspended[slot].started:
                n_pg = len(port._suspended[slot].handles)
                order = [int(x) for x in rng.permutation(n_pg)][: n_pg // 2]
                for p in pools:
                    p.start_resume(slot, order=order)
            depth = int(rng.integers(1, 4))
            _both(pools, lambda p: p.issue_fetches(slot, depth))
            if _both(pools, lambda p: p.resume_ready(slot)):
                _both(pools, lambda p: p.complete_resume(slot))
        elif op == 4 and live:
            slot = int(rng.choice(list(live)))
            del live[slot]
            for p in pools:
                p.release(slot)
        for p in pools:
            p.check_invariants()
        _same_pools(ref, port)
        for slot, (length, _) in live.items():
            assert int(port.lens[slot]) == length
            assert port.offslot_pages(slot) == (
                len(port._suspended[slot].handles) if port.is_suspended(slot) else 0)
    for slot in list(live):
        for p in pools:
            p.release(slot)
    for p in pools:
        p.check_invariants()
    _same_pools(ref, port)
    assert port.alloc.free_count == port.alloc.n_pages - 1 and port.alloc.reserved == 0
    assert port.host.used == 0
    assert port.fetches == port.prefetch_hits + port.prefetch_wasted


def test_reset_empties_both_tiers():
    """The engine resets its pool between streams: the host tier and the
    counters too."""
    _, port = _pools()
    assert port.admit(0, np.arange(2, 10).astype(np.int32), 4) is not None
    _grow(port, 0, 8)
    assert port.spill_slot(0)
    port.reset()
    port.check_invariants()
    assert (port.host.used, port.spills, port.spill_bytes, port.suspended_slots()) == (0, 0, 0, [])
    np.testing.assert_array_equal(port.step_lens(), port.lens)


# ---- the engine -----------------------------------------------------------------------

ENGINE = dict(batch_size=2, max_len=64, scheduler="continuous", page_size=8, prefill_chunk=8)
TIER_KW = dict(admission="optimistic", pool_pages=8, host_pages=24, prefetch_depth=4,
               max_preemptions=50)
TIER_COUNTERS = ("tier.spills", "tier.fetches", "tier.prefetch_hits", "tier.prefetch_wasted",
                 "tier.fetch_failures", "tier.spill_bytes", "tier.fetch_bytes")
# (engine arguments on top of ENGINE, config overrides, a fault-plan builder)
SCENARIOS = {
    "tiered": (TIER_KW, {}, None),
    "tiered_int8": (TIER_KW, {"kv_cache_dtype": "int8"}, None),
    "tiered_cyclic_depth1": (dict(TIER_KW, prefetch_depth=1, spill_watermark=0.7),
                             {"attn_order": "cyclic"}, None),
    "spill_stall": (TIER_KW, {}, lambda P: P().spill_stall(0, times=100)),
    "fetch_fail": (TIER_KW, {}, lambda P: P().fetch_fail(0, times=3)),
}


def _reqs(request_cls, vocab, n=4, plen=20, max_new=16):
    rng = np.random.default_rng(5)
    return [request_cls(tokens=rng.integers(2, vocab, size=plen).astype(np.int32),
                        max_new_tokens=max_new, rid=i) for i in range(n)]


def _tier_events(tracer):
    return [(ev.name, dict(ev.args or {})) for ev in tracer.events()
            if ev.name in ("serve.spill", "serve.tier_resume", "serve.preempt")]


@pytest.fixture(scope="module")
def engines(models):
    """Engines kept across scenarios that differ only in their fault plan
    (the plan is an engine attribute read at each ``generate``), so the
    reference compiles its steps once per configuration."""
    jlm, jparams, lm, params = models
    cache = {}

    def get(kw, cfg_kw):
        key = (tuple(sorted(kw.items())), tuple(sorted(cfg_kw.items())))
        if key not in cache:
            j, m = jlm, lm
            if cfg_kw:
                j = ref_build_model(jlm.cfg.with_(**cfg_kw))
                m = build_model(lm.cfg.with_(**cfg_kw), device="cpu")
            plain = ServeEngine(m, params, device="cpu", **ENGINE).generate(
                _reqs(Request, m.cfg.vocab))
            cache[key] = (RefEngine(j, jparams, **ENGINE, **kw),
                          ServeEngine(m, params, device="cpu", **ENGINE, **kw), plain)
        return cache[key]

    return get


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tiered_engine_equals_reference(engines, name):
    """The same spills (victims and pages), resumes, preemptions, stats,
    tier counters and greedy streams as the reference's engine; the streams
    also equal to the port's own engine without a tier; two step graphs."""
    kw, cfg_kw, plan_of = SCENARIOS[name]
    ref, eng, plain = engines(kw, cfg_kw)
    vocab = eng.lm.cfg.vocab
    ref.faults = ref_plan = plan_of(RefFaultPlan) if plan_of else None
    eng.faults = plan = plan_of(FaultPlan) if plan_of else None
    keys = TIER_COUNTERS + ("serve.preemptions",)
    before = {k: (ref.obs.value(k), eng.obs.value(k)) for k in keys}
    ref.tracer.clear()
    eng.tracer.clear()
    want = ref.generate(_reqs(RefRequest, vocab))
    got = eng.generate(_reqs(Request, vocab))
    for a, b, c in zip(want, got, plain):
        assert (b.rid, b.status, b.steps, b.n_preemptions) == \
            (a.rid, a.status, a.steps, a.n_preemptions)
        assert b.status == "ok"
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_array_equal(b.tokens, c.tokens)
    for f in dataclasses.fields(StepStats):
        assert getattr(eng.last_stats, f.name) == getattr(ref.last_stats, f.name), f.name
    delta = {k: (ref.obs.value(k) - r0, eng.obs.value(k) - e0) for k, (r0, e0) in before.items()}
    for key, (r, e) in delta.items():
        assert e == r, key
    assert _tier_events(eng.tracer) == _tier_events(ref.tracer)
    if plan is not None:
        assert plan.fired == ref_plan.fired
    pool = eng.last_pool
    pool.check_invariants()
    assert pool.fetches == pool.prefetch_hits + pool.prefetch_wasted
    assert eng.compiled_step_count() == 2
    st_ = eng.last_stats
    if name == "spill_stall":
        assert st_.spills == 0 and st_.preemptions >= 1
    else:
        assert st_.spills >= 1 and st_.prefetch_hits >= 1 and st_.preemptions == 0
        row_bytes = sum(t[:, 0].numel() * t.element_size() for t in pool.pages.values())
        assert delta["tier.spill_bytes"][1] == row_bytes * pool.fetches == pool.spill_bytes
        assert delta["tier.fetch_bytes"][1] == row_bytes * pool.fetches == pool.fetch_bytes
    if name == "fetch_fail":
        assert pool.fetch_failures >= 1
    assert eng.obs.value("tier.overlap_frac") == ref.obs.value("tier.overlap_frac")


def test_tiered_engine_reruns_equal(engines):
    """Streams through one tiered engine (its pool reset, the host tier
    emptied between them) repeat exactly, through the same two step
    graphs."""
    _, eng, _ = engines(TIER_KW, {})
    eng.faults = None
    first = eng.generate(_reqs(Request, eng.lm.cfg.vocab))
    stats = eng.last_stats
    again = eng.generate(_reqs(Request, eng.lm.cfg.vocab))
    assert eng.last_stats == stats and stats.spills >= 1
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert eng.compiled_step_count() == 2


def test_tie_rule_steps():
    """The tie rule the card holds the tiered int8 runs to: two rounding
    steps a run (an int8 code step on top of a bf16 one) allow top-2
    margins of up to 2 and below 3 ulps; one step, 1 and 2."""
    from repro_torch.testing import within_tie_rule

    assert within_tie_rule([0.0, 0.03125], 4.5) and not within_tie_rule([0.0, 0.0625], 4.0625)
    assert within_tie_rule([0.0, 0.0625], 4.0625, steps=2)
    assert not within_tie_rule([0.0, 0.09375], 4.0625, steps=2)
    assert not within_tie_rule([0.0625, 0.0625], 4.0625, steps=1)
