"""The port's paged KV pool and continuous scheduler in lock step with the
JAX package's, over the same random operation sequences.

Every host-side field must be identical after every operation: block
tables, lengths, refcounts, free list, reservations, the prefix registry,
the adoption and copy-on-write counters, and the scheduler's plans, queue,
slots and suspended set. The device side is checked too: each walk writes the same values
into both pools through their block tables, so after copy-on-write forks the
page contents must still be equal.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as ref_get_config
from repro.serve import kv_pool as ref_pool
from repro.serve import scheduler as ref_sched
from repro_torch.configs import get_config
from repro_torch.obs import Registry
from repro_torch.serve import kv_pool as port_pool
from repro_torch.serve import scheduler as port_sched

SETTINGS = settings(max_examples=15, deadline=None)
PAGE, MAX_LEN, N_SLOTS = 4, 32, 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pools(**kw):
    jcfg = ref_get_config("deepseek-7b").reduced().with_(kv_layout="paged", page_size=PAGE)
    cfg = get_config("deepseek-7b").reduced().with_(kv_layout="paged", page_size=PAGE)
    ref = ref_pool.PagedKVPool(jcfg, jcfg.n_layers, N_SLOTS, MAX_LEN, **kw)
    port = port_pool.PagedKVPool(cfg, cfg.n_layers, N_SLOTS, MAX_LEN, device="cpu", **kw)
    return ref, port


def _assert_same_host_state(ref, port):
    np.testing.assert_array_equal(port.block_tables, ref.block_tables)
    np.testing.assert_array_equal(port.lens, ref.lens)
    np.testing.assert_array_equal(port._written, ref._written)
    np.testing.assert_array_equal(port._ref, ref._ref)
    assert port._slot_pages == ref._slot_pages
    assert port._slot_reserved == ref._slot_reserved
    assert port.alloc._free == ref.alloc._free
    assert port.alloc.reserved == ref.alloc.reserved
    assert port._page_parent == ref._page_parent
    assert port._chain_next.keys() == ref._chain_next.keys()
    for h, (pid, toks) in ref._chain_next.items():
        assert port._chain_next[h][0] == pid
        np.testing.assert_array_equal(port._chain_next[h][1], toks)
    assert (port.shared_hits, port.shared_tokens, port.cow_forks) == (
        ref.shared_hits, ref.shared_tokens, ref.cow_forks)
    assert port.occupancy() == ref.occupancy()
    ref.check_invariants()
    port.check_invariants()


def _write(ref, port, slot, n, value):
    """Write ``n`` positions from the slot's len in both pools (every layer,
    K and V), the way the mixed step does through the block table."""
    pos = int(port.lens[slot]) + np.arange(n)
    pids = port.block_tables[slot, pos // PAGE]
    offs = pos % PAGE
    vals = value + np.arange(n, dtype=np.float32)
    for name in ("k_pages", "v_pages"):
        port.pages[name][:, pids, offs] = torch.from_numpy(vals)[None, :, None, None]
        ref.pages[name] = ref.pages[name].at[:, pids, offs].set(
            jnp.asarray(vals)[None, :, None, None])


@SETTINGS
@given(seed=st.integers(0, 2**16))
def test_pool_lock_step_random_walk(seed):
    """Random admissions (prompts from a tiny alphabet, so prefixes match and
    pages fork constantly), chunked progress with prompt registration, and
    releases."""
    rng = np.random.default_rng(seed)
    ref, port = _pools()
    state: dict[int, dict] = {}
    for step in range(50):
        op = rng.integers(0, 3)
        if op == 0:
            free = [s for s in range(N_SLOTS) if s not in state]
            if not free:
                continue
            slot = int(rng.choice(free))
            prompt = rng.integers(2, 5, size=int(rng.integers(1, 28))).astype(np.int32)
            max_new = int(rng.integers(1, 8))
            got = port.admit(slot, prompt, max_new)
            assert got == ref.admit(slot, prompt, max_new)
            if got is not None:
                total = min(len(prompt) + max_new, port.capacity)
                state[slot] = {"prompt": prompt, "left": total - 1 - got, "registered": False}
        elif op == 1:
            busy = [s for s in state if state[s]["left"] > 0]
            if not busy:
                continue
            slot = int(rng.choice(busy))
            n = int(rng.integers(1, min(state[slot]["left"], 6) + 1))
            ref.ensure_writable(slot, n)
            port.ensure_writable(slot, n)
            _write(ref, port, slot, n, float(100 * step))
            ref.advance(slot, n)
            port.advance(slot, n)
            state[slot]["left"] -= n
            s = state[slot]
            if not s["registered"] and port.lens[slot] >= len(s["prompt"]):
                ref.register_prompt(slot, s["prompt"])
                port.register_prompt(slot, s["prompt"])
                s["registered"] = True
        else:
            if not state:
                continue
            slot = int(rng.choice(list(state)))
            ref.release(slot)
            port.release(slot)
            del state[slot]
        _assert_same_host_state(ref, port)
        if op == 1 or step % 10 == 0:
            assert port.match_prefix(state.get(0, {"prompt": np.zeros(0, np.int32)})["prompt"]) \
                == ref.match_prefix(state.get(0, {"prompt": np.zeros(0, np.int32)})["prompt"])
    for name in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(port.pages[name].numpy(), np.asarray(ref.pages[name]))
    for slot in list(state):
        ref.release(slot)
        port.release(slot)
    _assert_same_host_state(ref, port)
    assert port.alloc.free_count == port.alloc.n_pages - 1 and port.alloc.reserved == 0


def test_pool_geometry_and_gauges_match():
    from repro.obs import Registry as RefRegistry

    jcfg = ref_get_config("deepseek-7b").reduced().with_(kv_layout="paged", page_size=PAGE)
    cfg = get_config("deepseek-7b").reduced().with_(kv_layout="paged", page_size=PAGE)
    rr, pr = RefRegistry(), Registry()
    ref = ref_pool.PagedKVPool(jcfg, jcfg.n_layers, N_SLOTS, MAX_LEN, registry=rr, n_pages=20)
    port = port_pool.PagedKVPool(cfg, cfg.n_layers, N_SLOTS, MAX_LEN, device="cpu",
                                 registry=pr, n_pages=20)
    assert (port.page, port.blocks_per_seq, port.capacity) == (
        ref.page, ref.blocks_per_seq, ref.capacity)
    assert tuple(port.pages["k_pages"].shape) == ref.pages["k_pages"].shape
    prompt = np.arange(2, 12, dtype=np.int32)
    for pool in (ref, port):
        pool.admit(0, prompt, 4)
        pool.ensure_writable(0, 10)
        pool.advance(0, 10)
        pool.register_prompt(0, prompt)
        assert pool.admit(1, prompt[:7], 4) == 6   # a full page + a partial one
        pool.ensure_writable(1, 1)                 # forks the shared tail page
        pool.emit_gauges()
    _assert_same_host_state(ref, port)
    assert port.cow_forks == 1
    assert pr.snapshot() == rr.snapshot()
    with pytest.raises(port_pool.AdmissionError):
        port.admit(0, prompt, 1)


# ---- scheduler ------------------------------------------------------------------


@dataclasses.dataclass
class _Req:
    rid: int
    arrival: int


def _assert_same_sched(ref, port):
    assert [r.rid for r in port.waiting] == [r.rid for r in ref.waiting]
    assert port._rr == ref._rr and port.token_budget == ref.token_budget
    for a, b in zip(port.slots, ref.slots):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.request.rid, a.new_limit, a.prompt_pos, a.generated, a.done) == (
                b.request.rid, b.new_limit, b.prompt_pos, b.generated, b.done)
            np.testing.assert_array_equal(a.prompt, b.prompt)


@SETTINGS
@given(seed=st.integers(0, 2**16))
def test_scheduler_lock_step_random_walk(seed):
    rng = np.random.default_rng(seed)
    n_slots = int(rng.integers(1, 5))
    budget = int(rng.integers(1, 24)) if rng.random() < 0.7 else None
    chunk = int(rng.integers(1, 9))
    ref = ref_sched.ContinuousScheduler(n_slots, token_budget=budget, prefill_chunk=chunk)
    port = port_sched.ContinuousScheduler(n_slots, token_budget=budget, prefill_chunk=chunk)
    next_rid, step = 0, 0
    for _ in range(60):
        op = rng.integers(0, 7)
        if op == 0:
            reqs = [_Req(next_rid + i, int(rng.integers(0, step + 4))) for i in range(3)]
            next_rid += 3
            ref.submit(reqs)
            port.submit(reqs)
        elif op == 1:
            slot = port.free_slot()
            assert slot == ref.free_slot()
            req = port.pop_admissible(step)
            assert req is ref.pop_admissible(step)
            if slot is not None and req is not None:
                if rng.random() < 0.2:
                    ref.requeue(req)
                    port.requeue(req)
                else:
                    plen = int(rng.integers(1, 20))
                    kw = dict(eos_id=1, new_limit=int(rng.integers(1, 6)),
                              prompt=np.arange(plen, dtype=np.int32),
                              prompt_pos=int(rng.integers(0, plen)))
                    ref.place(slot, req, **kw)
                    port.place(slot, req, **kw)
        elif op in (2, 3):
            plan = port.plan_step()
            assert [(it.slot, it.q_len, it.is_prefill, it.finishes_prompt) for it in plan] == [
                (it.slot, it.q_len, it.is_prefill, it.finishes_prompt) for it in ref.plan_step()]
            for it in plan:
                tok = int(rng.integers(0, 3))   # 1 is the eos
                for s in (ref.slots[it.slot], port.slots[it.slot]):
                    if it.is_prefill:
                        s.prompt_pos += it.q_len
                        if not it.finishes_prompt:
                            continue
                    s.record(tok)
            for i in port.active_slots():
                if port.slots[i].done:
                    assert ref.retire(i).request is port.retire(i).request
            step += 1
        elif op == 4:
            max_q = int(rng.integers(0, 4))
            assert [r.rid for r in port.shed_over(step, max_q)] == \
                [r.rid for r in ref.shed_over(step, max_q)]
        elif op == 5:
            pred = lambda r: r.rid % 4 == 1
            assert [r.rid for r in port.drain_waiting(pred)] == \
                [r.rid for r in ref.drain_waiting(pred)]
        elif port.active_slots():
            # Suspend an active slot or resume a suspended one: suspended
            # slots stay placed but leave the plans.
            slot = int(rng.choice(port.active_slots()))
            for sched in (ref, port):
                (sched.resume if slot in sched.suspended else sched.suspend)(slot)
        assert port.suspended == ref.suspended
        assert port.runnable_slots() == ref.runnable_slots()
        assert port.has_work() == ref.has_work()
        assert port.active_slots() == ref.active_slots()
        assert port.next_arrival() == ref.next_arrival()
        _assert_same_sched(ref, port)
