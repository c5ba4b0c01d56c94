"""Page visit orders of the port, and the host wavefront models the cache
models replay (``KVSchedule``, ``BwdKVSchedule``, ``step_page_visits``,
``Traversal.visit_order``), equal the JAX package's, exactly."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.core import schedule as ref
from repro_torch.core import schedule as port

PARITIES = [0, 1, 2, 3, 17, 64]
SNAKE_GROUPS = [None, 1, 2, 3, 5, 100]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("n_blocks", range(1, 10))
@pytest.mark.parametrize("order", [o.value for o in ref.Order])
def test_visit_orders_equal(order, n_blocks):
    parity = np.asarray(PARITIES, np.int32)
    for sg in SNAKE_GROUPS:
        group = port.resolve_order_group(order, sg, n_blocks)
        assert group == ref.resolve_order_group(order, sg, n_blocks)
        want = np.asarray(ref.page_visit_order(order, parity, n_blocks, snake_group=sg))
        got = port.page_visit_order(order, torch.as_tensor(parity), n_blocks, snake_group=sg)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32
        want_dyn = np.asarray(ref.page_visit_order_dynamic(parity, n_blocks, group))
        got_dyn = port.page_visit_order_dynamic(torch.as_tensor(parity), n_blocks, group)
        np.testing.assert_array_equal(got_dyn.numpy(), want_dyn)
        for p in PARITIES:
            row = [port._snake_pos_host(p, j, n_blocks, group) for j in range(n_blocks)]
            assert row == [ref._snake_pos_host(p, j, n_blocks, group) for j in range(n_blocks)]
            assert row == got_dyn[PARITIES.index(p)].tolist()


@pytest.mark.parametrize("group", [0, -3, 1, 4, 50])
def test_dynamic_group_clamped_like_reference(group):
    parity = np.arange(6, dtype=np.int32)
    want = np.asarray(ref.page_visit_order_dynamic(parity, 7, group))
    got = port.page_visit_order_dynamic(torch.as_tensor(parity), 7, group)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scalar_parity_and_order_parse():
    np.testing.assert_array_equal(
        port.page_visit_order("sawtooth", 1, 4).numpy(),
        np.asarray(ref.page_visit_order("sawtooth", 1, 4)),
    )
    assert port.Order.parse("SAWTOOTH") is port.Order.SAWTOOTH
    with pytest.raises(ValueError, match="valid orders"):
        port.Order.parse("zigzag")
    with pytest.raises(ValueError):
        port.resolve_order_group("block_snake", 0, 4)


# ---- the host wavefront models and the step-level page walk -------------------------

ORDERS = [o.value for o in ref.Order]
GEOMETRIES = [dict(causal=False, window=None), dict(causal=True, window=None),
              dict(causal=True, window=200), dict(causal=False, window=150)]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("sg", [None, 1, 3])
def test_traversal_visit_order_equal(order, sg):
    parity = np.asarray(PARITIES, np.int32)
    for n_kv in (1, 4, 9):
        rt = ref.Traversal(order, n_q=2, n_kv=n_kv, snake_group=sg)
        pt = port.Traversal(order, n_q=2, n_kv=n_kv, snake_group=sg)
        got = pt.visit_order(torch.as_tensor(parity))
        np.testing.assert_array_equal(got.numpy(), np.asarray(rt.visit_order(parity)))


@pytest.mark.parametrize("order", ORDERS)
def test_step_page_visits_equal(order):
    rows = [[7, 3, 9, 1, 4], [7, 3, 2], [], [11], [5, 6, 8, 12, 13, 14, 15]]
    for parities in ([0, 1, 2, 3, 4], [5, 5, 0, 9, 2]):
        for sg in (None, 2):
            got = list(port.step_page_visits(order, rows, parities, snake_group=sg))
            assert got == list(ref.step_page_visits(order, rows, parities, snake_group=sg))
    with pytest.raises(ValueError, match="parities"):
        list(port.step_page_visits(order, rows, [0]))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: f"c{int(g['causal'])}w{g['window']}")
def test_kv_schedule_equal(order, geo):
    kw = dict(n_q=7, n_kv=9, q_block=64, kv_block=64, snake_group=3, **geo)
    r, p = ref.KVSchedule(order, **kw), port.KVSchedule(order, **kw)
    assert p.order is port.Order(order)
    for q in range(7):
        assert p.kv_range(q) == r.kv_range(q)
        for li in (None, 0, 1, 5):
            assert p.kv_order(q, li) == r.kv_order(q, li)
    np.testing.assert_array_equal(p.page_order(torch.arange(6)).numpy(),
                                  np.asarray(r.page_order(np.arange(6))))
    for n in (1, 3, 16):
        assert p.worker_assignments(n) == r.worker_assignments(n)
        assert list(p.wavefront_trace(n)) == list(r.wavefront_trace(n))
        assert p.flat_trace(n) == r.flat_trace(n)
    for window in (None, 128):
        rb, pb = r.bwd(window=window), p.bwd(window=window)
        assert dataclasses.asdict(pb) == dataclasses.asdict(rb)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: f"c{int(g['causal'])}w{g['window']}")
def test_bwd_kv_schedule_equal(order, geo):
    kw = dict(q_block=64, kv_block=64, snake_group=3, **geo)
    for n_q, n_kv in ((8, 6), (1, 4), (5, 5)):
        r = ref.bwd_kv_schedule(order, n_q, n_kv, **kw)
        p = port.bwd_kv_schedule(order, n_q, n_kv, **kw)
        assert isinstance(p, port.BwdKVSchedule)
        for j in range(n_kv):
            assert p.q_bounds(j) == r.q_bounds(j)
            assert p.q_range(j) == r.q_range(j)
            for li in (None, 0, 3):
                assert p.q_order(j, li) == r.q_order(j, li)
        for n in (1, 2, 7):
            assert p.worker_assignments(n) == r.worker_assignments(n)
            assert list(p.wavefront_trace(n)) == list(r.wavefront_trace(n))
            assert p.flat_trace(n) == r.flat_trace(n)


def test_schedules_refuse_empty_grids():
    for cls in (port.KVSchedule, port.BwdKVSchedule):
        with pytest.raises(ValueError, match="empty schedule"):
            cls("cyclic", n_q=0, n_kv=3)
