"""Page visit orders of the port equal the JAX package's, exactly."""

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
