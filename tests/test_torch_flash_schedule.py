"""The host model of the persistent flash forward's schedule (the CUDA
kernel's work items, their assignment to CTAs and each item's KV walk)
against the JAX package's Traversal.

* Every (slice, folded row) item goes to exactly one worker, in the
  kernel's balanced order and in the plain grid-stride order of the
  paper's Alg. 2 (built here from the reference's
  ``worker_assignments``).
* The k-th item of a worker walks the reference's ``Traversal.kv_order(
  q_tile, local_iter=k)``: the parity key is the worker-local pass counter
  (paper Alg. 4).
* With one slice and the plain grid-stride order, each worker's K and V
  streams under that rule equal those of the reference's
  ``Traversal.wavefront(n_workers)`` (paper Alg. 2/4) exactly, for every
  order x causal/SWA x GQA.
* The balanced order gives every worker the same causal cost to within
  one unit.

No GPU: the kernel's recorded walk is held to this model on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import pytest

pytest.importorskip("torch")

from repro.core import schedule as ref_sched
from repro_torch.kernels.flash_attention import (
    FWD_BLOCK_M,
    FWD_BLOCK_N,
    fwd_schedule,
    fwd_walks,
    kernel_traversal,
)

ORDERS = ["cyclic", "sawtooth", "block_snake"]
MASKS = [(False, None), (True, None), (True, 200), (False, 300)]
# (Sq, Skv): square, odd tile counts, Sq > Skv (degenerate SWA trims), one tile.
LENGTHS = [(1024, 1024), (700, 700), (600, 200), (100, 100)]


def _traversals(order, causal, window, g, sq, skv, sg=2):
    kw = dict(order=order, causal=causal, window=window, q_block=FWD_BLOCK_M,
              kv_block=FWD_BLOCK_N, snake_group=sg)
    tr = kernel_traversal(sq, skv, g, kernel="flash_fwd", order=order, causal=causal,
                          window=window, snake_group=sg)
    ref = ref_sched.Traversal(n_q=tr.n_q, n_kv=tr.n_kv, n_groups=g, **kw)
    return tr, ref


def _grid_stride(tr, n_slices, n_workers):
    """The plain grid-stride order of the paper's Alg. 2: item u
    (slice-major, folded rows in index order) to worker u % n_workers."""
    items = [(s, i) for s in range(n_slices) for i in range(tr.grid_rows)]
    return [items[w::n_workers] for w in range(n_workers)]


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("n_slices,n_workers", [(1, 1), (1, 3), (5, 4), (8, 132), (3, 7)])
@pytest.mark.parametrize("g", [1, 4])
def test_every_item_goes_to_one_worker(balanced, n_slices, n_workers, g):
    tr = kernel_traversal(700, 700, g, kernel="flash_fwd", order="sawtooth", causal=True,
                          window=None)
    sched = (fwd_schedule if balanced else _grid_stride)(tr, n_slices, n_workers)
    assert len(sched) == n_workers
    items = [item for worker in sched for item in worker]
    assert sorted(items) == [(s, i) for s in range(n_slices) for i in range(tr.grid_rows)]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("g", [1, 4])
def test_walks_are_kv_order_with_the_worker_local_pass(order, causal, window, g):
    """The kernel's balanced schedule, walk by walk, against the
    reference's ``kv_order`` at the worker-local pass."""
    tr, ref = _traversals(order, causal, window, g, 700, 700)
    n_slices, n_workers = 3, 5
    walks = fwd_walks(tr, n_slices, n_workers)
    for items in fwd_schedule(tr, n_slices, n_workers):
        for k, (s, i) in enumerate(items):
            want = ref.kv_order(i % ref.n_q, local_iter=k)
            assert walks[s][i] == want + [-1] * (ref.n_kv - len(want))
            lo, hi = ref.kv_bounds_host(i % ref.n_q)
            assert sorted(want) == list(range(lo, hi + 1))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("sq,skv", LENGTHS)
@pytest.mark.parametrize("n_workers", [1, 3, 4])
def test_grid_stride_streams_equal_the_reference_wavefront(order, causal, window, g, sq, skv,
                                                           n_workers):
    tr, ref = _traversals(order, causal, window, g, sq, skv)
    trace = list(ref.wavefront(n_workers))
    sched = _grid_stride(tr, 1, n_workers)
    assert [[i for _, i in items] for items in sched] == ref.worker_assignments(n_workers)
    for w, items in enumerate(sched):
        stream = [t for k, (_, i) in enumerate(items) for t in tr.kv_order(i % tr.n_q,
                                                                          local_iter=k)]
        for name in ("K", "V"):
            assert stream == [key for ww, tensor, key in trace if ww == w and tensor == name]
        assert [i for _, i in items] == [key for ww, tensor, key in trace
                                         if ww == w and tensor == "Q"]


def _cost(tr, items):
    return sum(len(tr.kv_order(i % tr.n_q)) for _, i in items)


@pytest.mark.parametrize("sq,n_slices", [(1024, 128), (700, 256), (700, 5)])
def test_balanced_order_evens_out_the_causal_cost(sq, n_slices):
    """Units of a heavy and a light Q tile cost n_q + 1 tiles each (square
    tiles, causal), so every worker's cost is within one unit of every
    other's; with more items than workers the plain grid-stride order is
    not (the training shape: Q tiles {0, 4} against {3, 7} a worker)."""
    tr = kernel_traversal(sq, sq, 1, kernel="flash_fwd", order="sawtooth", causal=True,
                          window=None)
    unit = tr.n_q + 1 if tr.n_q % 2 == 0 else tr.n_q
    costs = [_cost(tr, items) for items in fwd_schedule(tr, n_slices, 132)]
    assert max(costs) - min(costs) <= unit
    plain = [_cost(tr, items) for items in _grid_stride(tr, n_slices, 132)]
    if n_slices * tr.n_q >= 2 * 132:
        assert max(costs) <= max(plain)
    if sq == 1024:
        assert max(plain) >= 2 * min(p for p in plain if p)
