"""The host models of the persistent flash backward's schedules (the dK/dV
kernel's work items, their assignment to CTAs and each item's Q/dO stream;
the dQ kernel's, which are the forward's) against the JAX package's
Traversal.

* Every (slice, KV tile) item goes to exactly one worker, in the dK/dV
  kernel's balanced order and in the plain grid-stride order of the
  paper's Alg. 2 (built here from the reference's ``worker_assignments``).
* The k-th item of a worker streams the reference's
  ``Traversal.stream_sweep(kv_tile, local_iter=k)``: the parity key is the
  worker-local pass counter (paper Alg. 4, ``BwdKVSchedule``).
* With one slice and the plain grid-stride order, each worker's Q and dO
  streams under that rule equal those of the reference's
  ``Traversal.wavefront(n_workers, transposed=True)`` exactly, for every
  order x causal/SWA x GQA.
* The balanced order gives every worker the same causal cost to within one
  unit.
* The dQ kernel's walks are ``fwd_walks`` at its own tiles: the k-th item
  of a worker walks the reference's ``kv_order(q_tile, local_iter=k)``.

No GPU: the kernels' recorded walks are held to these models on the card
by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import pytest

pytest.importorskip("torch")

from repro.core import schedule as ref_sched
from repro_torch.kernels.flash_attention import (
    DKV_BLOCK_M,
    DKV_BLOCK_N,
    DQ_BLOCK_M,
    DQ_BLOCK_N,
    dkv_schedule,
    dkv_walks,
    fwd_schedule,
    fwd_walks,
    kernel_traversal,
)

ORDERS = ["cyclic", "sawtooth", "block_snake"]
MASKS = [(False, None), (True, None), (True, 200), (False, 300)]
# (Sq, Skv): square, odd tile counts, Sq > Skv, Sq < Skv (KV tiles nobody
# sees when causal), one tile.
LENGTHS = [(1024, 1024), (700, 700), (600, 200), (200, 600), (100, 100)]


def _traversals(kernel, order, causal, window, g, sq, skv, sg=2):
    kw = dict(order=order, causal=causal, window=window, snake_group=sg)
    tr = kernel_traversal(sq, skv, g, kernel=kernel, **kw)
    ref = ref_sched.Traversal(n_q=tr.n_q, n_kv=tr.n_kv, n_groups=g, q_block=tr.q_block,
                              kv_block=tr.kv_block, **kw)
    return tr, ref


def _grid_stride(tr, n_slices, n_workers):
    """The plain grid-stride order of the paper's Alg. 2 on the transposed
    grid: item u (slice-major, KV tiles in index order) to worker u %
    n_workers."""
    items = [(s, j) for s in range(n_slices) for j in range(tr.n_kv)]
    return [items[w::n_workers] for w in range(n_workers)]


def test_kernel_tiles():
    tr = kernel_traversal(1024, 1024, 4, order="sawtooth", causal=True, window=None,
                          kernel="flash_bwd_dkv")
    assert (tr.q_block, tr.kv_block, tr.n_q, tr.n_kv) == (DKV_BLOCK_M, DKV_BLOCK_N, 16, 8)
    tr = kernel_traversal(1024, 1024, 4, order="sawtooth", causal=True, window=None,
                          kernel="flash_bwd_dq")
    assert (tr.q_block, tr.kv_block, tr.n_q, tr.n_kv) == (DQ_BLOCK_M, DQ_BLOCK_N,
                                                          1024 // DQ_BLOCK_M, 1024 // DQ_BLOCK_N)
    with pytest.raises(ValueError):
        dkv_schedule(tr, 1, 0)


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("n_slices,n_workers", [(1, 1), (1, 3), (5, 4), (8, 132), (3, 7)])
@pytest.mark.parametrize("sq", [1024, 700, 100])
def test_every_item_goes_to_one_worker(balanced, n_slices, n_workers, sq):
    tr = kernel_traversal(sq, sq, 4, order="sawtooth", causal=True, window=None,
                          kernel="flash_bwd_dkv")
    sched = (dkv_schedule if balanced else _grid_stride)(tr, n_slices, n_workers)
    assert len(sched) == n_workers
    items = [item for worker in sched for item in worker]
    assert sorted(items) == [(s, j) for s in range(n_slices) for j in range(tr.n_kv)]
    if balanced:  # each unit's heavy tile first, a slice's units in order
        for worker in sched:
            assert [s for s, _ in worker] == sorted(s for s, _ in worker)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("sq,skv", [(700, 700), (200, 600)])
def test_walks_are_stream_sweep_with_the_worker_local_pass(order, causal, window, g, sq, skv):
    """The dK/dV kernel's balanced schedule, walk by walk, against the
    reference's ``stream_sweep`` at the worker-local pass; every (group, Q
    tile) that sees a KV tile is streamed once."""
    tr, ref = _traversals("flash_bwd_dkv", order, causal, window, g, sq, skv)
    n_slices, n_workers = 3, 5
    walks = dkv_walks(tr, n_slices, n_workers)
    for items in dkv_schedule(tr, n_slices, n_workers):
        for k, (s, j) in enumerate(items):
            want = [grp * ref.n_q + qi for grp, qi in ref.stream_sweep(j, local_iter=k)]
            assert walks[s][j] == want + [-1] * (ref.grid_rows - len(want))
            lo, hi = ref.q_bounds_host(j)
            assert sorted(want) == [grp * ref.n_q + qi for grp in range(g)
                                    for qi in range(lo, hi + 1)]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("sq,skv", LENGTHS)
@pytest.mark.parametrize("n_workers", [1, 3, 4])
def test_grid_stride_streams_equal_the_reference_wavefront(order, causal, window, g, sq, skv,
                                                           n_workers):
    tr, ref = _traversals("flash_bwd_dkv", order, causal, window, g, sq, skv)
    trace = list(ref.wavefront(n_workers, transposed=True))
    sched = _grid_stride(tr, 1, n_workers)
    assert [[j for _, j in items] for items in sched] == ref.worker_assignments(
        n_workers, transposed=True)
    for w, items in enumerate(sched):
        stream = [t for k, (_, j) in enumerate(items) for t in tr.stream_sweep(j, local_iter=k)]
        for name in ("Q", "dO"):
            assert stream == [key for ww, tensor, key in trace if ww == w and tensor == name]
        for name in ("K", "V", "dK", "dV"):
            assert [j for _, j in items] == [key for ww, tensor, key in trace
                                             if ww == w and tensor == name]


def _cost(tr, items):
    return sum(len(tr.stream_sweep(j)) for _, j in items)


@pytest.mark.parametrize("sq,n_slices,g", [(1024, 128, 1), (1024, 32, 4), (700, 256, 1),
                                           (700, 5, 4)])
def test_balanced_order_evens_out_the_causal_cost(sq, n_slices, g):
    """Under causal trimming at 64 x 128 tiles, KV tile j streams G (n_q -
    2 j) tiles, so a unit of the heavy tile p and the light tile n_kv - 1 -
    p costs G (2 n_q - 2 n_kv + 2) whatever p: every worker's cost is within
    one unit of every other's. With more items than workers the plain
    grid-stride order is not even (the training shape: KV tiles {0, 4}
    against {3, 7} a worker)."""
    tr = kernel_traversal(sq, sq, g, order="sawtooth", causal=True, window=None,
                          kernel="flash_bwd_dkv")
    unit = max(_cost(tr, items) for items in dkv_schedule(tr, 1, -(-tr.n_kv // 2)))
    costs = [_cost(tr, items) for items in dkv_schedule(tr, n_slices, 132)]
    assert max(costs) - min(costs) <= unit
    plain = [_cost(tr, items) for items in _grid_stride(tr, n_slices, 132)]
    if n_slices * tr.n_kv >= 2 * 132:
        assert max(costs) <= max(plain)
    if sq == 1024 and g == 1:
        assert max(plain) >= 2 * min(p for p in plain if p)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("g", [1, 4])
def test_dq_walks_are_kv_order_with_the_worker_local_pass(order, causal, window, g):
    """The dQ kernel takes the forward's schedule at its own tiles: the
    k-th item of a worker walks the reference's ``kv_order(q_tile,
    local_iter=k)``."""
    tr, ref = _traversals("flash_bwd_dq", order, causal, window, g, 700, 600)
    n_slices, n_workers = 3, 5
    walks = fwd_walks(tr, n_slices, n_workers)
    for items in fwd_schedule(tr, n_slices, n_workers):
        for k, (s, i) in enumerate(items):
            want = ref.kv_order(i % ref.n_q, local_iter=k)
            assert walks[s][i] == want + [-1] * (ref.n_kv - len(want))
