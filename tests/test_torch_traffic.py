"""The port's traffic models (``repro_torch.kernels.traffic``) against the
JAX package's, and the port's models of its own kernels' walks.

* The reference's cases of ``tests/test_traversal.py`` that read the host
  schedules and the traffic models run through both packages.
* Every report of the pipeline replays and every ``SimResult`` of the LLC
  wavefront models equals the reference's (integers exactly, bytes in
  float64: the same Python additions in the same order).
* ``fwd_walk_trace``/``dkv_walk_trace`` play exactly the walks that
  ``fwd_walks``/``dkv_walks`` (what B2 and B6 record on the card) hold,
  and their LRU readings obey what any walk must: every order issues the
  same bytes and the same cold misses, a cache that holds everything
  misses only cold, a small one misses more.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import torch

from repro.core import cache_sim as ref_cs
from repro.core import schedule as ref_sch
from repro.kernels import traffic as ref_tr
from repro_torch.core import cache_sim as port_cs
from repro_torch.core import schedule as port_sch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import traffic as port_tr

ORDERS = ["cyclic", "sawtooth", "block_snake"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    if request.param == "reference":
        return ref_sch, ref_cs, ref_tr
    return port_sch, port_cs, port_tr


# ---- the reference's cases (tests/test_traversal.py), through both packages -------


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 200),
                                           (False, 150)])
def test_every_order_is_permutation_of_cyclic_per_q_tile(pkg, order, causal, window):
    sch, _, _ = pkg
    kw = dict(n_q=7, n_kv=9, causal=causal, window=window, q_block=64, kv_block=64)
    ref = sch.Traversal("cyclic", **kw)
    tr = sch.Traversal(order, snake_group=3, **kw)
    for q_tile in range(7):
        assert sorted(tr.kv_order(q_tile)) == ref.kv_order(q_tile), (order, q_tile)


@pytest.mark.parametrize("order", ORDERS)
def test_transposed_orders_are_permutations_too(pkg, order):
    sch, _, _ = pkg
    ref = sch.bwd_kv_schedule("cyclic", 8, 6, causal=True, window=256, q_block=64, kv_block=64)
    s = sch.bwd_kv_schedule(order, 8, 6, causal=True, window=256, q_block=64, kv_block=64,
                            snake_group=3)
    for kv_tile in range(6):
        assert sorted(s.q_order(kv_tile)) == ref.q_order(kv_tile)


def test_block_snake_degenerate_groups_and_windows(pkg):
    sch, _, _ = pkg
    n = 13
    for i in range(4):
        cyc = [sch.kv_index_host("cyclic", i, j, n) for j in range(n)]
        saw = [sch.kv_index_host("sawtooth", i, j, n) for j in range(n)]
        g1 = [sch.kv_index_host("block_snake", i, j, n, snake_group=1) for j in range(n)]
        gn = [sch.kv_index_host("block_snake", i, j, n, snake_group=n) for j in range(n)]
        assert g1 == cyc and gn == saw, i
    got = [sch.kv_index_host("block_snake", 1, j, 10, snake_group=4) for j in range(10)]
    assert got == [3, 2, 1, 0, 7, 6, 5, 4, 9, 8]
    tr = sch.Traversal("block_snake", n_q=2, n_kv=4 * sch.DEFAULT_SNAKE_GROUP,
                       q_block=64, kv_block=64)
    assert tr.kv_order(1)[0] == sch.DEFAULT_SNAKE_GROUP - 1


def test_schedule_wrappers_share_the_ir(pkg):
    sch, _, _ = pkg
    s = sch.KVSchedule("block_snake", n_q=5, n_kv=8, causal=True, q_block=64, kv_block=64,
                       snake_group=3)
    for q in range(5):
        assert s.kv_order(q) == s.traversal.kv_order(q)
    b = s.bwd(window=128)
    for kv in range(8):
        assert b.q_order(kv) == b.traversal.q_order(kv)


def _mean_reuse(sch, cs, order, snake_group=None, n=24):
    s = sch.KVSchedule(order, n_q=n, n_kv=n, causal=False, q_block=64, kv_block=64,
                       snake_group=snake_group)
    dists = cs.reuse_distances(s.flat_trace(n_workers=1))
    return sum(dists) / len(dists)


def test_mean_reuse_distance_monotone_cyclic_snake_sawtooth(pkg):
    sch, cs, _ = pkg
    cyc = _mean_reuse(sch, cs, "cyclic")
    snake = _mean_reuse(sch, cs, "block_snake", snake_group=8)
    saw = _mean_reuse(sch, cs, "sawtooth")
    assert cyc > snake > saw
    assert _mean_reuse(sch, cs, "block_snake", snake_group=1) == pytest.approx(cyc)
    assert _mean_reuse(sch, cs, "block_snake", snake_group=24) == pytest.approx(saw)
    assert snake > _mean_reuse(sch, cs, "block_snake", snake_group=16) > saw


def test_block_snake_beats_sawtooth_on_capacity_bound_llc(pkg):
    _, _, tr = pkg
    spec = tr.FlashGridSpec(seq_q=8192, seq_kv=8192, q_block=128, kv_block=128, causal=True)
    kw = dict(n_workers=12, capacity_frac=0.75)
    cyc = tr.fwd_llc_model(spec, "cyclic", **kw).non_compulsory_misses
    saw = tr.fwd_llc_model(spec, "sawtooth", **kw).non_compulsory_misses
    snk16 = tr.fwd_llc_model(spec, "block_snake", snake_group=16, **kw).non_compulsory_misses
    snk32 = tr.fwd_llc_model(spec, "block_snake", snake_group=32, **kw).non_compulsory_misses
    assert saw < cyc
    assert snk16 < saw
    assert snk32 < 0.5 * saw


def test_fwd_llc_model_accesses_order_invariant(pkg):
    _, _, tr = pkg
    spec = tr.FlashGridSpec(seq_q=4096, seq_kv=4096, q_block=128, kv_block=128, causal=True)
    res = [tr.fwd_llc_model(spec, o, snake_group=8, n_workers=8, capacity_frac=0.5)
           for o in ORDERS]
    assert len({r.accesses for r in res}) == 1
    assert len({r.cold_misses for r in res}) == 1


def test_bwd_dkv_traffic_block_snake_between_cyclic_and_sawtooth(pkg):
    _, _, tr = pkg
    spec = tr.FlashGridSpec(seq_q=4096, seq_kv=4096, q_block=256, kv_block=256)
    cyc = tr.bwd_dkv_traffic(spec, "cyclic")
    saw = tr.bwd_dkv_traffic(spec, "sawtooth")
    snk = tr.bwd_dkv_traffic(spec, "block_snake", snake_group=4)
    assert saw.stream_bytes <= snk.stream_bytes <= cyc.stream_bytes
    assert cyc.total_stream_fetches == snk.total_stream_fetches
    assert cyc.resident_bytes == snk.resident_bytes == saw.resident_bytes


@pytest.mark.parametrize("order", ORDERS)
def test_empty_q_range_on_transposed_grid(pkg, order):
    sch, _, tr = pkg
    spec = tr.FlashGridSpec(seq_q=128, seq_kv=512, q_block=128, kv_block=128, causal=True)
    assert tr.bwd_dkv_traffic(spec, order, snake_group=2).write_bytes > 0
    s = sch.bwd_kv_schedule(order, 1, 4, causal=True, q_block=128, kv_block=128, snake_group=2)
    trace = s.flat_trace(2)
    assert sorted(t for tt, t in trace if tt == "dK") == [0, 1, 2, 3]
    assert [t for tt, t in trace if tt == "Q"] == [0]


def test_kv_range_and_wavefront_coverage(pkg):
    sch, _, _ = pkg
    s = sch.KVSchedule("cyclic", n_q=8, n_kv=8, causal=True, window=256, q_block=128,
                       kv_block=128)
    for q in range(8):
        assert s.kv_range(q) == len(s.kv_order(q))
    s = sch.KVSchedule("block_snake", n_q=5, n_kv=6, causal=True, q_block=64, kv_block=64,
                       snake_group=2)
    touched, current = {}, {}
    for w, tensor, tile in s.wavefront_trace(n_workers=3):
        if tensor == "Q":
            current[w] = tile
            touched.setdefault(tile, [])
        elif tensor == "K":
            touched[current[w]].append(tile)
    for q_tile, kvs in touched.items():
        assert sorted(kvs) == list(range(s.kv_range(q_tile)))


# ---- the port equals the reference --------------------------------------------------

SPECS = [dict(seq_q=1024, seq_kv=1024, q_block=128, kv_block=128, causal=True),
         dict(seq_q=700, seq_kv=900, n_groups=3, head_dim=64, q_block=64, kv_block=128,
              causal=True, window=300),
         dict(seq_q=512, seq_kv=512, n_groups=2, q_block=128, kv_block=64)]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("kw", SPECS, ids=["causal", "gqa-swa", "gqa"])
def test_traffic_reports_and_llc_models_equal_reference(order, kw):
    rs, ps = ref_tr.FlashGridSpec(**kw), port_tr.FlashGridSpec(**kw)
    assert (ps.nq, ps.nkv) == (rs.nq, rs.nkv)
    assert dataclasses.asdict(ps.traversal(order, 3)) == {
        **dataclasses.asdict(rs.traversal(order, 3)), "order": port_sch.Order(order)}
    for fn in ("pipeline_traffic", "bwd_dq_traffic", "bwd_dkv_traffic"):
        a = getattr(port_tr, fn)(ps, order, snake_group=3)
        b = getattr(ref_tr, fn)(rs, order, snake_group=3)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), fn
        assert a.total_bytes == b.total_bytes
    for cap in (dict(capacity_frac=0.3), dict(capacity_bytes=200_000.0)):
        for fn, nw in (("fwd_llc_model", 5), ("bwd_dkv_llc_model", 3)):
            a = getattr(port_tr, fn)(ps, order, snake_group=3, n_workers=nw, **cap)
            b = getattr(ref_tr, fn)(rs, order, snake_group=3, n_workers=nw, **cap)
            assert dataclasses.asdict(a) == dataclasses.asdict(b), (fn, cap)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("shared", [True, False])
def test_shared_prefix_llc_model_equals_reference(order, shared):
    for cap in (dict(), dict(capacity_bytes=300_000.0)):
        kw = dict(n_rows=4, prefix_pages=3, own_tokens=20, n_steps=6, page=16, n_kv_heads=2,
                  head_dim=64, shared=shared, snake_group=2, **cap)
        a = port_tr.shared_prefix_llc_model(order, **kw)
        b = ref_tr.shared_prefix_llc_model(order, **kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ---- the port's kernels: their walks through the LRU --------------------------------

WALK_CASES = [
    # (sq, skv, n_groups, causal, window, n_slices, n_workers)
    (700, 700, 1, True, None, 3, 5),
    (300, 520, 4, True, 200, 2, 7),
    (256, 384, 2, False, None, 2, 3),
]


def _fwd_tr(order, sq, skv, g, causal, window):
    return fa.kernel_traversal(sq, skv, g, kernel="flash_fwd", order=order, causal=causal,
                               window=window, snake_group=2)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", WALK_CASES, ids=["causal", "gqa-swa", "gqa"])
def test_fwd_walk_trace_plays_the_recorded_walks(order, case):
    """Many CTAs in lock step: every row enters once, with its valid bytes;
    each K read is followed by the same tile's V read; the K reads of a
    slice are, tile for tile, those of its recorded walks; and the first
    global step enters each CTA's first item in CTA order."""
    sq, skv, g, causal, window, n_slices, n_workers = case
    tr = _fwd_tr(order, sq, skv, g, causal, window)
    d = 64
    trace = list(port_tr.fwd_walk_trace(tr, n_slices, n_workers, head_dim=d, seq_q=sq,
                                        seq_kv=skv))
    walks = fa.fwd_walks(tr, n_slices, n_workers)
    entered, k_reads = [], {s: [] for s in range(n_slices)}
    for (key, nbytes), (nxt, _) in zip(trace, trace[1:] + [((None,), 0)]):
        if key[0] == "Q":
            entered.append(key[1:])
            assert nbytes == min(tr.q_block, sq - (key[2] % tr.n_q) * tr.q_block) * d * 2
        else:
            assert key[0] in ("K", "V")
            assert nbytes == min(tr.kv_block, skv - key[2] * tr.kv_block) * d * 2
            if key[0] == "K":
                assert nxt == ("V", *key[1:])
                k_reads[key[1]].append(key[2])
    assert sorted(entered) == [(s, i) for s in range(n_slices) for i in range(tr.grid_rows)]
    for s in range(n_slices):
        assert sorted(k_reads[s]) == sorted(j for row in walks[s] for j in row if j >= 0)
    firsts = [items[0] for items in fa.fwd_schedule(tr, n_slices, n_workers) if items]
    assert [e for e in entered[: len(firsts)]] == firsts


def test_fwd_walk_trace_one_worker_is_each_walk_in_turn():
    """With one CTA the lock step is the plain sequence of its items, so
    the K reads are exactly ``fwd_walks`` in ``fwd_schedule`` order."""
    tr = _fwd_tr("sawtooth", 700, 700, 2, True, None)
    trace = [k for k, _ in port_tr.fwd_walk_trace(tr, 2, 1, head_dim=128)]
    (items,) = fa.fwd_schedule(tr, 2, 1)
    walks = fa.fwd_walks(tr, 2, 1)
    want = []
    for s, i in items:
        want.append(("Q", s, i))
        for j in walks[s][i]:
            if j >= 0:
                want += [("K", s, j), ("V", s, j)]
    assert trace == want


def test_dkv_walk_trace_one_worker_is_each_walk_in_turn():
    tr = fa.kernel_traversal(300, 300, 2, kernel="flash_bwd_dkv", order="sawtooth",
                             causal=True, window=None)
    trace = [k for k, _ in port_tr.dkv_walk_trace(tr, 2, 1, head_dim=64)]
    (items,) = fa.dkv_schedule(tr, 2, 1)
    walks = fa.dkv_walks(tr, 2, 1)
    want = []
    for s, j in items:
        want += [("K", s, j), ("V", s, j)]
        for f in walks[s][j]:
            if f >= 0:
                g, qi = divmod(f, tr.n_q)
                want += [("Q", s, g, qi), ("dO", s, g, qi), ("LD", s, g, qi)]
    assert trace == want


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dkv"])
@pytest.mark.parametrize("case", WALK_CASES, ids=["causal", "gqa-swa", "gqa"])
def test_walk_models_cold_bytes_and_capacity(kernel, case):
    sq, skv, g, causal, window, n_slices, n_workers = case
    d = 64
    model = port_tr.fwd_walk_llc_model if kernel == "flash_fwd" else port_tr.dkv_walk_llc_model
    trace_fn = port_tr.fwd_walk_trace if kernel == "flash_fwd" else port_tr.dkv_walk_trace
    readings = {}
    for order in ORDERS:
        tr = fa.kernel_traversal(sq, skv, g, kernel=kernel, order=order, causal=causal,
                                 window=window, snake_group=2)
        kw = dict(head_dim=d, seq_q=sq, seq_kv=skv)
        trace = list(trace_fn(tr, n_slices, n_workers, **kw))
        distinct = {}
        for key, nbytes in trace:
            distinct[key] = nbytes
        total = sum(distinct.values())
        big, small = model(tr, n_slices, n_workers, capacities=[float(total), total / 8], **kw)
        assert big.misses == big.cold_misses == total
        assert big.accesses == small.accesses == sum(b for _, b in trace)
        assert small.cold_misses == total and small.misses > total
        readings[order] = (big.accesses, big.cold_misses)
    assert len(set(readings.values())) == 1
