"""The port's LRU cache simulator (``repro_torch.core.cache_sim``) against
the JAX package's: the reference's cases of ``tests/test_cache_sim.py``
run through both packages, and every count, trace and statistic of the
port equal to the reference's exactly (integers, keys and orders) or in
float64 (the simulator adds Python floats in the same order)."""

import dataclasses

import pytest

pytest.importorskip("torch")

import torch

from repro.core import cache_model as ref_cm
from repro.core import cache_sim as ref_cs
from repro_torch.core import cache_model as port_cm
from repro_torch.core import cache_sim as port_cs

ORDERS = ["cyclic", "sawtooth", "block_snake"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    return (ref_cm, ref_cs) if request.param == "reference" else (port_cm, port_cs)


def _scaled(cm, cache_mb):
    return dataclasses.replace(cm.GB10, cache_bytes=int(cache_mb * 2**20))


def test_lru_basics(pkg):
    _, cs = pkg
    r = cs.SimResult()
    c = cs.LRUCache(2)
    assert not c.access(("a",), 1, r)
    assert not c.access(("b",), 1, r)
    assert c.access(("a",), 1, r)
    assert not c.access(("c",), 1, r)
    assert not c.access(("b",), 1, r)
    assert r.accesses == 5 and r.misses == 4 and r.cold_misses == 3
    assert not c.access(("big",), 3, r)       # larger than the cache: bypass
    assert c.access(("b",), 1, r)


def test_trace_access_count_matches_model(pkg):
    cm, cs = pkg
    w = cm.AttentionWorkload(seq_len=4096, tile=64)
    r = cs.simulate_attention(w, cm.GB10, "cyclic", n_workers=8)
    assert r.accesses == pytest.approx(cm.l2_sector_accesses(w, cm.GB10), rel=1e-6)


def test_fits_in_cache_only_cold_misses(pkg):
    cm, cs = pkg
    w = cm.AttentionWorkload(seq_len=8192, tile=64)
    for order in ("cyclic", "sawtooth"):
        r = cs.simulate_attention(w, cm.GB10, order, n_workers=48)
        assert r.non_compulsory_misses == 0
        assert r.cold_misses == pytest.approx(cm.cold_miss_sectors(w, cm.GB10), rel=1e-6)


def test_hit_rate_law_1_minus_1_over_n(pkg):
    cm, cs = pkg
    hw = _scaled(cm, 2)
    w = cm.AttentionWorkload(seq_len=16384, tile=64)
    for n in (1, 2, 4, 8, 16):
        r = cs.simulate_attention(w, hw, "cyclic", n_workers=n)
        assert abs(r.hit_rate - (1 - 1 / n)) < 0.05, (n, r.hit_rate)


def test_divergence_when_kv_exceeds_cache(pkg):
    cm, cs = pkg
    hw = _scaled(cm, 2)
    small = cm.AttentionWorkload(seq_len=4096, tile=64)
    big = cm.AttentionWorkload(seq_len=16384, tile=64)
    assert cs.simulate_attention(small, hw, "cyclic").non_compulsory_misses == 0
    assert cs.simulate_attention(big, hw, "cyclic").non_compulsory_misses > 0


def test_sawtooth_halves_noncompulsory_misses(pkg):
    cm, cs = pkg
    hw = _scaled(cm, 3)
    w = cm.AttentionWorkload(seq_len=16384, tile=64)
    cyc = cs.simulate_attention(w, hw, "cyclic", n_workers=48)
    saw = cs.simulate_attention(w, hw, "sawtooth", n_workers=48)
    assert 1 - saw.non_compulsory_misses / cyc.non_compulsory_misses > 0.45


def test_sawtooth_never_worse_lru(pkg):
    cm, cs = pkg
    for cache_mb in (0.5, 1, 2, 3, 8):
        hw = _scaled(cm, cache_mb)
        w = cm.AttentionWorkload(seq_len=8192, tile=64)
        cyc = cs.simulate_attention(w, hw, "cyclic", n_workers=16)
        saw = cs.simulate_attention(w, hw, "sawtooth", n_workers=16)
        assert saw.non_compulsory_misses <= cyc.non_compulsory_misses + 1e-9


def test_causal_sawtooth_still_helps(pkg):
    cm, cs = pkg
    hw = _scaled(cm, 2)
    w = cm.AttentionWorkload(seq_len=16384, tile=64, causal=True)
    cyc = cs.simulate_attention(w, hw, "cyclic", n_workers=48)
    saw = cs.simulate_attention(w, hw, "sawtooth", n_workers=48)
    assert saw.non_compulsory_misses < cyc.non_compulsory_misses


def test_reuse_distances_stack_semantics(pkg):
    _, cs = pkg
    trace = [("a",), ("b",), ("a",), ("a",), ("c",), ("b",)]
    assert cs.reuse_distances(trace) == [1, 0, 2]


def test_paged_decode_sawtooth_lowers_mean_reuse_distance(pkg):
    _, cs = pkg
    for lens in ([64], [48, 120, 16]):
        cyc = cs.simulate_paged_decode("cyclic", lens, n_steps=32, page=16)
        saw = cs.simulate_paged_decode("sawtooth", lens, n_steps=32, page=16)
        assert saw["mean_reuse_distance"] < cyc["mean_reuse_distance"]
        assert saw["accesses"] == cyc["accesses"]


def test_paged_decode_trace_lru_hit_rate(pkg):
    _, cs = pkg
    cyc = cs.simulate_paged_decode("cyclic", [128], n_steps=16, page=16, capacity_pages=6)
    saw = cs.simulate_paged_decode("sawtooth", [128], n_steps=16, page=16, capacity_pages=6)
    assert saw["hit_rate"] > cyc["hit_rate"]


# ---- the port equals the reference exactly -----------------------------------------


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("causal,n_workers,cache_mb", [(False, 8, 0.5), (True, 48, 1.0),
                                                       (True, 3, 24.0)])
def test_attention_trace_and_simulation_equal_reference(order, causal, n_workers, cache_mb):
    kw = dict(seq_len=4096, tile=64, batch=2, heads=2, causal=causal)
    rw, pw = ref_cm.AttentionWorkload(**kw), port_cm.AttentionWorkload(**kw)
    rh, ph = _scaled(ref_cm, cache_mb), _scaled(port_cm, cache_mb)
    got = list(port_cs.attention_trace(pw, ph, order, n_workers, snake_group=3))
    assert got == list(ref_cs.attention_trace(rw, rh, order, n_workers, snake_group=3))
    a = port_cs.simulate_attention(pw, ph, order, n_workers, snake_group=3)
    b = ref_cs.simulate_attention(rw, rh, order, n_workers, snake_group=3)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.hits, a.hit_rate, a.non_compulsory_misses) == (b.hits, b.hit_rate,
                                                            b.non_compulsory_misses)


@pytest.mark.parametrize("order", ORDERS)
def test_decode_traces_and_stats_equal_reference(order):
    lens = [5, 64, 130, 17]
    assert list(port_cs.decode_page_trace(order, lens, 5, 16, snake_group=2)) == \
        list(ref_cs.decode_page_trace(order, lens, 5, 16, snake_group=2))
    for cap in (None, 4, 40):
        assert port_cs.simulate_paged_decode(order, lens, 6, 16, capacity_pages=cap,
                                             snake_group=2) == \
            ref_cs.simulate_paged_decode(order, lens, 6, 16, capacity_pages=cap, snake_group=2)
    assert port_cs.slot_reuse_stats(order, lens, 16, n_steps=3, snake_group=2) == \
        ref_cs.slot_reuse_stats(order, lens, 16, n_steps=3, snake_group=2)
    for shared in (True, False):
        args = (order, 3, 4, [3, 20, 40], 4, 16)
        assert list(port_cs.shared_prefix_decode_trace(*args, shared=shared, snake_group=3)) \
            == list(ref_cs.shared_prefix_decode_trace(*args, shared=shared, snake_group=3))
        assert port_cs.simulate_shared_prefix_decode(*args, shared=shared, capacity_pages=10,
                                                     snake_group=3) == \
            ref_cs.simulate_shared_prefix_decode(*args, shared=shared, capacity_pages=10,
                                                 snake_group=3)
    with pytest.raises(ValueError):
        list(port_cs.shared_prefix_decode_trace(order, 2, 1, [1], 1, 16))


def test_reuse_distance_statistics_equal_reference():
    import random

    rng = random.Random(3)
    keys = [(rng.randrange(9),) for _ in range(300)]
    d = port_cs.reuse_distances(keys)
    assert d == ref_cs.reuse_distances(keys)
    assert port_cs.reuse_distance_stats(d) == ref_cs.reuse_distance_stats(d)
    assert port_cs.reuse_distance_stats([]) == ref_cs.reuse_distance_stats([])
    for p in (0, 12.5, 50, 90, 100):
        assert port_cs.reuse_distance_percentile(d, p) == ref_cs.reuse_distance_percentile(d, p)
    with pytest.raises(ValueError):
        port_cs.reuse_distance_percentile(d, 101)
