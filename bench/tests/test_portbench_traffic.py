"""The traffic generator: the same seed gives the same waves; every seed
and every wave gives the same set of sizes, in another order; lengths
follow the mix's distribution and fit the cell's ``max_len``."""

import json

import numpy as np
import pytest

import portbench_cells
from bench import traffic

MIXES = portbench_cells.ROOT / "bench" / "mixes"


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 3 * 2**40, -5])
def test_same_seed_same_wave(seed):
    mix = _mix("chat")
    sizes = traffic.request_sizes(mix, 32, 2048)
    a = traffic.make_wave(mix, sizes, seed, 3, 102400)
    b = traffic.make_wave(mix, sizes, seed, 3, 102400)
    assert all(np.array_equal(x.tokens, y.tokens) and x.max_new == y.max_new
               for x, y in zip(a, b))
    assert all(x.tokens.dtype == np.int32 and 0 <= x.tokens.min() and x.tokens.max() < 102400
               for x in a)


def test_seeds_change_tokens_not_work():
    """Every seed serves the same sizes in the same order in wave w; the
    waves of a run differ in order; the seed draws the tokens."""
    mix = _mix("chat")
    sizes = traffic.request_sizes(mix, 32, 2048)
    waves = {(s, w): traffic.make_wave(mix, sizes, s, w, 1000) for s in (1, 2**40) for w in (0, 1)}
    shape = {k: [(len(r.tokens), r.max_new) for r in v] for k, v in waves.items()}
    assert shape[1, 0] == shape[2**40, 0] and shape[1, 1] == shape[2**40, 1]
    assert shape[1, 0] != shape[1, 1] and sorted(shape[1, 0]) == sorted(shape[1, 1])
    assert not np.array_equal(waves[1, 0][0].tokens, waves[2**40, 0][0].tokens)


@pytest.mark.parametrize("name,n,max_len", [("chat", 32, 2048), ("chat", 72, 4096),
                                            ("long-prompt", 8, 4096),
                                            ("long-prompt", 16, 2048)])
def test_sizes_follow_the_mix(name, n, max_len):
    mix = _mix(name)
    sizes = traffic.request_sizes(mix, n, max_len)
    p = np.array([s.prompt for s in sizes])
    o = np.array([s.output for s in sizes])
    assert p.min() >= mix["prompt"]["min"] and p.max() <= mix["prompt"]["max"]
    assert o.min() >= 1 and (p + o).max() <= max_len
    if mix["prompt"]["dist"] == "lognormal":
        assert abs(np.median(p) - mix["prompt"]["median"]) < 0.1 * mix["prompt"]["median"]
    else:
        mid = (mix["prompt"]["min"] + mix["prompt"]["max"]) / 2
        assert abs(p.mean() - mid) < 1


def test_shared_prefixes():
    mix = dict(_mix("chat"), prefixes={"count": 4, "length": 64, "share": 0.75})
    sizes = traffic.request_sizes(mix, 32, 4096)
    assert sum(s.prefix >= 0 for s in sizes) == 24
    assert [sum(s.prefix == k for s in sizes) for k in range(4)] == [6, 6, 6, 6]
    plain = traffic.request_sizes(_mix("chat"), 32, 4096)
    assert [s.prompt - (64 if s.prefix >= 0 else 0) for s in sizes] == [s.prompt for s in plain]
    assert any(s.prefix < 0 for s in sizes[-8:]) and any(s.prefix < 0 for s in sizes[:8])
    a, b = (traffic.make_wave(mix, sizes, 9, w, 1000) for w in (0, 1))
    heads = [tuple(r.tokens[:64]) for r in a]
    common = sorted({h for h in heads if heads.count(h) == 6})
    assert len(common) == 4
    assert common == sorted({h for h in (tuple(r.tokens[:64]) for r in b) if h in common})


def test_motifs_repeat():
    mix = dict(_mix("chat"), motif={"length": 8})
    for r in traffic.make_wave(mix, traffic.request_sizes(mix, 8, 2048), 5, 0, 1000):
        assert np.array_equal(r.tokens[8:16], r.tokens[:8])
