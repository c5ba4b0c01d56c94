"""What a later cell can ask for with data files alone: engine options
passed through from its cell file (admission, pool pages, a host tier,
order adaptation), a model option (``"model"``: the int8 KV pool), an
n-gram drafter (``"drafter"``), and a mix with shared prefixes and
repeated motifs. Each runs end to end on the CPU at a reduced size and is
judged by the same check."""

import dataclasses

import pytest

import portbench_cells
from bench.harness import Bench, run_cell

EXTRAS = {
    "shared prefixes": dict(mix={"prefixes": {"count": 2, "length": 32, "share": 0.75}}),
    "int8 pool": dict(model={"kv_cache_dtype": "int8"}),
    "ngram drafter": dict(mix={"motif": {"length": 6}},
                          drafter={"kind": "ngram", "draft_len": 4}),
    "optimistic, tiered": dict(engine={"admission": "optimistic", "pool_pages": 10,
                                       "host_pages": 32, "max_preemptions": 50}),
    "adaptive order": dict(engine={"adapt_order": True, "adapt_epoch": 2}),
}


def _cell(extra):
    cell = portbench_cells.tiny_cell("deepseek-7b.chat")
    settings = dict(cell.settings, engine=dict(cell.settings["engine"], **extra.get("engine", {})))
    for key in ("model", "drafter"):
        if key in extra:
            settings[key] = extra[key]
    return dataclasses.replace(cell, settings=settings, mix=dict(cell.mix, **extra.get("mix", {})))


@pytest.mark.parametrize("name", list(EXTRAS))
def test_a_cell_made_of_data_runs_and_is_judged(name):
    out, info = run_cell(_cell(EXTRAS[name]), 2**32 + 17, 0.3, False, device="cpu")
    assert out["failed"] == 0 and out["attempted"] >= 3, info
    assert info["numbers"]["logit_gap"] < 0.3, info


def test_the_options_reach_the_engine():
    b = Bench(_cell({"engine": {"admission": "optimistic", "pool_pages": 10},
                     "model": {"kv_cache_dtype": "int8"},
                     "drafter": {"kind": "ngram", "draft_len": 3}}), "cpu")
    assert b.engine.admission == "optimistic" and b.engine.pool_pages == 10
    assert b.engine.lm.cfg.kv_cache_dtype == "int8"
    assert b.engine.drafter is not None and b.engine.draft_len == 3
