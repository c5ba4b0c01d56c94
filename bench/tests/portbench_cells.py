"""Cells of the benchmark cut to a size the CPU tests can run: the cell's
own engine, mix and check, on a configuration file shrunk to the port's
``.reduced()`` widths and a few dozen positions."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench.spec import Cell, load_cell  # noqa: E402

# The configuration modules the tests name (paths from the root, as a
# configuration file's "module" gives them).
LOWERED = "bench/tests/portbench_lowered.py"
MODULES = [LOWERED]


def tiny_config(c: dict, dtype: str = "float32") -> dict:
    c = dict(c, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, vocab_size=256, dtype=dtype)
    if c.get("num_experts"):
        c.update(intermediate_size=32, num_experts=4, num_experts_per_tok=2)
    else:
        c.update(intermediate_size=128)
    return c


def moe_config() -> dict:
    """A MoE sibling of deepseek-7b's file (64 experts of width 1024, top 8,
    on the port's MoE family): no cell runs one yet, but the weights, the
    counts and the reference take MoE files, and these tests hold them to
    the port. It names no module, so it is judged by the default reference,
    whose router softmaxes its top-k logits: that is the port's
    ``olmoe-1b-7b`` family as it routes today, not OLMoE's published routing
    (a softmax over all 64 logits, the top 8 kept unrenormalized, and q/k
    RMSNorm), which a configuration file brings with a module of its own."""
    c = load_cell(ROOT, "deepseek-7b.chat").config
    return dict(c, name="moe-test", port_arch="olmoe-1b-7b", num_experts=64,
                num_experts_per_tok=8, intermediate_size=1024)


def config_of(name: str) -> dict:
    """``deepseek-7b`` (the file of the chat cell) or ``moe`` (its MoE sibling)."""
    return moe_config() if name == "moe" else load_cell(ROOT, "deepseek-7b.chat").config


def tiny_cell(workload: str, dtype: str = "float32", *, max_len: int = 128,
              config=None) -> Cell:
    """``workload`` with 2 slots, waves of 3 (static: 2), prompts of 8-60
    tokens and 4-20 out, at ``max_len``."""
    cell = load_cell(ROOT, workload)
    e = dict(cell.settings["engine"], slots=2, max_len=max_len)
    if e["scheduler"] == "continuous":
        e.update(page_size=16, prefill_chunk=32)
    mix = dict(cell.mix, prompt={"dist": "uniform", "min": 8, "max": 60},
               output={"dist": "uniform", "min": 4, "max": 20})
    return dataclasses.replace(
        cell, config=config or tiny_config(cell.config, dtype), mix=mix,
        settings=dict(cell.settings, engine=e, wave=3 if e["scheduler"] == "continuous" else 2))
