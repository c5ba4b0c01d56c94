"""The lower-precision control, kept as a test at a size a CPU run holds:
the port serving in bf16 (the configuration's precision) reads under each
cell's limits, and the plain reference computed in float8 e4m3 in its
place, judged at the same served positions, reads over them. On the card
the same readings, at the cells' own sizes, are what ``bench/control.py``
prints and what the limits were set from (PERF.md §2).

The size: 4 layers of d 256 (8 heads of 32), d_ff 1024, vocab 4096; the
cells' engines at 256 positions, 2 slots, outputs of 32-96 tokens."""

import dataclasses

import pytest
import torch

import portbench_cells
from bench.control import readings


def _mid_cell(workload):
    base = portbench_cells.load_cell(portbench_cells.ROOT, workload)
    c = dict(base.config, hidden_size=256, num_hidden_layers=4, num_attention_heads=8,
             num_key_value_heads=8, intermediate_size=1024, vocab_size=4096,
             dtype="bfloat16")
    cell = portbench_cells.tiny_cell(workload, config=c, max_len=256)
    return dataclasses.replace(cell, mix=dict(cell.mix, output={"dist": "uniform", "min": 32,
                                                                  "max": 96}))


@pytest.mark.parametrize("workload", ["deepseek-7b.chat", "deepseek-7b.long-prompt"])
def test_the_program_passes_and_the_fp8_control_fails(workload):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = _mid_cell(workload)
    limits = cell.settings["check"]["limits"]
    for row in readings(cell, [1, 2, 3], 3, device="cpu"):
        for name, limit in limits.items():
            assert row["program"][name] <= limit, (row, name)
        assert any(row["control"][name] > limit for name, limit in limits.items()), row
