"""A run with the timed path broken underneath must come out not correct:
the run is driven as the benchmark drives it (on the CPU at a reduced
size, its look for the card skipped), once for each fault a one-chip
serving cell can have (no exchange between chips exists here):

- a token altered where it is produced (the greedy pick moved by one);
- a step that returns its state unchanged (K/V never written to the pool
  or the static caches);
- half of the batch left out (the second half of a step's rows given the
  first half's tokens).
"""

import pytest
import torch

import portbench_cells
from bench.harness import run_cell

CELLS = ["deepseek-7b.chat", "deepseek-7b.long-prompt"]


def _altered(argmax):
    def pick(logits):
        return (argmax(logits) + 1) % logits.shape[-1]
    return pick


def _half_left_out(argmax):
    def pick(logits):
        out = argmax(logits).clone()
        n = out.shape[0]
        out[n - n // 2:] = out[: n // 2]
        return out
    return pick


def _break(monkeypatch, fault):
    import repro_torch.models.transformer as T
    import repro_torch.serve.engine as E

    if fault == "token_altered":
        monkeypatch.setattr(E, "_argmax", _altered(E._argmax))
    elif fault == "half_left_out":
        monkeypatch.setattr(E, "_argmax", _half_left_out(E._argmax))
    elif fault == "state_unchanged":
        monkeypatch.setattr(T, "write_pages", lambda *a, **k: None)
        monkeypatch.setattr(T, "write_local", lambda *a, **k: None)
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged", "half_left_out"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_path_is_not_correct(monkeypatch, workload, fault):
    cell = portbench_cells.tiny_cell(workload)
    _break(monkeypatch, fault)
    torch.manual_seed(0)
    out, info = run_cell(cell, 2**33 + 5, 0.3, False, device="cpu")
    assert out["correct"] is False, (fault, info)
    compared = [c for name, c in out["checks"].items() if name != "failed_requests"]
    assert compared and any(c["value"] > c["limit"] for c in compared)


def test_the_unbroken_path_is_correct():
    out, _ = run_cell(portbench_cells.tiny_cell("deepseek-7b.chat"), 2**33 + 5, 0.3, False,
                      device="cpu")
    assert out["correct"] is True
