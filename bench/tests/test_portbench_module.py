"""A configuration file may name a module of its own (``"module"``) that
defines the port's config, the weights or the plain reference it is judged
by. A file that names none resolves to the defaults themselves; a named
module is what the engine, the weights, the check and the control use; a
module path that names no file is an error naming the configuration."""

import pytest
import torch

import portbench_cells
from bench import harness, weights
from bench.control import readings
from bench.harness import Bench, model_of, reference_numbers, run_cell, sample
from bench.reference import model as reference
from bench.spec import load_module

CELLS = ["deepseek-7b.chat", "deepseek-7b.long-prompt"]


def _cell(workload: str):
    """``workload`` at the tests' size, its configuration naming the module
    whose reference lowers each row's next token."""
    config = dict(portbench_cells.tiny_config(portbench_cells.config_of("deepseek-7b")),
                  module=portbench_cells.LOWERED)
    return portbench_cells.tiny_cell(workload, config=config)


@pytest.mark.parametrize("name", ["deepseek-7b", "moe"])
def test_a_file_naming_no_module_takes_the_defaults(name):
    config = portbench_cells.config_of(name)
    assert "module" not in config
    m = model_of(config)
    assert m.port_config is harness.port_config
    assert m.Weights is weights.Weights
    assert m.logits_at is reference.logits_at


@pytest.mark.parametrize("workload", CELLS)
def test_the_check_reads_the_modules_reference(monkeypatch, workload):
    cell = _cell(workload)
    out, info = run_cell(cell, 2**34 + 3, 0.3, False, device="cpu")
    assert out["correct"] is False and out["failed"] == 0, info
    assert info["numbers"]["logit_gap"] >= 1
    monkeypatch.setattr(load_module(cell.config), "logits_at", reference.logits_at)
    out, info = run_cell(cell, 2**34 + 3, 0.3, False, device="cpu")
    assert out["correct"] is True, info
    assert info["numbers"]["logit_gap"] < 1e-4


def test_the_engine_weights_check_and_control_use_the_module(monkeypatch):
    cell = _cell("deepseek-7b.chat")
    mod = load_module(cell.config)
    assert load_module(dict(cell.config)) is mod
    configs, calls = [], []

    def port_config(c):
        configs.append(c)
        return harness.port_config(c)

    def logits_at(params, config, seqs, *, fp8=False):
        calls.append(fp8)
        return reference.logits_at(params, config, seqs, fp8=fp8)

    monkeypatch.setattr(mod, "port_config", port_config)
    monkeypatch.setattr(mod, "logits_at", logits_at)
    b = Bench(cell, "cpu")
    assert configs == [cell.config] and type(b.weights) is mod.Weights
    assert b.weights.device == torch.device("cpu")
    b.weights.fill(7)
    b.warm_up()
    chosen = sample(b.serve(b.wave(7, 0))[0].served, 2, 7)
    got = reference_numbers(b.weights, cell.config, chosen, control=True)
    assert calls == [False, True] and got["logit_gap"] > 0
    calls.clear()
    rows = list(readings(cell, [7], 1, device="cpu"))
    assert calls == [False, False, True]
    assert set(rows[0]) >= {"program", "control"}


def test_a_missing_module_is_an_error_naming_the_configuration():
    for path in ("bench/tests/no_such_module.py", "src/repro_torch/__init__.py",
                 "bench/tests/../../src/repro_torch/__init__.py", "bench/configs"):
        config = dict(portbench_cells.config_of("deepseek-7b"), name="olmoe-test", module=path)
        with pytest.raises(FileNotFoundError, match="olmoe-test"):
            model_of(config)
    cell = _cell("deepseek-7b.chat")
    cell.config["module"] = "bench/no_such_module.py"
    with pytest.raises(FileNotFoundError, match=cell.config["name"]):
        Bench(cell, "cpu")
