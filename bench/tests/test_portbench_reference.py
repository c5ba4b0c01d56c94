"""The plain reference (``bench/reference/``) held to the port's CPU path on
the same weights, at reduced sizes in float32: the benchmark's weights in
the port's layout, the full forward against the port's prefill at every
position, and whole served streams (continuous, static left-padded, MoE)
through the engine judged by the check the benchmark runs."""

import dataclasses

import pytest
import torch

import portbench_cells
from bench.counts import Shapes
from bench.harness import model_of, run_cell
from bench.reference.check import numbers, served_sequence, token_gaps

CELLS = ["deepseek-7b.chat", "deepseek-7b.long-prompt"]


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree(v) for v in t]
    return (tuple(t.shape), t.dtype)


@pytest.mark.parametrize("name", ["deepseek-7b", "moe"])
def test_weights_take_the_ports_layout(name):
    from repro_torch.models.model import build_model

    c = portbench_cells.tiny_config(portbench_cells.config_of(name))
    model = model_of(c)
    cfg = model.port_config(c)
    w = model.Weights(Shapes.from_config(c), c, device="cpu", dtype=torch.float32).fill(3)
    assert _tree(w.params) == _tree(build_model(cfg, device="cpu").init(0))
    assert w.device == torch.device("cpu")
    again = model.Weights(Shapes.from_config(c), c, device="cpu", dtype=torch.float32).fill(3)
    assert torch.equal(w.flat, again.flat)
    assert not torch.equal(w.flat, again.fill(4).flat)
    # the port's scales: 1/sqrt(fan-in) for q, 0.02 for the embedding
    assert w.params["layers"][0]["attn"]["wq"]["w"].std().item() == pytest.approx(
        c["hidden_size"] ** -0.5, rel=0.1)
    assert w.params["embed"]["table"].std().item() == pytest.approx(0.02, rel=0.1)


@pytest.mark.parametrize("name", ["deepseek-7b", "moe"])
def test_reference_equals_the_ports_forward(name):
    from repro_torch.models.model import build_model

    c = portbench_cells.tiny_config(portbench_cells.config_of(name))
    model = model_of(c)
    lm = build_model(model.port_config(c), device="cpu")
    w = model.Weights(Shapes.from_config(c), c, device="cpu", dtype=torch.float32).fill(11)
    tokens = torch.randint(0, c["vocab_size"], (24,), generator=torch.Generator().manual_seed(0))
    start = 9
    ref = model.logits_at(w.params, c, [(tokens, start)])[0]
    port = torch.stack([lm.prefill(w.params, {"tokens": tokens[None, :k + 1]}, 64)[0][0, -1]
                        for k in range(start, len(tokens))]).float()
    assert ref.shape == port.shape
    assert (ref - port).abs().max().item() < 1e-4 * max(1.0, ref.abs().max().item())


def test_gaps_read_a_wrong_token():
    logits = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.5, 2.9]])
    assert token_gaps(logits, [1, 0]).tolist() == [0.0, 0.0]
    assert numbers([token_gaps(logits, [1, 2])]) == pytest.approx(
        {"logit_gap": 0.1, "mean_gap": 0.05}, abs=1e-6)
    assert numbers([token_gaps(logits, [0, 1]), token_gaps(logits[:1], [1])]) == pytest.approx(
        {"logit_gap": 2.5, "mean_gap": 4.5 / 3}, abs=1e-6)
    toks, start = served_sequence([5, 6, 7], [8, 9], "cpu")
    assert toks.tolist() == [5, 6, 7, 8] and start == 2


@pytest.mark.parametrize("workload,moe", [(c, False) for c in CELLS]
                         + [("deepseek-7b.chat", True)])
def test_served_streams_agree_with_the_reference(workload, moe):
    """Each cell's whole run at a reduced size, float32 (and the chat cell on
    the MoE sibling): every request served in full, and the served tokens
    the reference's best to rounding."""
    config = portbench_cells.tiny_config(portbench_cells.moe_config()) if moe else None
    out, info = run_cell(portbench_cells.tiny_cell(workload, config=config), 2**31 + 99, 0.5,
                         False, device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert info["compared"] >= 2
    assert info["numbers"]["logit_gap"] < 1e-4


def test_static_padding_is_what_the_reference_sees():
    """The static cell's prompts reach the reference left-padded with the
    port's pad token into their group's bucket; unpadded they would not
    be the sequences the engine ran."""
    cell = portbench_cells.tiny_cell("deepseek-7b.long-prompt")
    from bench.harness import Bench

    b = Bench(cell, "cpu")
    b.weights.fill(5)
    b.warm_up()
    rec, _ = b.serve(b.wave(5, 0))
    bucket = max(s.prompt_len for s in rec.served)
    assert all(len(s.prompt) == bucket for s in rec.served)
    short = min(rec.served, key=lambda s: s.prompt_len)
    assert short.prompt_len < bucket
    assert (short.prompt[: bucket - short.prompt_len] == b.cfg.eos_id).all()
    logits_at = model_of(cell.config).logits_at
    padded = logits_at(b.weights.params, cell.config,
                       [served_sequence(short.prompt, short.tokens, "cpu")])
    bare = logits_at(b.weights.params, cell.config,
                     [served_sequence(short.prompt[bucket - short.prompt_len:], short.tokens,
                                      "cpu")])
    assert float(token_gaps(padded[0], short.tokens).max()) < 1e-4
    assert not torch.allclose(padded[0], bare[0], atol=1e-3)


def test_run_cell_config_is_the_file():
    cell = portbench_cells.load_cell(portbench_cells.ROOT, "deepseek-7b.chat")
    cfg = model_of(cell.config).port_config(cell.config)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab,
            cfg.norm_eps) == (30, 4096, 32, 32, 11008, 102400, 1e-6)
    moe = model_of(portbench_cells.moe_config()).port_config(portbench_cells.moe_config())
    assert dataclasses.astuple(moe.moe)[:3] == (64, 8, 1024)
    assert moe.family == "moe" and moe.param_dtype == "bfloat16"
