"""OLMoE-1B-7B as published (``configs/olmoe-1b-7b.json``, module
``bench/models/olmoe.py``) at a reduced size in float32: the module's
weights in the port's layout, its plain reference against the port's
forward on them (and a port routed or normed as the defaults are reads
wrong there), the grouped products' counts by hand, the two MoE metrics on
waves built by hand, and the cell run end to end on the CPU."""

import dataclasses

import pytest
import torch

import portbench_cells
from bench.counts import Shapes
from bench.counts_moe import moe_need
from bench.harness import RunRecord, WaveRecord, model_of, run_cell
from bench.profiling import DeviceProfile
from bench.reference.model import logits_at as default_logits_at
from bench.spec import load_reader
from repro_torch.obs.trace import SpanEvent

CELL = "olmoe-1b-7b.chat"


def _tiny() -> dict:
    """The configuration file at the port's reduced widths; its eos inside
    the reduced vocab."""
    c = portbench_cells.load_cell(portbench_cells.ROOT, CELL).config
    return dict(portbench_cells.tiny_config(c), eos_token_id=1)


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree(v) for v in t]
    return (tuple(t.shape), t.dtype)


def _weights(c, seed=11):
    return model_of(c).Weights(Shapes.from_config(c), c, device="cpu",
                               dtype=torch.float32).fill(seed)


def test_the_file_names_its_module_and_the_published_switches():
    c = portbench_cells.load_cell(portbench_cells.ROOT, CELL).config
    cfg = model_of(c).port_config(c)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab) == (
        16, 2048, 16, 16, 50304)
    assert dataclasses.astuple(cfg.moe)[:3] == (64, 8, 1024)
    assert cfg.qk_norm and not cfg.moe.norm_topk_prob
    assert (cfg.norm_eps, cfg.eos_id, cfg.name) == (1e-5, 50279, "olmoe-1b-7b-0924")
    assert model_of(c).logits_at is not default_logits_at


def test_weights_take_the_ports_layout():
    from repro_torch.models.model import build_model

    c = _tiny()
    model = model_of(c)
    w = _weights(c, 3)
    assert _tree(w.params) == _tree(build_model(model.port_config(c), device="cpu").init(0))
    again = _weights(c, 3)
    assert torch.equal(w.flat, again.flat) and torch.equal(w.qk, again.qk)
    assert not torch.equal(w.qk, again.fill(4).qk)
    attn = w.params["layers"][1]["attn"]
    for name, width in (("q_norm", 4 * 16), ("k_norm", 2 * 16)):
        scale = attn[name]["scale"]
        assert scale.shape == (width,)
        assert scale.mean().item() == pytest.approx(1.0, abs=0.06)
        assert 0.05 < scale.std().item() < 0.15
    assert torch.equal(w.params["layers"][0]["ln_attn"]["scale"], torch.ones(64))


def _port_logits(c, w, tokens, start, **cfg_kw):
    from repro_torch.models.model import build_model

    cfg = model_of(c).port_config(c)
    if "norm_topk_prob" in cfg_kw:
        cfg_kw["moe"] = dataclasses.replace(cfg.moe, norm_topk_prob=cfg_kw.pop("norm_topk_prob"))
    lm = build_model(cfg.with_(**cfg_kw), device="cpu")
    return torch.stack([lm.prefill(w.params, {"tokens": tokens[None, :k + 1]}, 64)[0][0, -1]
                        for k in range(start, len(tokens))]).float()


def test_reference_equals_the_ports_forward():
    c = _tiny()
    w = _weights(c)
    tokens = torch.randint(0, c["vocab_size"], (24,), generator=torch.Generator().manual_seed(0))
    ref = model_of(c).logits_at(w.params, c, [(tokens, 9)])[0]
    port = _port_logits(c, w, tokens, 9)
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    assert ref.shape == port.shape
    assert (ref - port).abs().max().item() < tol


@pytest.mark.parametrize("wrong", ["renormalized top-k", "no q/k norm"])
def test_a_port_routed_or_normed_as_the_defaults_reads_wrong(wrong):
    """The reference tells the published model from the port's defaults:
    Mixtral's renormalized routing, or no q/k norm, lies far outside the
    rounding the forward above is held to, and the default reference is not
    this one."""
    c = _tiny()
    w = _weights(c)
    tokens = torch.randint(0, c["vocab_size"], (24,), generator=torch.Generator().manual_seed(1))
    ref = model_of(c).logits_at(w.params, c, [(tokens, 9)])[0]
    kw = {"norm_topk_prob": True} if wrong == "renormalized top-k" else {"qk_norm": False}
    port = _port_logits(c, w, tokens, 9, **kw)
    assert (ref - port).abs().max().item() > 1e-2 * max(1.0, ref.abs().max().item())
    other = default_logits_at(w.params, c, [(tokens, 9)])[0]
    assert (ref - other).abs().max().item() > 1e-2


def test_counts_by_hand():
    s = Shapes(layers=2, d=4, heads=1, kv_heads=1, head_dim=4, d_ff=3, vocab=10,
               experts=4, top_k=2, d_ff_expert=3)
    # 10 rows in 3 groups: 6*10*4*3 FLOPs; 3 groups x 3 matrices of 4x3,
    # 10 rows x (12 + 9) activations, 2 bytes each
    assert moe_need(s, 10, 3) == (720, (3 * 36 + 10 * 21) * 2)
    assert moe_need(s, 0, 0) == (0, 0)


def _instant(name, **args):
    return SpanEvent(name=name, ts_ns=0, dur_ns=-1, tid=0, args=args)


def _moe(rows, groups, launches=32):
    return _instant("serve.moe", layers=16, launches=launches, rows=rows, groups=groups,
                    rows_max=rows // 10)


def _profile(op_s):
    return DeviceProfile(wall_s=1.0, busy_s=0.9, records=10, op_s=op_s, idle_by_host={})


# the two kernels of a bf16 grouped_mm on the H100, as the profiler names them
GROUPED_KERNEL = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4"
                  "gemm6kernel13GemmUniversalINS5_17GroupProblem")
PREPARE = ("void at::cuda::detail::prepare_grouped_gemm_data<cutlass::bfloat16_t, "
           "cutlass::bfloat16_t, cutlass::bfloat16_t, float, c")


def test_the_moe_metrics_by_hand():
    s = Shapes.from_config(portbench_cells.load_cell(portbench_cells.ROOT, CELL).config)
    waves = [WaveRecord(0.0, 1.0, [], [_moe(3000, 100), _instant("serve.compile")], None),
             WaveRecord(1.0, 2.0, [], [_moe(1000, 60)], None)]
    traced = WaveRecord(2.0, 3.0, [], [_moe(2048 * 16, 1024)], None)
    t = 2.5e-3
    run = RunRecord(None, s, waves, traced, _profile(
        {GROUPED_KERNEL: t - 1e-4, PREPARE: 1e-4, "paged_decode_kernel": 1.0}))
    assert load_reader("moe_rows_per_group")(run) == pytest.approx(4000 / 160)
    flops, nbytes = moe_need(s, 2048 * 16, 1024)
    assert nbytes / 3.35e12 > flops / 989e12
    assert load_reader("moe_roofline")(run) == pytest.approx(100 * nbytes / 3.35e12 / t)
    # nothing to read: no serve.moe (a dense model, or a program that does
    # not count), no grouped kernel in the trace, no trace
    bare = RunRecord(None, s, [WaveRecord(0.0, 1.0, [], [], None)],
                     WaveRecord(2.0, 3.0, [], [], None), _profile({GROUPED_KERNEL: t}))
    assert load_reader("moe_rows_per_group")(bare) is None
    assert load_reader("moe_roofline")(bare) is None
    no_kernel = dataclasses.replace(run, profile=_profile({"paged_decode_kernel": 1.0}))
    assert load_reader("moe_roofline")(no_kernel) is None
    assert load_reader("moe_roofline")(dataclasses.replace(run, profile=None)) is None


def test_the_cell_runs_on_the_cpu_and_its_reference_agrees():
    """The cell at a reduced size, traced: every request served in full,
    the served tokens the module's reference's best to rounding, and
    ``moe_rows_per_group`` read from the engine's ``serve.moe``."""
    cell = portbench_cells.tiny_cell(CELL, config=_tiny())
    assert {m["name"] for m in cell.per_layer} >= {"moe_roofline", "moe_rows_per_group",
                                                    "b1_roofline", "mfu"}
    out, info = run_cell(cell, 2**31 + 36, 0.5, True, device="cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 3
    assert info["compared"] >= 2 and info["numbers"]["logit_gap"] < 1e-4
    rows = out["metrics"]["moe_rows_per_group"]["value"]
    assert 1.0 <= rows <= 32 * 2   # at most a compact replay's 32 positions x top 2
    assert "moe_roofline" not in out["metrics"]   # no device trace on the CPU
