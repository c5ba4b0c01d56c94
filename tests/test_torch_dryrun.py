"""The port's dry-run (``launch.dryrun``) and its pieces.

``LM.input_specs`` against the reference's for every family; the
reference's two dry-run tests, ported (the CLI on one production cell, and
``lower_cell`` on reduced cells of a small mesh); per-rank flops on a data
mesh against one rank's whole step; the depth extrapolation against a
full-depth trace; a fake 1x1 cell's argument bytes against a real state's;
the sharding specs under ``FakeTensorMode`` on a fake group. A fake process
group is process-wide, so everything that joins one runs in a subprocess
(the reference's multi-device tests do the same with XLA's device count).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

import jax
import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import SHAPES, get_config
from repro_torch.models import build_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
# What the reference's dry-run record holds (src/repro/launch/dryrun.py).
REF_RECORD_KEYS = {"arch", "shape", "mesh", "chips", "status", "lower_s", "compile_s", "memory",
                   "cost", "collectives", "roofline", "param_count", "active_param_count"}
REF_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                   "generated_code_bytes"}


def _run(code: str, timeout: int = 420) -> dict:
    """Run ``code`` in a fresh interpreter; it prints one JSON line last."""
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-8000:]}"
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_input_specs_equal_reference(arch, reduced):
    """Every family's batch of every shape: the reference's
    ``ShapeDtypeStruct`` shapes, int32 tokens, embeddings in the
    activation dtype; fake tensors under ``FakeTensorMode``."""
    ref_lm = ref_build_model(ref_get_config(arch))
    cfg = get_config(arch)
    act = (cfg.reduced() if reduced else cfg).activation_dtype()
    with FakeTensorMode():
        lm = build_model(cfg, device="cpu")
        for name in SHAPES:
            want = ref_lm.input_specs(REF_SHAPES[name], reduced=reduced)
            got = lm.input_specs(SHAPES[name], reduced=reduced)
            assert sorted(got) == sorted(want), name
            for k, spec in want.items():
                assert tuple(got[k].shape) == tuple(spec.shape), (name, k)
                assert got[k].device.type == "cpu"
                if np.issubdtype(spec.dtype, np.integer):
                    assert got[k].dtype == torch.int32
                else:
                    assert got[k].dtype == act
                    assert jax.numpy.dtype(spec.dtype).name == str(act).removeprefix("torch.")


def test_importing_the_dryrun_joins_nothing():
    got = _run("""
        import json, os, torch
        import repro_torch.launch.dryrun
        print(json.dumps({"joined": torch.distributed.is_initialized(),
                          "xla_flags": "XLA_FLAGS" in os.environ}))
    """)
    assert got == {"joined": False, "xla_flags": False}


def test_dryrun_cli_single_cell(tmp_path):
    """The reference's CLI test: ``python -m repro_torch.launch.dryrun`` on
    mamba2-130m decode_32k on the single-pod 16x16 mesh (256 fake ranks)
    prints "1 ok, 0 skipped, 0 errors", writes a record with the
    reference's keys (and, with --save-hlo, its per-op trace) and leaves no
    process group joined; a cell that fails leaves none either."""
    got = _run(f"""
        import contextlib, io, json, runpy, sys, torch
        sys.argv = ["dryrun", "--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh",
                    "single", "--out", {str(tmp_path)!r}, "--no-resume", "--save-hlo"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
        after = torch.distributed.is_initialized()
        from repro_torch.launch import dryrun as D
        try:
            with D.fake_world(4):
                raise ValueError("inside the cell")
        except ValueError:
            pass
        print(json.dumps({{"stdout": buf.getvalue(), "joined": after,
                          "joined_after_error": torch.distributed.is_initialized()}}))
    """)
    assert "1 ok, 0 skipped, 0 errors" in got["stdout"], got["stdout"]
    assert not got["joined"] and not got["joined_after_error"]
    rec = json.loads((tmp_path / "mamba2-130m__decode_32k__single.json").read_text())
    assert REF_RECORD_KEYS <= set(rec) and set(rec["memory"]) == REF_MEMORY_KEYS
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["compile_s"] == 0.0
    assert rec["cost"]["flops"] > 0 and rec["memory"]["alias_bytes"] > 0
    text = (tmp_path / "mamba2-130m__decode_32k__single.trace.txt").read_text()
    assert len(text.splitlines()) == rec["ops"] and "aten.mm.default(" in text


def test_dryrun_cli_skips_long_context_for_full_attention(tmp_path):
    """long_500k is recorded as skipped for a full-attention arch, as in
    the reference, and resumes from its record."""
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "deepseek-7b",
           "--shape", "long_500k", "--mesh", "both", "--out", str(tmp_path)]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0 and "0 ok, 2 skipped, 0 errors" in r.stdout, r.stdout
    rec = json.loads((tmp_path / "deepseek-7b__long_500k__multi.json").read_text())
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0 and r.stdout.count("[skip-cached]") == 2, r.stdout


def test_reduced_dryrun_cells_on_small_mesh():
    """The reference's ``test_reduced_dryrun_cell_on_small_mesh``: reduced
    olmoe-1b-7b train_4k and mixtral-8x7b decode_32k on a fake (4, 2)
    mesh."""
    got = _run("""
        import json
        from repro_torch.launch.dryrun import fake_world, lower_cell
        from repro_torch.launch.mesh import make_local_mesh

        with fake_world(8):
            mesh = make_local_mesh(4, 2, device="cpu")
            rec, tr = lower_cell("olmoe-1b-7b", "train_4k", mesh, "local8", reduced=True)
            rec2, _ = lower_cell("mixtral-8x7b", "decode_32k", mesh, "local8", reduced=True)
        print(json.dumps({"a": rec, "b": rec2, "ops": len(tr.ops)}))
    """)
    for rec in (got["a"], got["b"]):
        assert rec["status"] == "ok" and rec["chips"] == 8
        assert rec["cost"]["flops"] > 0 and rec["collectives"]["total"] > 0
        assert "roofline" in rec and rec["roofline"]["bottleneck"] in (
            "compute", "memory", "collective")
        assert REF_RECORD_KEYS <= set(rec)
    assert got["a"]["memory"]["temp_bytes"] > 0 and got["ops"] == got["a"]["ops"]


def test_per_rank_flops_on_a_data_mesh():
    """Reduced deepseek-7b's step (batch 8, microbatches 1) on a fake (8, 1)
    mesh: each rank's flops, times 8, equal one rank's flops of the whole
    step on 1x1 exactly. A counter of the global op reads 8 times more."""
    got = _run("""
        import json
        from repro_torch.launch.dryrun import fake_world, lower_cell
        from repro_torch.launch.mesh import make_local_mesh

        out = {}
        for d in (1, 8):
            with fake_world(d):
                rec, _ = lower_cell("deepseek-7b", "train_4k", make_local_mesh(d, 1, device="cpu"),
                                    f"{d}x1", reduced=True, shape_overrides={"global_batch": 8},
                                    par_overrides={"microbatches": 1})
            out[d] = {"flops": rec["cost"]["flops"], "coll": rec["collectives"]["total"]}
        print(json.dumps(out))
    """)
    assert got["1"]["flops"] > 0 and got["1"]["coll"] == 0 and got["8"]["coll"] > 0
    assert 8 * got["8"]["flops"] == got["1"]["flops"]


def test_extrapolation_equals_a_full_depth_trace():
    """``extrapolate_cell`` from depth 1 and 2 of reduced deepseek-7b at 4
    layers on a fake (2, 2) mesh equals the 4-layer trace: flops, bytes and
    collective bytes (a homogeneous stack, every layer unrolled)."""
    got = _run("""
        import json
        from repro_torch.launch.dryrun import extrapolate_cell, fake_world, lower_cell
        from repro_torch.launch.mesh import make_local_mesh

        with fake_world(4):
            mesh = make_local_mesh(2, 2, device="cpu")
            ex = extrapolate_cell("deepseek-7b", "train_4k", mesh, "2x2",
                                  cfg_overrides={"n_layers": 4}, reduced=True)
            full, _ = lower_cell("deepseek-7b", "train_4k", mesh, "2x2",
                                 cfg_overrides={"n_layers": 4}, par_overrides={"microbatches": 1},
                                 reduced=True)
        print(json.dumps({"ex": ex, "full": full}))
    """)
    ex, full = got["ex"], got["full"]
    assert ex["depth_units"] == 4 and ex["depth1"]["cost"]["flops"] < ex["depth2"]["cost"]["flops"]
    assert ex["cost"]["flops"] == full["cost"]["flops"]
    assert ex["cost"]["bytes accessed"] == full["cost"]["bytes_accessed"]
    assert ex["collectives"] == full["collectives"]
    assert ex["roofline"] == {**full["roofline"], "shape": "train_4k"}


def test_fake_cell_argument_bytes_equal_a_real_state():
    """A fake 1x1 cell's argument bytes (the state and the batch, adamw and
    adamw_factored) equal those of the same state built for real on the
    CPU, exactly; its alias bytes are the state's."""
    got = _run("""
        import json
        from repro_torch.configs import TrainConfig
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.configs import SHAPES
        from repro_torch.train.step import make_train_state

        out = {}
        for opt in ("adamw", "adamw_factored"):
            tcfg = TrainConfig(optimizer=opt)
            with D.fake_world(1):
                rec, _ = D.lower_cell("deepseek-7b", "train_4k",
                                      make_local_mesh(1, 1, device="cpu"), "1x1", reduced=True,
                                      train_cfg=tcfg)
            cfg = D._cell_cfg("deepseek-7b", None, True)
            lm = D.build_model(cfg, device="cpu")
            state = make_train_state(lm, tcfg, 0, device="cpu")
            batch = lm.input_specs(SHAPES["train_4k"].reduced())
            out[opt] = {"fake": rec["memory"], "state": D.local_bytes(state),
                        "batch": D.local_bytes(batch)}
        print(json.dumps(out))
    """)
    for opt, r in got.items():
        assert r["fake"]["argument_bytes"] == r["state"] + r["batch"], opt
        assert r["fake"]["alias_bytes"] == r["state"], opt
    assert got["adamw_factored"]["state"] < got["adamw"]["state"]


def test_sharding_specs_under_fake_mode_on_a_fake_group():
    """``param_specs`` and ``shard_state`` under ``FakeTensorMode`` on a fake
    (4, 2) group, with no real tensor let in: the specs equal those of the
    device-free ``MeshShape``, and every param is a DTensor on its spec."""
    got = _run("""
        import json
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor
        from repro_torch.configs import ParallelConfig, TrainConfig, get_config
        from repro_torch.dist import sharding as shd
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import build_model
        from repro_torch.train.optimizer import named_leaves
        from repro_torch.train.step import make_train_state, shard_state

        pcfg = ParallelConfig(fsdp_axes=("data",), data_axes=("data",))
        out = {}
        with fake_world(8):
            mesh = make_local_mesh(4, 2, device="cpu")
            for arch in ("deepseek-7b", "olmoe-1b-7b", "zamba2-2_7b"):
                with FakeTensorMode(allow_non_fake_inputs=False):
                    lm = build_model(get_config(arch).reduced(), device="cpu")
                    state = make_train_state(lm, TrainConfig(), 0, device="cpu")
                    specs = shd.param_specs(state["params"], pcfg, mesh)
                    free = shd.param_specs(state["params"], pcfg,
                                           shd.MeshShape((4, 2), ("data", "model")))
                    placed = shard_state(state, pcfg, mesh)
                pairs = list(zip((t for _, t in named_leaves(placed["params"])),
                                 (s for _, s in named_leaves(specs))))
                out[arch] = {
                    "equal": specs == free,
                    "placed": all(isinstance(t, DTensor) for t, _ in pairs),
                    "on_specs": all(tuple(t.placements) == shd.placements(s, mesh)
                                    for t, s in pairs),
                    "sharded": sum(any(p.is_shard() for p in t.placements) for t, _ in pairs),
                }
        print(json.dumps(out))
    """)
    for arch, r in got.items():
        assert r["equal"] and r["placed"] and r["on_specs"], (arch, r)
        assert r["sharded"] > 0, arch


def test_kv_heads_fewer_than_the_tensor_axis():
    """Reduced mixtral-8x7b (2 KV heads, MoE) and qwen2-72b (GQA, qkv bias)
    on a fake (1, 4) mesh: the K/V projections' 4-way shard cannot hold
    whole heads, so they are gathered before the split into heads
    (``dist.context.split_last``); before, DTensor refused the reshape
    ("Cannot unflatten unevenly sharded tensor")."""
    got = _run("""
        import json
        from repro_torch.launch.dryrun import fake_world, lower_cell
        from repro_torch.launch.mesh import make_local_mesh

        out = {}
        with fake_world(4):
            mesh = make_local_mesh(1, 4, device="cpu")
            for arch in ("mixtral-8x7b", "qwen2-72b"):
                for shape in ("train_4k", "decode_32k"):
                    rec, _ = lower_cell(arch, shape, mesh, "1x4", reduced=True)
                    out[f"{arch} {shape}"] = [rec["status"], rec["cost"]["flops"]]
        print(json.dumps(out))
    """)
    for cell, (status, flops) in got.items():
        assert status == "ok" and flops > 0, cell


def test_sequence_sharding_rules_reach_the_step():
    """``seq_shard_activations`` installs the reference's ``residual`` and
    ``moe_tokens`` rules (``dryrun.py:89-97``), and ``on_mesh`` keeps them
    under the step's own ``embed_table`` and ``logits`` rules."""
    got = _run("""
        import json
        from repro_torch.dist.context import activation_rules, current_rules, on_mesh
        from repro_torch.dist.sharding import P
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import make_local_mesh

        with D.fake_world(4):
            mesh = make_local_mesh(2, 2, device="cpu")
            pcfg = D.dryrun_parallel_cfg(mesh, "train", {"seq_shard_activations": True})
            rules = D._activation_rules(pcfg, mesh)
            with activation_rules(rules), on_mesh(mesh, {"logits": P(("data",))}):
                inner = current_rules()
            off = D._activation_rules(D.dryrun_parallel_cfg(mesh, "train"), mesh)
        print(json.dumps({"rules": {k: list(v) for k, v in rules.items()},
                          "inner": sorted(inner), "off": off}))
    """)
    assert got["rules"] == {"residual": [["data"], "model", None],
                            "moe_tokens": [["data", "model"], None]}
    assert got["inner"] == ["embed_table", "logits", "moe_tokens", "residual"]
    assert got["off"] is None
