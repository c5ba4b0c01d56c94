"""The port stands alone: no JAX and nothing of the JAX package, and its
entry points run on the card unless the caller names the CPU."""

import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")


def test_every_module_imports_without_jax_or_repro():
    """A fresh interpreter imports every module of the port and chip_smoke
    (without running it); neither jax nor repro may be loaded."""
    mods = _modules()
    assert "repro_torch.serve.engine" in mods and "repro_torch.launch.serve" in mods
    assert {"repro_torch.dist.sharding", "repro_torch.dist.context",
            "repro_torch.dist.compression", "repro_torch.launch.mesh"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_source_names_jax_or_the_reference_package():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    for f in files:
        assert not pat.search(f.read_text()), f


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    cfg = get_config("deepseek-7b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    lm = build_model(cfg, device="cpu")
    params = lm.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(lm, params)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_serve.main(["--arch", "deepseek-7b", "--reduced"])
    with pytest.raises(ValueError, match="unsupported device"):
        build_model(cfg, device="meta")


def test_chip_smoke_refuses_to_run_without_a_gpu(no_cuda, tmp_path):
    """Without a card it exits non-zero and prints no result, in the
    repository and as a lone copy."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             cwd=script.parent, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    launch_serve.main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--batch-size", "2", "--max-new", "4",
                       "--max-len", "64", "--page-size", "8"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out


@pytest.mark.parametrize("flag,item", [
    (["--mesh", "2x2"], "unrecognized arguments: --mesh"),
    (["--attn-impl", "pallas"], "unrecognized arguments: --attn-impl"),
])
def test_launcher_refuses_unported_flags(flag, item, capsys):
    with pytest.raises(SystemExit) as exc:
        launch_serve.main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu", *flag])
    assert exc.value.code == 2
    assert item in capsys.readouterr().err


TIER = ["--admission", "optimistic", "--pool-pages", "4", "--max-preemptions", "50",
        "--host-pages", "24"]


@pytest.mark.parametrize("flags,want", [
    (["--draft", "ngram"], "speculative: "),
    (["--draft", "model", "--draft-len", "2"], "speculative: "),
    (["--draft", "model", "--draft-model", "deepseek-7b"], "speculative: "),
    (TIER, "tiering: "),
    (TIER + ["--spill-watermark", "0.5", "--prefetch-depth", "4"], "tiering: "),
    (TIER + ["--chaos-fetch-fail", "1"], "tiering: "),
    (TIER + ["--chaos-spill-stall", "100"], "resilience: "),
], ids=["ngram", "model_draft_len", "draft_model", "host_pages", "watermark_depth",
        "chaos_fetch_fail", "chaos_spill_stall"])
def test_launcher_serves_with_tier_and_speculation(flags, want, capsys):
    """The A10 and A11 flags serve on the CPU: the drafters report their
    drafts, the host tier its spills and fetches, and a stalled spill falls
    back to preemption."""
    launch_serve.main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--batch-size", "2", "--max-new", "8",
                       "--max-len", "64", "--page-size", "16", "--prefill-chunk", "16", *flags])
    out = capsys.readouterr().out
    assert "served 3 requests, 24 tokens" in out and want in out, out


@pytest.mark.parametrize("flags,want", [
    (["--admission", "optimistic", "--pool-pages", "4", "--max-preemptions", "10"],
     "preemptions"),
    (["--chaos-step-fail", "2"], "served 3 requests, 24 tokens"),
], ids=["optimistic", "chaos_step_fail"])
def test_launcher_serves_under_pool_pressure_and_faults(flags, want, capsys, tmp_path):
    """The resilience flags serve on the CPU: an oversubscribed optimistic
    pool preempts and restores, and an injected step failure is retried
    (the metrics record one retry)."""
    out_path = tmp_path / "metrics.jsonl"
    launch_serve.main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--batch-size", "2", "--max-new", "8",
                       "--max-len", "64", "--page-size", "16", "--prefill-chunk", "16",
                       "--metrics-out", str(out_path), *flags])
    out = capsys.readouterr().out
    assert want in out and "served 3 requests, 24 tokens" in out
    records = [json.loads(line) for line in out_path.read_text().splitlines()]
    retries = [r["value"] for r in records if r["name"] == "serve.step_retries"]
    assert retries == [1.0 if "--chaos-step-fail" in flags else 0.0]


def test_launcher_serves_with_order_adaptation(capsys, tmp_path):
    """The order-adaptation and LLC flags (ported) serve on the CPU: the
    engine starts from the configured order, samples the modeled LLC and
    exports the adaptation series."""
    out_path = tmp_path / "metrics.jsonl"
    launch_serve.main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--batch-size", "2", "--max-new", "4",
                       "--max-len", "64", "--page-size", "8", "--attn-order", "auto",
                       "--adapt-epoch", "2", "--adapt-hysteresis", "0.1", "--adapt-confirm", "1",
                       "--autotune-cache", str(tmp_path / "none.jsonl"), "--llc-every", "2",
                       "--llc-capacity-mib", "0.5", "--metrics-out", str(out_path)])
    out = capsys.readouterr().out
    assert "order adaptation on: starting order=sawtooth (no autotune-cache hit)" in out
    assert "served 3 requests, 12 tokens" in out
    names = {json.loads(line)["name"] for line in out_path.read_text().splitlines()}
    assert {"serve.order_switches", "serve.current_order", "llc.samples",
            "llc.modeled_miss_bytes"} <= names


def test_launcher_auto_scheduler_needs_a_ported_family(capsys):
    """``auto`` picks as the reference does (continuous for olmoe-1b-7b,
    static for mixtral-8x7b, whose window the paged pool cannot hold, and
    for the static-only enc-dec and VLM families); every one serves 3
    requests."""
    assert launch_serve.pick_scheduler("auto", get_config("mixtral-8x7b")) == "static"
    assert launch_serve.pick_scheduler("auto", get_config("olmoe-1b-7b")) == "continuous"
    assert launch_serve.pick_scheduler("auto", get_config("deepseek-7b")) == "continuous"
    for arch in ("seamless-m4t-medium", "phi-3-vision-4_2b"):
        assert launch_serve.pick_scheduler("auto", get_config(arch)) == "static", arch
    for arch in ("mixtral-8x7b", "olmoe-1b-7b", "seamless-m4t-medium", "phi-3-vision-4_2b"):
        launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                           "--batch-size", "2", "--max-new", "4", "--max-len", "64",
                           "--page-size", "8"])
        assert "served 3 requests, 12 tokens" in capsys.readouterr().out, arch


@pytest.mark.parametrize("name", ["quickstart", "sawtooth_analysis", "train_lm", "serve_lm"])
def test_examples_refuse_to_run_without_a_gpu(name, no_cuda):
    """``python -m repro_torch.examples.<name>`` with neither a GPU nor
    ``--device cpu`` raises before it does any work on the CPU."""
    assert f"repro_torch.examples.{name}" in _modules()
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert "pass device='cpu' (or --device cpu)" in out.stderr, out.stderr[-2000:]
    assert out.stdout == ""
