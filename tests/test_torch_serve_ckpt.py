"""The serve launcher's ``--ckpt-dir`` (ROADMAP A12).

* A round trip in the port: ``repro_torch.launch.train`` trains a
  ``.reduced()`` config on the CPU and checkpoints; ``repro_torch.launch.serve
  --ckpt-dir`` restores the newest step's params and serves them, with the
  streams of an engine given those params directly.
* A checkpoint the JAX package wrote (``repro.train.checkpoint.save_pytree``
  of params from another key than the launchers' seed): both launchers
  serve it with ``--ckpt-dir``, and their greedy streams are equal, token
  for token.
* A directory with no checkpoint serves the seed's params, as in the
  reference.
"""

import re
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_launch_serve
from repro.models import build_model as ref_build_model
from repro.train import checkpoint as ref_ckpt
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.checkpoint import latest_step, restore_pytree

torch.set_num_threads(1)

SERVE = ["--arch", "deepseek-7b", "--reduced", "--requests", "3", "--batch-size", "2",
         "--max-new", "5", "--max-len", "64", "--page-size", "8"]


def _streams(out: str) -> dict:
    return {int(m.group(1)): m.group(2) for m in re.finditer(r"rid=(\d+) -> (\[.*\])", out)}


def test_train_then_serve_from_the_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    launch_train.main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu", "--steps", "3",
                       "--batch", "2", "--seq", "32", "--lr", "3e-2", "--ckpt-dir", ck])
    assert "interrupted=False" in capsys.readouterr().out
    assert latest_step(ck) == 2
    launch_serve.main(SERVE + ["--device", "cpu", "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert "restored params from step 2" in out and "served 3 requests, 15 tokens" in out

    lm = build_model(get_config("deepseek-7b").reduced(), device="cpu")
    params, _ = restore_pytree({"params": lm.init(0)}, ck)
    rng = np.random.default_rng(0)
    reqs = [Request(tokens=rng.integers(2, lm.cfg.vocab, size=rng.integers(4, 32)).astype(np.int32),
                    max_new_tokens=5, rid=i) for i in range(3)]
    eng = ServeEngine(lm, params["params"], batch_size=2, max_len=64, scheduler="continuous",
                      page_size=8, device="cpu")
    want = {r.rid: str(r.tokens.tolist()) for r in eng.generate(reqs)}
    assert _streams(out) == want

    launch_serve.main(SERVE + ["--device", "cpu"])
    seed_out = capsys.readouterr().out
    assert "restored" not in seed_out and _streams(seed_out) != want  # the training moved them


def test_a_jax_checkpoint_serves_the_reference_streams(tmp_path, capsys, monkeypatch):
    ck = str(tmp_path / "jax_ck")
    rlm = ref_build_model(ref_get_config("deepseek-7b").reduced())
    ref_ckpt.save_pytree({"params": rlm.init(jax.random.PRNGKey(7))}, ck, 4)

    monkeypatch.setattr(sys, "argv", ["serve"] + SERVE + ["--ckpt-dir", ck])
    ref_launch_serve.main()
    ref_out = capsys.readouterr().out
    launch_serve.main(SERVE + ["--device", "cpu", "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert "restored params from step 4" in ref_out and "restored params from step 4" in out
    want = _streams(ref_out)
    assert len(want) == 3 and _streams(out) == want


def test_an_empty_ckpt_dir_serves_the_seed(tmp_path, capsys):
    launch_serve.main(SERVE + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "none")])
    with_dir = capsys.readouterr().out
    launch_serve.main(SERVE + ["--device", "cpu"])
    without = capsys.readouterr().out
    assert "restored" not in with_dir and _streams(with_dir) == _streams(without)
