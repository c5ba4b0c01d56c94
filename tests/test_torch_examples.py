"""The port's four examples (``repro_torch.examples``) on the CPU.

Each runs through its ``main(argv)`` with ``--device cpu``: quickstart
(cyclic and sawtooth equal up to the sum order, the plain version against
the reference impl, the walk model), sawtooth_analysis ``--quick``,
train_lm ``--tiny`` (a few steps, then a resume) and serve_lm ``--reduced``
restoring the checkpoint train_lm wrote, or refusing one that does not fit.
"""

import pytest

pytest.importorskip("torch")

import torch

from repro_torch.configs import get_config
from repro_torch.examples import quickstart, sawtooth_analysis, serve_lm, train_lm
from repro_torch.models import build_model
from repro_torch.train.checkpoint import save_pytree

torch.set_num_threads(1)


def test_quickstart_on_the_cpu(capsys):
    out = quickstart.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert out["impl"] == "torch" and not any(out["launches"].values())
    # bf16 outputs of one math in two sum orders, and against the oracle
    assert 0 < out["sawtooth_vs_cyclic"] < 2e-2
    assert out["kernel_vs_reference"] < 2e-2
    assert out["gb10_reduction_pct"] > 40
    walks = out["walks"]
    assert walks["cyclic"]["read_bytes"] == walks["sawtooth"]["read_bytes"] > 0
    assert walks["sawtooth"]["non_compulsory_bytes"] == 0  # 512 positions fit the L2
    assert "[3] sawtooth: B2's walk (of the host model" in printed


def test_sawtooth_analysis_quick(capsys):
    out = sawtooth_analysis.main(["--quick", "--device", "cpu"])
    printed = capsys.readouterr().out
    for section in "ABCDEF":
        assert f"=== {section}. " in printed, section
    assert out["card"]["l2_bytes"] == 50 * 2**20 and out["card"]["sms"] == 132
    # at the whole L2 both orders miss only compulsory bytes; at 1/32 of it
    # the sawtooth walk keeps more of its pass boundaries
    assert out["f"]["cyclic"][0] == out["f"]["sawtooth"][0] == 0
    assert out["f"]["sawtooth"][1] < out["f"]["cyclic"][1]


def test_train_lm_then_serve_lm(tmp_path, capsys):
    """train_lm --tiny trains, re-running resumes from its checkpoint, and
    serve_lm --reduced restores that checkpoint and serves 12 requests."""
    ck = str(tmp_path / "ck")
    first = train_lm.main(["--tiny", "--device", "cpu", "--steps", "4", "--batch", "2",
                           "--ckpt-dir", ck])
    res = first["result"]
    assert res.resumed_from is None and res.final_step == 3 and not res.interrupted
    assert first["params"] > 0
    again = train_lm.main(["--tiny", "--device", "cpu", "--steps", "6", "--batch", "2",
                           "--ckpt-dir", ck])
    assert again["result"].resumed_from == 3 and again["result"].final_step == 5
    capsys.readouterr()

    served = serve_lm.main(["--reduced", "--device", "cpu", "--ckpt-dir", ck,
                            "--requests", "12", "--max-new", "6"])
    printed = capsys.readouterr().out
    assert f"restored params from {ck} step 5" in printed
    assert served["restored_step"] == 5 and served["scheduler"] == "continuous"
    assert len(served["results"]) == 12 and {r.status for r in served["results"]} == {"ok"}
    assert served["tokens"] == 12 * 6

    other = serve_lm.main(["--reduced", "--device", "cpu", "--ckpt-dir", ck,
                           "--arch", "mamba2-130m", "--requests", "2", "--max-new", "2"])
    printed = capsys.readouterr().out
    assert "checkpoint incompatible with this config; using random init" in printed
    assert other["restored_step"] is None and other["scheduler"] == "static"


def test_serve_lm_refuses_a_checkpoint_of_other_shapes(tmp_path):
    """A checkpoint with every leaf of the served config but one of another
    shape lands in the random-init branch rather than crash later."""
    lm = build_model(get_config("deepseek-7b").reduced(), device="cpu")
    params = lm.init(0)
    save_pytree({"params": params}, str(tmp_path), 0)
    restored, step = serve_lm.restore_matching(params, str(tmp_path))
    assert step == 0 and torch.equal(restored["embed"]["table"], params["embed"]["table"])
    wide = dict(params, ln_f={"scale": torch.ones(params["ln_f"]["scale"].shape[0] + 1)})
    save_pytree({"params": wide}, str(tmp_path), 1)
    assert serve_lm.restore_matching(params, str(tmp_path)) is None
    assert serve_lm.restore_matching(params, str(tmp_path / "none")) is None


@pytest.mark.parametrize("argv,flag", [
    (["--tiny"], "--tiny"), (["--reduced"], "--reduced")], ids=["train_lm", "serve_lm"])
def test_cpu_only_configs_refuse_the_card(argv, flag, monkeypatch, capsys):
    """The reduced float32 configs (head dim 16) are refused on the card,
    which the kernels would reject."""
    import repro_torch.examples.serve_lm as S
    import repro_torch.examples.train_lm as T

    mod = T if flag == "--tiny" else S
    monkeypatch.setattr(mod, "resolve_device", lambda d: torch.device("cuda"))
    with pytest.raises(SystemExit) as exc:
        mod.main(argv)
    assert exc.value.code == 2 and "--device cpu" in capsys.readouterr().err
