"""End-to-end driver: train a small LM through the port.

The deepseek-7b family scaled down as the reference's example scales it (8
layers, d 512, 8 heads of 64, d_ff 2048, vocab 16k: 50.3 M params, which
the reference's docstring calls ~100M), on the port's production path:
synthetic packed data, AdamW with a cosine schedule, checkpoints and resume
(``train.loop.run_training``), sawtooth attention. On the card the
attention is the flash forward (B2) and the fused backward (B4-B6) at head
dim 64, which take bfloat16 only: activations are bf16 and params float32
(the reference's example runs float32 throughout). Remat is off, so a step
launches B2 once and each backward kernel once a layer.

  PYTHONPATH=src python -m repro_torch.examples.train_lm             # 300 steps
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 20
  PYTHONPATH=src python -m repro_torch.examples.train_lm --tiny --device cpu

``--tiny`` trains the reduced config (float32, head dim 16, which the
kernels do not take), on the CPU only. Re-running continues from the
newest checkpoint under ``--ckpt-dir`` (default
``checkpoints/train_lm_torch``), which ``serve_lm`` restores.
"""

from __future__ import annotations

import argparse
import logging

from repro_torch.configs import ParallelConfig, TrainConfig, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train.loop import run_training

DEFAULT_CKPT_DIR = "checkpoints/train_lm_torch"


def example_config(tiny: bool):
    """The example's config (50.3 M params), or with ``tiny`` deepseek-7b's
    reduced one."""
    base = get_config("deepseek-7b")
    if tiny:
        return base.reduced()
    return base.with_(
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=2048, vocab=16384, dtype="bfloat16", param_dtype="float32",
        remat="none", q_block=128, kv_block=128,
    )


def param_total(cfg) -> int:
    """Elements of the config's params, counted on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.train.optimizer import named_leaves

    with FakeTensorMode():
        params = build_model(cfg, device="cpu").init(0)
        return sum(t.numel() for _, t in named_leaves(params))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.tiny and dev.type != "cpu":
        ap.error("--tiny trains the reduced float32 config, which the kernels do not take: "
                 "pass --device cpu")

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = example_config(args.tiny)
    steps, seq = args.steps, args.seq
    if args.tiny:
        steps, seq = min(steps, 20), 128
    lm = build_model(cfg, device=dev)
    tcfg = TrainConfig(
        lr=3e-4,
        total_steps=steps,
        warmup_steps=max(steps // 20, 1),
        checkpoint_every=max(steps // 4, 1),
        checkpoint_dir=args.ckpt_dir,
    )
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=args.batch)
    res = run_training(lm, tcfg, ParallelConfig(), None, device=dev, steps=steps, data_cfg=dcfg)
    n_params = param_total(cfg)
    print(
        f"params={n_params/1e6:.1f}M steps={res.final_step + 1} "
        f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
        f"(resumed_from={res.resumed_from})"
    )
    return {"cfg": cfg, "steps": steps, "seq": seq, "batch": args.batch, "params": n_params,
            "result": res}


if __name__ == "__main__":
    main()
