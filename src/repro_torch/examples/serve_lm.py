"""Serving example: batched generation through the port's ServeEngine.

Restores the checkpoint ``train_lm`` writes where its params fit the
served config, so the two examples compose into train -> serve; where they
do not (another arch or size), it says so and serves random weights.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm                 # deepseek-7b
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --scheduler static
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mamba2-130m
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --reduced --device cpu

On the card it serves the full-size config: deepseek-7b continuously on
the paged kernel (B1), ``--scheduler static`` on the flash forward (B2) and
the contiguous decode (B3), mamba2-130m on the SSD scan (B7). ``--reduced``
(head dim 16, float32, which the kernels do not take) runs on the CPU only;
the reference's example serves the reduced config by default.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.examples.train_lm import DEFAULT_CKPT_DIR
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine, supports_continuous
from repro_torch.train.checkpoint import latest_step, restore_pytree
from repro_torch.train.optimizer import named_leaves


def restore_matching(params: dict, ckpt_dir: str):
    """(params, step) from the newest checkpoint under ``ckpt_dir``, each
    leaf in the dtype of ``params``'s; None where there is none or it does
    not hold a leaf of every path and shape of ``params``."""
    if latest_step(ckpt_dir) is None:
        return None
    try:
        state, step = restore_pytree({"params": params}, ckpt_dir)
    except (KeyError, ValueError):  # a missing leaf, or stacks of another depth
        return None
    got = dict(named_leaves(state["params"]))
    for path, want in named_leaves(params):
        if path not in got or got[path].shape != want.shape:
            return None
    return _cast_like(state["params"], params), step


def _cast_like(tree, like):
    if isinstance(like, dict):
        return {k: _cast_like(tree[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [_cast_like(t, v) for t, v in zip(tree, like)]
    return tree.to(like.dtype)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (float32, head dim 16): --device cpu only")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--attn-order", default="sawtooth")
    ap.add_argument(
        "--scheduler", default="auto", choices=["auto", "static", "continuous"]
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.reduced and dev.type != "cpu":
        ap.error("--reduced serves a float32 config of head dim 16, which the kernels do not "
                 "take: pass --device cpu")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.with_(attn_order=args.attn_order)
    lm = build_model(cfg, device=dev)
    params = lm.init(0)
    restored_step = None
    if latest_step(args.ckpt_dir) is not None:
        restored = restore_matching(params, args.ckpt_dir)
        if restored is None:
            print("checkpoint incompatible with this config; using random init")
        else:
            params, restored_step = restored
            print(f"restored params from {args.ckpt_dir} step {restored_step}")

    scheduler = args.scheduler
    if scheduler == "auto":
        scheduler = "continuous" if supports_continuous(cfg) else "static"
    print(f"scheduler: {scheduler}")
    eng = ServeEngine(lm, params, batch_size=4, max_len=256, scheduler=scheduler, device=dev)
    rng = np.random.default_rng(0)
    reqs = [
        Request(
            tokens=rng.integers(2, cfg.vocab, size=int(rng.integers(4, 24))).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=0.7 if i % 2 else 0.0,
            rid=i,
        )
        for i in range(args.requests)
    ]
    t0 = time.time()
    results = eng.generate(reqs)
    dt = time.time() - t0
    total = sum(r.steps for r in results)
    print(f"served {len(results)} requests / {total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s)")
    for r in results[:4]:
        print(f"  rid={r.rid}: {r.tokens.tolist()}")
    return {"cfg": cfg, "scheduler": scheduler, "results": results, "stats": eng.last_stats,
            "graphs": eng.compiled_step_count(), "tokens": total, "seconds": dt,
            "restored_step": restored_step}


if __name__ == "__main__":
    main()
