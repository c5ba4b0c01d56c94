"""Training launcher: train a model from a seed on synthetic packed data
through the port's fault-tolerant loop.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --reduced --device cpu --steps 4 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --optimizer adamw_factored --layers 2 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2_7b \\
      --optimizer adamw_factored --batch 4 --seq 1024 --steps 4 --ckpt-dir /tmp/ck

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --reduced --device cpu --steps 4 --mesh 2x2 --microbatches 2 --ckpt-dir /tmp/ck

Every family trains: dense, MoE, SSM (mamba2-130m), hybrid (zamba2-2_7b),
enc-dec and VLM, with the config's ``remat`` (``none``, ``full`` or
``dots``).

The flags are the JAX launcher's (``repro.launch.train``) plus ``--device``
(default ``cuda``; with no GPU the launcher raises unless ``--device cpu``
is given). ``--mesh`` takes ``DxM``, ``production`` (16x16) or
``multipod`` (2x16x16), with the reference's
``ParallelConfig(fsdp_axes=("data",), data_axes=("data",))``. A mesh of
more than one rank runs as that many processes: started here, each joins
a process group (gloo on the CPU, NCCL with one card a rank) on a
``FileStore`` in a temporary directory, and rank 0 prints and writes the
checkpoints; a process that already belongs to a group of the right size
(its own launcher's) builds the mesh over it. ``1x1`` outside a group
trains on the one device without a mesh, which gives the same numbers.
``--attn-impl`` takes the port's impls. Re-running the same command
resumes from the newest checkpoint.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import tempfile

from repro_torch.configs import ParallelConfig, TrainConfig, get_config
from repro_torch.core.schedule import Order
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh, production_mesh_shape
from repro_torch.models import build_model
from repro_torch.train.fault_tolerance import FailureInjector
from repro_torch.train.loop import run_training


def mesh_shape(s: str) -> tuple:
    """``DxM``, ``production`` or ``multipod`` -> the mesh's shape."""
    if s in ("production", "multipod"):
        return tuple(production_mesh_shape(multi_pod=s == "multipod").shape.values())
    parts = s.split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise SystemExit(f"--mesh {s!r}: must be DxM, 'production', or 'multipod'")
    return tuple(int(p) for p in parts)


def parse_mesh(s: str, device: str):
    """The ``DeviceMesh`` of ``--mesh`` over the process group, or None for
    ``1x1`` outside one (one device, no mesh)."""
    import torch.distributed as dist

    if mesh_shape(s) == (1, 1) and not dist.is_initialized():
        return None
    if s == "production":
        return make_production_mesh(device=device)
    if s == "multipod":
        return make_production_mesh(multi_pod=True, device=device)
    return make_local_mesh(*mesh_shape(s), device=device)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=None, help="override width")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM, 'production' (16x16) or 'multipod' (2x16x16); more than one "
                         "rank runs as that many processes")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adamw_factored"])
    ap.add_argument("--attn-order", default="sawtooth", choices=[o.value for o in Order],
                    help="KV traversal order (core/schedule.py Traversal)")
    ap.add_argument("--snake-group", type=int, default=None,
                    help="block_snake reversal window in KV tiles")
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "cuda", "torch", "reference", "recompute"],
                    help="attention impl: the CUDA kernels (forward and fused backward), "
                         "the plain PyTorch versions, the full-materialization oracle, or "
                         "'recompute' (the plain forward, differentiated again in the "
                         "backward: the JAX launcher's 'jnp')")
    ap.add_argument("--bwd-q-block", type=int, default=None,
                    help="plain fused-backward q tile (default: q_block)")
    ap.add_argument("--bwd-kv-block", type=int, default=None,
                    help="plain fused-backward kv tile (default: kv_block)")
    ap.add_argument("--crash-at", type=int, default=None, help="inject a failure at this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics registry as JSONL here")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write step/checkpoint spans as Chrome-trace JSON")
    return ap.parse_args(argv)


def _worker(rank: int, world: int, store_path: str, argv) -> None:
    """One rank of a launched mesh: join the group, train, leave."""
    import torch
    import torch.distributed as dist

    args = parse_args(argv)
    kw = {}
    if args.device != "cpu":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group("gloo" if args.device == "cpu" else "nccl",
                            store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, **kw)
    try:
        train(args)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    import torch.distributed as dist
    import torch.multiprocessing as mp

    args = parse_args(argv)
    shape = mesh_shape(args.mesh)
    world = 1
    for n in shape:
        world *= n
    if world > 1 and not dist.is_initialized():
        store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_train_"), "store")
        argv = sys.argv[1:] if argv is None else list(argv)
        mp.spawn(_worker, args=(world, store, argv), nprocs=world)
        return
    train(args)


def train(args) -> None:
    """Train by ``args`` in this process (one rank of the mesh, if any)."""
    import torch.distributed as dist

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    mesh = parse_mesh(args.mesh, "cpu" if args.device == "cpu" else "cuda")
    lead = not dist.is_initialized() or dist.get_rank() == 0

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    overrides = {"attn_order": args.attn_order, "snake_group": args.snake_group}
    if args.attn_impl:
        overrides.update(attn_impl=args.attn_impl)
    if args.bwd_q_block:
        overrides.update(bwd_q_block=args.bwd_q_block)
    if args.bwd_kv_block:
        overrides.update(bwd_kv_block=args.bwd_kv_block)
    if args.d_model:
        overrides.update(d_model=args.d_model)
    if args.layers:
        overrides.update(n_layers=args.layers)
    cfg = cfg.with_(**overrides)

    lm = build_model(cfg, device=args.device)
    tcfg = TrainConfig(
        lr=args.lr,
        total_steps=args.steps,
        warmup_steps=max(args.steps // 20, 1),
        checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir,
        optimizer=args.optimizer,
        seed=args.seed,
    )
    pcfg = ParallelConfig(fsdp_axes=("data",), data_axes=("data",),
                          microbatches=args.microbatches)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=args.seed)
    injector = FailureInjector(crash_at=(args.crash_at,)) if args.crash_at else None
    res = run_training(lm, tcfg, pcfg, mesh, device=args.device, steps=args.steps,
                       data_cfg=dcfg, injector=injector)
    if not lead:
        return
    print(
        f"done: final_step={res.final_step} resumed_from={res.resumed_from} "
        f"first_loss={res.losses[0] if res.losses else None} "
        f"last_loss={res.losses[-1] if res.losses else None} "
        f"interrupted={res.interrupted}"
    )
    if args.metrics_out and res.registry is not None:
        from repro_torch.obs import write_metrics_jsonl

        n = write_metrics_jsonl(res.registry, args.metrics_out, extra={"arch": args.arch})
        print(f"wrote {n} metric series -> {args.metrics_out}")
    if args.trace_out and res.tracer is not None:
        res.tracer.write(args.trace_out)
        print(f"wrote {len(res.tracer.events())} trace events -> {args.trace_out}")


if __name__ == "__main__":
    main()
