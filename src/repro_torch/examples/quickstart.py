"""Quickstart: the paper's technique in a few lines, on the port.

1. Run a flash-attention problem with cyclic and with sawtooth KV
   scheduling through ``ops.attention`` (identical up to the order of the
   softmax's float32 sums: the schedule is a locality change), and hold the
   kernel to the full-materialization ``reference`` impl.
2. Reproduce the paper's core claim on the GB10 cache simulator.
3. Show the walk the flash forward's persistent CTAs take: recorded by the
   kernel on the card (``visit_out``), held to the host model
   (``flash_attention.fwd_walks``), and played through the LRU model of the
   card's L2 (``kernels.traffic.fwd_walk_llc_model``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart            # the card
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

On the card part 1 runs the CUDA kernel (B2, ``impl="cuda"``) at (2, 512,
8/2, 64) in bf16; on the CPU its plain version (``impl="torch"``), and part
3 plays the host model's walk, since only the kernel records one.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.core.cache_model import GB10, H100, AttentionWorkload, device_hw_config
from repro_torch.core.cache_sim import simulate_attention
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda_lib, ops
from repro_torch.kernels.flash_attention import (
    flash_attention_fwd,
    fwd_walks,
    fwd_workers,
    kernel_traversal,
)
from repro_torch.kernels.traffic import fwd_walk_llc_model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    impl = "cuda" if dev.type == "cuda" else "torch"
    out: dict = {"device": str(dev), "impl": impl}
    cuda_lib.reset_launch_counts()

    # --- 1. sawtooth is output-preserving ---------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((2, 512, 8, 64), (2, 512, 2, 64), (2, 512, 2, 64)))
    out_cyc = ops.attention(q, k, v, order="cyclic", causal=True, impl=impl)
    out_saw = ops.attention(q, k, v, order="sawtooth", causal=True, impl=impl)
    out["sawtooth_vs_cyclic"] = float((out_cyc.float() - out_saw.float()).abs().max())
    print(f"[1] sawtooth vs cyclic max |diff| = {out['sawtooth_vs_cyclic']:.2e}  "
          f"({impl}; the same math in another sum order)")
    out_ref = ops.attention(q, k, v, order="sawtooth", causal=True, impl="reference")
    out["kernel_vs_reference"] = float((out_saw.float() - out_ref.float()).abs().max())
    print(f"[1] {impl} vs the full-materialization reference max |diff| = "
          f"{out['kernel_vs_reference']:.2e}")

    # --- 2. the paper's claim on the GB10 L2 simulator ----------------------
    # (scaled geometry: KV = 4 MiB against a 3 MiB L2, the overflow ratio of
    # the paper's 128K-token experiment)
    hw = dataclasses.replace(GB10, cache_bytes=3 * 2**20)
    w = AttentionWorkload(seq_len=16384, tile=64)
    cyc = simulate_attention(w, hw, "cyclic", n_workers=48)
    saw = simulate_attention(w, hw, "sawtooth", n_workers=48)
    out["gb10_reduction_pct"] = 100 * (1 - saw.non_compulsory_misses / cyc.non_compulsory_misses)
    print(f"[2] GB10 sim: non-compulsory misses {cyc.non_compulsory_misses:,.0f} -> "
          f"{saw.non_compulsory_misses:,.0f}  ({out['gb10_reduction_pct']:.0f}% reduction; "
          "paper: ~50%)")

    # --- 3. the flash forward's walk through the card's L2 ------------------
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    card = device_hw_config(dev) if dev.type == "cuda" else H100
    workers = fwd_workers(dev) if dev.type == "cuda" else H100.n_workers
    out["walks"] = {}
    for order in ("cyclic", "sawtooth"):
        tr = kernel_traversal(s, s, hq // hkv, kernel="flash_fwd", order=order, causal=True,
                              window=None)
        want = torch.tensor(fwd_walks(tr, b * hkv, workers), dtype=torch.int32)
        if dev.type == "cuda":
            visit = torch.empty(want.shape, dtype=torch.int32, device=dev)
            flash_attention_fwd(q, k, v, order=order, causal=True, visit_out=visit)
            if not torch.equal(visit.cpu(), want):
                raise AssertionError(f"B2's recorded {order} walk differs from fwd_walks")
        (r,) = fwd_walk_llc_model(tr, b * hkv, workers, capacities=[card.cache_bytes],
                                  head_dim=d, seq_q=s, seq_kv=s)
        out["walks"][order] = {"read_bytes": r.accesses, "miss_bytes": r.misses,
                               "non_compulsory_bytes": r.non_compulsory_misses}
        src = "recorded on the card, equal to" if dev.type == "cuda" else "of"
        print(f"[3] {order}: B2's walk ({src} the host model, {workers} CTAs) through "
              f"{card.name}'s {card.cache_bytes / 2**20:.0f} MiB L2: {r.accesses / 2**20:.2f} MiB "
              f"read, {r.misses / 2**20:.2f} MiB missed, {r.non_compulsory_misses / 2**20:.2f} MiB "
              "of it non-compulsory")
    out["launches"] = dict(cuda_lib.launch_counts)
    return out


if __name__ == "__main__":
    main()
