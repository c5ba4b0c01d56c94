"""Reproduce the paper's analysis end-to-end in one script (text figures),
on the port's models: ``core/cache_model.py``, ``core/cache_sim.py`` and
``kernels/traffic.py``.

Produces the paper's core plots as ASCII tables:
  A. L2 sector model vs simulator across sequence lengths  (Fig 3/4)
  B. miss-vs-cold divergence sweep                          (Fig 5)
  C. hit rate vs active workers, with the 1-1/N law         (Fig 6)
  D. cyclic vs sawtooth misses + modelled throughput        (Fig 7-12)
  E. all three traversal orders (block_snake included) on the Fig 7-12
     model and on the backward dK/dV stream — the Traversal IR's
     capacity-bound regime (DESIGN.md §3)
  F. the port's flash forward (B2): its persistent walks through an LRU
     model of the card's L2, in both orders

  PYTHONPATH=src python -m repro_torch.examples.sawtooth_analysis
  PYTHONPATH=src python -m repro_torch.examples.sawtooth_analysis --quick   # CI smoke
  PYTHONPATH=src python -m repro_torch.examples.sawtooth_analysis --device cpu

``--quick`` scales the simulated geometries down ~4x (same code paths,
same qualitative deltas, a fraction of the pure-Python LRU replay cost).
Everything runs on the host; ``--device`` only names the card of section F:
on ``cuda`` its L2 size and SM count as ``torch.cuda.get_device_properties``
reports them, on ``cpu`` the data sheet's H100 (``cache_model.H100``).
"""

import argparse
import dataclasses

from repro_torch.core.cache_model import (
    GB10,
    H100,
    AttentionWorkload,
    calibrate_miss_service,
    cold_miss_sectors,
    device_hw_config,
    gb10_throughput_model,
    l2_sector_accesses,
)
from repro_torch.core.cache_sim import simulate_attention
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import kernel_traversal
from repro_torch.kernels.traffic import (
    FlashGridSpec,
    bwd_dkv_llc_model,
    fwd_llc_model,
    fwd_walk_llc_model,
)


def section(title):
    print(f"\n=== {title} " + "=" * max(0, 60 - len(title)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="~4x smaller simulated geometries (CI smoke)")
    ap.add_argument("--device", default="cuda",
                    help="the card of section F: cuda (default, read from the card) or cpu "
                         "(the data sheet's H100)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # scale factor for the big LRU replays; the cache sizes scale with the
    # workloads so every section stays in its intended regime.
    f = 4 if args.quick else 1

    section("A. sector-access model vs LRU simulator (T=80, D=64)")
    print(f"{'S':>8} {'model':>15} {'simulated':>15} {'err%':>7}")
    for s in (2048, 4096, 8192, 16384)[: 2 if args.quick else 4]:
        w = AttentionWorkload(seq_len=s, tile=80)
        sim = simulate_attention(w, GB10, "cyclic", n_workers=48)
        model = l2_sector_accesses(w, GB10)
        err = 100 * abs(model - sim.accesses) / sim.accesses
        print(f"{s:>8} {model:>15,.0f} {sim.accesses:>15,.0f} {err:>6.2f}%")

    section("B. divergence of misses from cold misses (1/8-scale L2)")
    hw = dataclasses.replace(GB10, cache_bytes=3 * 2**20 // f)
    print(f"{'S':>8} {'misses':>12} {'cold(16S)':>12} {'ratio':>6}")
    for s in (4096, 8192, 10240, 12288, 16384)[:: f if args.quick else 1]:
        w = AttentionWorkload(seq_len=s, tile=80)
        r = simulate_attention(w, hw, "cyclic", n_workers=48)
        cold = cold_miss_sectors(w, hw)
        print(f"{s:>8} {r.misses:>12,.0f} {cold:>12,.0f} {r.misses/cold:>6.2f}")

    section("C. hit rate vs N workers (overflow regime) vs 1 - 1/N")
    hw = dataclasses.replace(GB10, cache_bytes=2 * 2**20 // f)
    w = AttentionWorkload(seq_len=16384 // f, tile=64)
    print(f"{'N':>4} {'hit rate':>9} {'1-1/N':>7}")
    for n in (1, 2, 4, 8, 16, 48):
        r = simulate_attention(w, hw, "cyclic", n_workers=n)
        print(f"{n:>4} {r.hit_rate:>9.4f} {1 - 1/n:>7.4f}")

    section("D. cyclic vs sawtooth (1/2-scale CuTile geometry)")
    hw = dataclasses.replace(GB10, cache_bytes=12 * 2**20 // f)
    for causal in (False, True):
        w = AttentionWorkload(seq_len=65536 // f, tile=64, batch=4 // f or 1,
                              causal=causal)
        cyc = simulate_attention(w, hw, "cyclic", n_workers=48)
        saw = simulate_attention(w, hw, "sawtooth", n_workers=48)
        red = 100 * (1 - saw.misses / cyc.misses)
        base = 41e12 if causal else 61e12
        svc = calibrate_miss_service(
            w, hw, observed_flops=base, miss_sectors=cyc.misses, kernel_peak=74e12
        )
        pred = gb10_throughput_model(
            w, hw, saw.misses, miss_service_s=svc, kernel_peak=74e12
        )
        tag = "causal" if causal else "non-causal"
        print(
            f"{tag:>11}: misses {cyc.misses:,.0f} -> {saw.misses:,.0f} "
            f"({red:.1f}% less) | throughput {base/1e12:.0f} -> "
            f"{pred/1e12:.1f} TFLOPS (modelled)"
        )
    print("\npaper: ~67% miss reduction; 61->69 (non-causal), 41->66 (causal) TFLOPS")

    section("E. all three orders: Fig 7-12 model + backward dK/dV stream")
    # E1: the paper's GB10 geometry (causal, 1/2-scale CuTile), with
    # block_snake groups sized around the L2 capacity.
    hw = dataclasses.replace(GB10, cache_bytes=12 * 2**20 // f)
    w = AttentionWorkload(seq_len=65536 // f, tile=64, batch=4 // f or 1,
                          causal=True)
    orders = [("cyclic", None), ("sawtooth", None),
              ("block_snake", 16), ("block_snake", 64)]
    print("GB10 sim, causal 64k (non-compulsory miss sectors):")
    base = None
    for order, g in orders:
        r = simulate_attention(w, hw, order, n_workers=48, snake_group=g)
        if base is None:
            base = max(r.non_compulsory_misses, 1)
        tag = order if g is None else f"{order}(g={g})"
        print(f"  {tag:>18}: {r.non_compulsory_misses:>14,.0f} "
              f"({100 * (1 - r.non_compulsory_misses / base):+.1f}% vs cyclic)")

    # E2: the TPU-side capacity-bound forward wavefront (fwd_llc_model):
    # causal trimming desynchronizes the workers, sawtooth's full-range
    # reversals thrash the shared buffer, block_snake's bounded footprint
    # turns the spread back into hits.
    spec = FlashGridSpec(seq_q=8192, seq_kv=8192, q_block=128, kv_block=128,
                         causal=True)
    print("\nforward wavefront LLC model (causal 8k, 12 workers, 0.75x K+V "
          "capacity; non-compulsory MiB):")
    for order, g in orders + [("block_snake", 32)]:
        r = fwd_llc_model(spec, order, snake_group=g, n_workers=12,
                          capacity_frac=0.75)
        tag = order if g is None else f"{order}(g={g})"
        print(f"  {tag:>18}: {r.non_compulsory_misses / 2**20:>8.2f} MiB")

    # E3: the backward dK/dV stream (transposed grid — Q/dO streamed against
    # resident KV tiles). Sawtooth's whole-sweep reversal still rules the
    # per-worker regime; block_snake sits between the endpoints.
    print("\nbackward dK/dV wavefront LLC model (causal 8k, 4 workers, 0.5x "
          "Q+dO capacity; non-compulsory MiB):")
    spec_b = FlashGridSpec(seq_q=8192, seq_kv=8192, q_block=256, kv_block=256,
                           causal=True)
    for order, g in orders:
        r = bwd_dkv_llc_model(spec_b, order, snake_group=g, n_workers=4)
        tag = order if g is None else f"{order}(g={g})"
        print(f"  {tag:>18}: {r.non_compulsory_misses / 2**20:>8.2f} MiB")
    print("\ntakeaway: sawtooth wins the synchronized/per-worker regimes "
          "(pass-boundary reuse), block_snake wins once a finite shared "
          "LLC meets a desynchronized wavefront — size the group to the "
          "cache (hillclimb.py --sweep-orders).")

    # F: the port's B2 on the card's L2: one persistent CTA an SM, each
    # walking its (batch x kv head, Q tile) items in the kernel's order
    # (the walk B2 records in visit_out, chip_smoke.py holds it there).
    card = device_hw_config(dev) if dev.type == "cuda" else H100
    seq = 8192 // f
    section(f"F. B2's walks through {card.name}'s L2 ({card.cache_bytes / 2**20:.0f} MiB, "
            f"{card.n_workers} CTAs)")
    print(f"causal {seq}, 8 heads of 128 (GQA 1), B 1; at the L2 and a 1/32 of it "
          "(non-compulsory MiB):")
    out = {"card": {"name": card.name, "l2_bytes": card.cache_bytes, "sms": card.n_workers},
           "f": {}}
    for order in ("cyclic", "sawtooth"):
        tr = kernel_traversal(seq, seq, 1, kernel="flash_fwd", order=order, causal=True,
                              window=None)
        rs = fwd_walk_llc_model(tr, 8, card.n_workers,
                                capacities=[card.cache_bytes, card.cache_bytes / 32],
                                head_dim=128, seq_q=seq, seq_kv=seq)
        out["f"][order] = [r.non_compulsory_misses for r in rs]
        print(f"  {order:>18}: " + ", ".join(f"{r.non_compulsory_misses / 2**20:.2f}"
                                               for r in rs))
    return out


if __name__ == "__main__":
    main()
