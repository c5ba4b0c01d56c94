#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

  python3 chip_smoke.py [--profile]

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi), the kernels'
   build from ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
2. kernel matrix: the paged-attention CUDA kernel against its plain PyTorch
   version on the card, over orders x GQA x chunk widths x page sizes x
   windows, with ragged q_lens, a free row and a shuffled block table;
3. main path: full-width deepseek-7b (random weights from a seed) served by
   the continuous ServeEngine, with the kernel's launch count checked
   against layers x mixed steps; then a small bf16 model whose logits with
   the kernel must agree with the plain version's; with ``--profile`` half
   of the main path's requests run once more under torch.profiler, which
   gives the device's busy and idle share and its time by kind of kernel;
4. kernel times at the main path's shapes (one narrow and one wide step):
   the kernel, its bound, the plain version and one library call;
5. the JSON line of kernels, then the last line
   ``{"ok": true, "device": {...}}``.

It needs a GPU (``torch.cuda.is_available()``) and the repository's ``src``
beside it, and exits non-zero without either. It never runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_TOL = 2e-2        # abs, bf16 outputs vs the plain version in f32
SMALL_MODEL_TOL = 5e-2   # abs on logits of the small bf16 model

# Data-sheet peaks by card name: (bytes/s, dense bf16 flop/s).
_PEAKS = (
    ("H100 PCIe", 2.0e12, 756e12),
    ("H100 NVL", 3.9e12, 835e12),
    ("H100", 3.35e12, 989e12),   # SXM
)


def _port():
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {__file__}")
    sys.path.insert(0, str(src))


def _median_ms(fn, warmup: int = 5, reps: int = 30) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---- phase 1 ------------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    match = next(((b, p) for key, b, p in _PEAKS if key in name), None)
    if match is None:
        raise SystemExit(f"chip_smoke: no data-sheet peaks for {name!r}; add them to _PEAKS")
    bw, peak = match
    print(f"[device] {name}; bound uses {bw / 1e12:.2f} TB/s and {peak / 1e12:.0f} "
          "TFLOP/s bf16 dense (data sheet)")
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    built = cuda_lib.build_all(verbose=True)
    wall = time.perf_counter() - t0
    for kname, info in built.items():
        print(f"[build] {kname}: {info['seconds']:.1f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[build]   {line.strip()}")
    print(f"[build] all kernels in {wall:.1f} s (parallel nvcc)")
    return {"smi": smi, "name": name, "bw": bw, "peak": peak}


# ---- phase 2 ------------------------------------------------------------------


def _case(gen, *, b_lens, q_lens, c, hq, hkv, d, page, max_len):
    dev = "cuda"
    b = len(b_lens)
    nb = -(-max_len // page)
    n_pages = b * nb + 1
    bf = torch.bfloat16
    k = torch.randn((n_pages, page, hkv, d), generator=gen, device=dev).to(bf)
    v = torch.randn((n_pages, page, hkv, d), generator=gen, device=dev).to(bf)
    q = torch.randn((b, c, hq, d), generator=gen, device=dev).to(bf)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)[: b * nb] + 1
    bt = perm.reshape(b, nb).to(torch.int32)
    lens = torch.tensor(b_lens, dtype=torch.int32, device=dev)
    qls = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    return q, k, v, bt, lens, qls


def _check_kernel(q, k, v, bt, lens, qls, window, group) -> float:
    from repro_torch.core.attention import paged_decode_attention
    from repro_torch.kernels.flash_decode import paged_flash_decode_fwd

    out = paged_flash_decode_fwd(q, k, v, lens, bt, q_lens=qls, window=window, order_group=group)
    ref = paged_decode_attention(
        q.float(), k.float(), v.float(), lens, bt, q_lens=qls, window=window, order_group=group
    )
    torch.cuda.synchronize()
    c = q.shape[1]
    valid = (torch.arange(c, device="cuda")[None, :] < qls[:, None].long())  # (B, C)
    valid &= lens[:, None] > 0
    o = out.float()
    if not torch.isfinite(o).all():
        raise AssertionError("kernel output has non-finite values")
    zero_rows = o[~valid]
    if zero_rows.numel() and zero_rows.abs().max().item() != 0.0:
        raise AssertionError("rows with nothing to attend to are not exact zeros")
    err = (o - ref).abs()[valid].max().item() if valid.any() else 0.0
    return err


def phase_kernel_matrix() -> float:
    from repro_torch.core.schedule import Order, resolve_order_group

    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst, n = 0.0, 0
    max_len, hkv, d = 1024, 4, 128
    for page in (64, 512):
        nb = max_len // page
        for g in (1, 4):
            for c in (1, 7, 256):
                b_lens = [1024, 613, 37, 200, 0]
                q_lens = [c, c // 2 + 1, min(c, 37), 0, 0]
                q, k, v, bt, lens, qls = _case(
                    gen, b_lens=b_lens, q_lens=q_lens, c=c, hq=hkv * g, hkv=hkv, d=d,
                    page=page, max_len=max_len,
                )
                for order in Order:
                    group = resolve_order_group(order, 3, nb)
                    for window in (None, 100):
                        err = _check_kernel(q, k, v, bt, lens, qls, window, group)
                        n += 1
                        ok = err <= KERNEL_TOL
                        print(f"[kernel] page={page} G={g} C={c} order={order.value} "
                              f"window={window}: max_abs_err={err:.3e} "
                              f"{'ok' if ok else 'FAIL'}")
                        if not ok:
                            raise AssertionError(
                                f"paged_decode disagrees with its plain version: "
                                f"{err:.3e} > {KERNEL_TOL}"
                            )
                        worst = max(worst, err)
    print(f"[kernel] {n} cases, worst max_abs_err={worst:.3e} (tol {KERNEL_TOL})")
    return worst


# ---- phase 3 ------------------------------------------------------------------


def _main_requests(vocab: int, seed: int = 0):
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    prefix = rng.integers(2, vocab, size=128).astype(np.int32)
    lens = np.linspace(100, 700, 12).astype(int)
    reqs = []
    for i, n in enumerate(lens):
        body = rng.integers(2, vocab, size=int(n)).astype(np.int32)
        if i % 3 != 2:  # 8 of 12 share the 128-token prefix
            body = np.concatenate([prefix, body[128:]]) if n > 128 else prefix[:n].copy()
        # eos_id -1 never matches: every request runs to its token limit.
        reqs.append(Request(tokens=body, max_new_tokens=32, rid=i, eos_id=-1))
    return reqs


def phase_main_path(profile: bool = False) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("deepseek-7b")
    t0 = time.perf_counter()
    lm = build_model(cfg, device="cuda")
    params = lm.init(0)
    torch.cuda.synchronize()
    n_params = sum(
        t.numel() for t in _leaves(params)
    )
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {n_params / 1e9:.2f} B params "
          f"({cfg.param_dtype}), init {time.perf_counter() - t0:.1f} s")
    eng = ServeEngine(lm, params, batch_size=8, max_len=1024, page_size=64, device="cuda")

    # Every logit the engine computes is checked for NaN/inf on the device.
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    inner = eng.lm.decode_step

    def checked(p, tokens, caches):
        logits, caches = inner(p, tokens, caches)
        bad.add_((~torch.isfinite(logits)).sum())
        return logits, caches

    eng.lm = dataclasses.replace(eng.lm, decode_step=checked)

    # Warm-up (cuBLAS handles, allocator); not part of the measured run.
    rng = np.random.default_rng(99)
    eng.generate([Request(tokens=rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                          max_new_tokens=2, eos_id=-1) for n in (300, 20)])

    reqs = _main_requests(cfg.vocab)
    eng.tracer.clear()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.launch_counts)
    stats = eng.last_stats

    statuses = [r.status for r in results]
    assert all(s == "ok" for s in statuses), statuses
    assert all(r.steps == 32 and len(r.tokens) == 32 for r in results), [r.steps for r in results]
    assert int(bad.item()) == 0, f"{int(bad.item())} non-finite logits"
    assert eng.compiled_step_count() <= 2, eng.compiled_step_count()
    assert stats.pages_adopted > 0, stats
    want = cfg.n_layers * stats.mixed_steps
    assert launches["paged_decode"] == want, (launches, want)

    tokens = sum(r.steps for r in results)
    steps_by_width: dict[str, list] = {"narrow": [], "wide": []}
    for ev in eng.tracer.events():
        if ev.name == "serve.device_step":
            key = "narrow" if ev.args["width"] == 1 else "wide"
            steps_by_width[key].append(ev.dur_ns / 1e6)
    ttft = float(np.median([r.ttft_s for r in results]))
    tpot = float(np.nanmedian([r.tpot_s for r in results]))
    out = {
        "requests": len(results),
        "tokens": tokens,
        "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_p50_s": ttft,
        "tpot_p50_s": tpot,
        "mixed_steps": stats.mixed_steps,
        "wide_steps": stats.wide_steps,
        "pages_adopted": stats.pages_adopted,
        "cow_forks": stats.cow_forks,
        "step_ms_narrow_mean": float(np.mean(steps_by_width["narrow"])) if steps_by_width["narrow"] else None,
        "step_ms_wide_mean": float(np.mean(steps_by_width["wide"])) if steps_by_width["wide"] else None,
        "launches": launches,
        "launches_per_step": launches["paged_decode"] / max(stats.mixed_steps, 1),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("[serve] " + json.dumps(out))
    if profile:
        phase_profile(eng, cfg)
    del eng, params, lm
    torch.cuda.empty_cache()
    return out


def _kernel_kind(name: str) -> str:
    if "paged_decode" in name:
        return "paged_decode"
    if any(k in name.lower() for k in ("gemm", "gemv", "xmma", "nvjet", "cutlass", "splitk")):
        return "matmul"
    return "other"


def phase_profile(eng, cfg) -> dict:
    """Half of the main path's requests (16 new tokens each, to keep the
    trace small) under torch.profiler: device busy time (the union of kernel
    intervals) against the host's wall time, and device time by kind of
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reqs = [dataclasses.replace(r, max_new_tokens=16) for r in _main_requests(cfg.vocab)[:6]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_kind: dict[str, list] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        for table, key in ((by_kind, _kernel_kind(e.name)), (by_name, e.name[:90])):
            acc = table.setdefault(key, [0.0, 0])
            acc[0] += dur / 1e6
            acc[1] += 1
    steps = eng.last_stats.mixed_steps
    out = {
        "wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "mixed_steps": steps,
        "kernels": len(kernels),
        "kernels_per_step": len(kernels) / max(steps, 1),
        "by_kind_s": {k: v[0] for k, v in by_kind.items()},
        "by_kind_launches": {k: v[1] for k, v in by_kind.items()},
        "top": sorted(([k, v[0], v[1]] for k, v in by_name.items()), key=lambda r: -r[1])[:12],
    }
    print("[profile] " + json.dumps(out))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_small_model() -> float:
    """A small bf16 model (head dim 64, GQA 4:2): logits of one prefill chunk
    and 8 decode steps with the kernel against the plain version, both fed
    the same tokens and caches built the same way."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import page_geometry

    base = get_config("deepseek-7b").reduced().with_(
        dtype="bfloat16", param_dtype="bfloat16", d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512, vocab=1024, kv_layout="paged", page_size=16,
    )
    worst = 0.0
    runs = {}
    for impl in ("cuda", "torch"):
        cfg = base.with_(attn_impl=impl)
        lm = build_model(cfg, device="cuda")
        params = lm.init(7)
        page, nb = page_geometry(cfg, 96)
        shape = (cfg.n_layers, 2 * nb + 1, page, cfg.n_kv_heads, cfg.hd)
        # Shuffled block tables over pages 1.. (page 0 takes invalid rows).
        perm = torch.randperm(2 * nb, generator=torch.Generator().manual_seed(0)) + 1
        caches = {
            "k_pages": torch.zeros(shape, dtype=torch.bfloat16, device="cuda"),
            "v_pages": torch.zeros(shape, dtype=torch.bfloat16, device="cuda"),
            "block_table": perm.reshape(2, nb).to("cuda", torch.int32),
            "len": torch.zeros(2, dtype=torch.int32, device="cuda"),
        }
        rng = np.random.default_rng(3)
        toks = torch.as_tensor(rng.integers(2, cfg.vocab, size=(2, 40)), device="cuda")
        caches["q_len"] = torch.tensor([40, 23], dtype=torch.int32, device="cuda")
        logits, caches = lm.decode_step(params, toks, caches)
        seq = [logits.float()]
        nxt = torch.as_tensor(rng.integers(2, cfg.vocab, size=(8, 2, 1)), device="cuda")
        caches["q_len"] = torch.ones(2, dtype=torch.int32, device="cuda")
        for s in range(8):
            logits, caches = lm.decode_step(params, nxt[s], caches)
            seq.append(logits.float())
        runs[impl] = seq
    for a, b in zip(runs["cuda"], runs["torch"]):
        assert torch.isfinite(a).all()
        worst = max(worst, (a - b).abs().max().item())
    print(f"[small] bf16 model logits, kernel vs plain: max_abs_err={worst:.3e} "
          f"(tol {SMALL_MODEL_TOL})")
    assert worst <= SMALL_MODEL_TOL, worst
    return worst


# ---- phase 4 ------------------------------------------------------------------


def _work(lens, qls, c, hq, hkv, d, window=None):
    """Bytes the function must move and flops it must do on these inputs:
    K and V below each row's length and the valid query rows read once, the
    whole (B, C, Hq, D) output (zero rows included) written once."""
    in_bytes = flops = 0
    for ln, ql in zip(lens, qls):
        if ql <= 0 or ln <= 0:
            continue
        base = ln - ql
        in_bytes += ln * hkv * d * 2 * 2  # K and V rows below len, bf16
        in_bytes += min(ql, c) * hq * d * 2  # valid query rows, bf16
        for t in range(min(ql, c)):
            pos = base + t
            lo = 0 if window is None else max(0, pos - window + 1)
            flops += (min(pos, ln - 1) - lo + 1) * hq * d * 4
    out_bytes = len(lens) * c * hq * d * 2
    return in_bytes + out_bytes, flops


def phase_kernel_times(dev_info: dict, main: dict) -> dict:
    from repro_torch.core.attention import paged_decode_attention
    from repro_torch.core.schedule import resolve_order_group
    from repro_torch.kernels.flash_decode import (
        fold_schedule,
        launch_paged_decode,
        paged_flash_decode_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, hq, hkv, d, page, max_len = 8, 32, 32, 128, 64, 1024
    nb = max_len // page
    rng = np.random.default_rng(5)
    lens0 = [int(x) for x in rng.integers(560, 641, size=b)]
    shapes = {
        "narrow": (1, [1] * b),
        "wide": (256, [256] + [1] * (b - 1)),
    }
    out = {}
    for key, (c, q_lens) in shapes.items():
        q, k, v, bt, lens, qls = _case(
            gen, b_lens=lens0, q_lens=q_lens, c=c, hq=hq, hkv=hkv, d=d, page=page,
            max_len=max_len,
        )
        group = resolve_order_group("sawtooth", None, nb)
        err = _check_kernel(q, k, v, bt, lens, qls, None, group)
        wrapper = lambda: paged_flash_decode_fwd(q, k, v, lens, bt, q_lens=qls, order_group=group)
        phys, logical = fold_schedule(lens, bt, order_group=group)
        kern = lambda: launch_paged_decode(q, k, v, phys, logical, lens, qls)
        plain = lambda: paged_decode_attention(q, k, v, lens, bt, q_lens=qls, order_group=group)
        # Library yardstick: SDPA over the pages gathered into a contiguous
        # cache, with the same boolean mask (the gather is not timed).
        s = nb * page
        kc = k[bt.long()].reshape(b, s, hkv, d).transpose(1, 2).contiguous()
        vc = v[bt.long()].reshape(b, s, hkv, d).transpose(1, 2).contiguous()
        qt = q.transpose(1, 2).contiguous()
        col = torch.arange(s, device="cuda")[None, None, :]
        tq = torch.arange(c, device="cuda")[None, :, None]
        qpos = (lens - qls)[:, None, None] + tq
        mask = (col <= qpos) & (col < lens[:, None, None]) & (tq < qls[:, None, None])
        mask = mask[:, None]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask)
        # Kernel, plain, library, kernel: two kernel readings bracket the
        # others. The wrapper adds the schedule fold (a few small ops).
        t_kern = _median_ms(kern)
        t_wrap = _median_ms(wrapper)
        t_plain = _median_ms(plain)
        t_lib = _median_ms(sdpa)
        t_kern2 = _median_ms(kern)
        nbytes, flops = _work(lens0, q_lens, c, hq, hkv, d)
        t_bytes = nbytes / dev_info["bw"] * 1e3
        t_ops = flops / dev_info["peak"] * 1e3
        rec = {
            "C": c,
            "q_lens": q_lens,
            "lens": lens0,
            "kernel_ms": min(t_kern, t_kern2),
            "kernel_ms_runs": [t_kern, t_kern2],
            "wrapper_ms": t_wrap,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes,
            "flops": flops,
            "plain_ms": t_plain,
            "library_ms": t_lib,
            "max_abs_err": err,
            "launches_per_step": main["launches_per_step"],
        }
        if key == "narrow":
            rec["alternating_ms"] = _alternating_orders(q, k, v, bt, lens, qls, nb)
        print(f"[time] {key}: " + json.dumps(rec))
        out[key] = rec
    return out


def _alternating_orders(q, k, v, bt, lens, qls, nb) -> dict:
    """Per-launch time of launch pairs whose rows' lengths differ by one, as
    two consecutive decode steps do, with the pages walked in cyclic and in
    sawtooth order: sawtooth starts each launch on the pages the previous
    one read last (the paper's L2 reuse). Read in turns: cyclic, sawtooth,
    sawtooth, cyclic."""
    from repro_torch.kernels.flash_decode import fold_schedule, launch_paged_decode

    lens2 = lens + 1
    fns = {}
    for name, group in (("cyclic", 1), ("sawtooth", nb)):
        pa, la = fold_schedule(lens, bt, order_group=group)
        pb, lb = fold_schedule(lens2, bt, order_group=group)
        fns[name] = lambda pa=pa, la=la, pb=pb, lb=lb: (
            launch_paged_decode(q, k, v, pa, la, lens, qls),
            launch_paged_decode(q, k, v, pb, lb, lens2, qls),
        )
    runs: dict[str, list] = {"cyclic": [], "sawtooth": []}
    for name in ("cyclic", "sawtooth", "sawtooth", "cyclic"):
        runs[name].append(_median_ms(fns[name]) / 2)
    return {"cyclic": min(runs["cyclic"]), "sawtooth": min(runs["sawtooth"]), "runs": runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also run the main path's requests under torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test runs on the GPU only",
              file=sys.stderr)
        return 2
    _port()
    dev_info = phase_device()
    worst = phase_kernel_matrix()
    main_path = phase_main_path(profile=args.profile)
    small = phase_small_model()
    times = phase_kernel_times(dev_info, main_path)

    from repro_torch.kernels import cuda_lib

    spec = cuda_lib.KERNELS["paged_decode"]
    narrow = times["narrow"]
    entry = {
        "name": spec.name,
        "route": "cuda",
        "source": f"src/repro_torch/csrc/{spec.source}",
        "replaces": spec.replaces,
        "launches": main_path["launches"]["paged_decode"],
        "max_abs_err": max(worst, narrow["max_abs_err"], times["wide"]["max_abs_err"]),
        "ms": narrow["kernel_ms"],
        "plain_ms": narrow["plain_ms"],
        "bound_ms": narrow["bound_ms"],
        "bound_by": narrow["bound_by"],
        "library_ms": narrow["library_ms"],
        "wrapper_ms": narrow["wrapper_ms"],
        "wide": {k: times["wide"][k] for k in
                 ("kernel_ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "small_model_max_abs_err": small,
    }
    print(dev_info["smi"])
    print("checked kernels: " + json.dumps([spec.name]))
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
