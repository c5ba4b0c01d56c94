"""Time one CUDA kernel built from several source trees in one process, so
that two versions of it are compared on one card within one call: B1, the
paged decode (``csrc/paged_decode.cu``), B2, the flash forward
(``csrc/flash_fwd.cu``), B3, the contiguous decode
(``csrc/contig_decode.cu``), B5 and B6, the flash backward's dQ and
dK/dV kernels (``csrc/flash_bwd_dq.cu``, ``csrc/flash_bwd_dkv.cu``), or B7,
the Mamba-2 SSD scan (``csrc/ssd.cu``).

    PYTHONPATH=src python -m repro_torch.kernels.compare_kernels \
        [--kernel paged_decode|flash_fwd|contig_decode|flash_bwd_dq|flash_bwd_dkv|ssd] \
        --csrc parent=DIR --csrc this=src/repro_torch/csrc

Each DIR holds the kernel's source and the headers it includes (the ``csrc``
directory of another commit, unpacked with ``git archive`` into a directory
that git ignores, such as ``build/``). Every variant is compiled with the
port's flags into ``build/compare_kernels/`` (one ``nvcc`` each, all started
together) and loaded with ``ctypes``; all take the same C entry point. At
each of the kernel's shapes (``SHAPES``) every variant's outputs are held to
the first variant's within ``OUTPUT_TOL`` (variants whose tiles or
summation order differ agree only up to bf16 rounding; for B5 and B6, whose
gradients reach magnitudes where one bf16 step exceeds it, the difference
is taken over max |first variant's output|, as ``chip_smoke.py`` holds
them to the plain backward; for B7 too, y within ``SSD_Y_TOL`` and the
final state within ``SSD_STATE_TOL``, ``chip_smoke.py``'s limits), then the variants
are timed in rounds whose order alternates (A B C, C B A, ...). Each round
takes three readings of each variant after 5 warm-ups (:func:`median_ms`,
:func:`host_us`): the median of 30 batches of back-to-back launches timed
with CUDA events (device time alone); the median of 30 single launches,
each between two events (device time plus whatever host time the launch
leaves the card idle); and the median host time to issue one launch, the C
entry's own work included (for B2, encoding its tensor maps). Prints the
card's name and power limit, then one JSON line per shape; exits 1 if a
variant's outputs lie outside the tolerance. These launches are not counted
in ``cuda_lib.launch_counts``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import (
    _launch_args,
    flash_attention_fwd,
    launch_flash_bwd_delta,
)
from repro_torch.kernels.flash_decode import decode_chunk, fold_schedule

__all__ = ["SHAPES", "OUTPUT_TOL", "SSD_Y_TOL", "SSD_STATE_TOL", "build", "median_ms", "host_us",
           "main"]

# Max abs difference between two variants' outputs (bf16 o; float32 lse):
# the plain-version limit of the kernels' checks (chip_smoke.KERNEL_TOL).
OUTPUT_TOL = 2e-2

# kernel -> shape name -> dims. paged_decode: (B, C, Hq, Hkv, D, page,
# max_len), a mixed step of the continuous path with lengths 560-640 by row,
# every row one decode token (narrow) or row 0 a C-token chunk (wide),
# sawtooth, folded before timing. flash_fwd: (B, Sq = Skv, Hq = Hkv, D, with
# lse), the static path's second prefill (deepseek-7b's D 128 and zamba2's
# D 80) and the training forward, causal, sawtooth. contig_decode: (B,
# S_max, Hq, Hkv, D), a static decode step with per-row lengths 700-731
# (deepseek-7b's D 128, zamba2's D 80, and D 64 with GQA 4),
# sawtooth. flash_bwd_dq, flash_bwd_dkv: (B, Sq = Skv, Hq = Hkv, D), the
# training backward, causal, sawtooth, from B2's lse and B4's delta. ssd:
# (B, S, H, P, N, with an initial state), the SSM paths' second prefill
# group (mamba2-130m's 24 heads at N 128, zamba2-2.7b's 80 at N 64) from a
# zero state as ops.ssd starts it, and one long sequence from a random
# state (informational).
SHAPES = {
    "paged_decode": {"narrow": (8, 1, 32, 32, 128, 64, 1024),
                     "wide": (8, 256, 32, 32, 128, 64, 1024)},
    "flash_fwd": {"prefill": (8, 700, 32, 128, False), "prefill_d80": (8, 700, 32, 80, False),
                  "train": (4, 1024, 32, 128, True)},
    "contig_decode": {"decode_d128": (8, 1024, 32, 32, 128),
                      "decode_d80": (8, 1024, 32, 32, 80),
                      "decode_d64_gqa4": (8, 1024, 32, 8, 64)},
    "flash_bwd_dq": {"train": (4, 1024, 32, 128)},
    "flash_bwd_dkv": {"train": (4, 1024, 32, 128)},
    "ssd": {"mamba2": (8, 700, 24, 64, 128, False), "zamba2": (8, 700, 80, 64, 64, False),
            "long_informational": (1, 4096, 24, 64, 128, True)},
}
# Kernels whose output difference is read relative to max |output|.
_RELATIVE = ("flash_bwd_dq", "flash_bwd_dkv", "ssd")
# B7's limits (chip_smoke.SSD_Y_TOL, SSD_STATE_TOL), relative to max |output|:
# y, then the final state.
SSD_Y_TOL = 1e-2
SSD_STATE_TOL = 1e-4


def build(kernel: str, variants: dict[str, Path]) -> dict:
    """Compile ``kernel``'s source of every ``{name: csrc dir}`` in parallel
    and load each; returns ``{name: C entry point}``; raises with the
    compiler's output if one fails."""
    spec = cuda_lib.KERNELS[kernel]
    out_dir = cuda_lib.BUILD_DIR.parent / "compare_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, csrc in variants.items():
        files = [csrc / spec.source, *sorted(csrc.glob("*.cuh"))]
        src = b"".join(p.read_bytes() for p in files)
        lib = out_dir / f"{kernel}-{name}-{hashlib.sha256(src).hexdigest()[:16]}.so"
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
               str(csrc / spec.source)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        fn = getattr(ctypes.CDLL(str(lib)), spec.entry)
        fn.argtypes = list(spec.argtypes)
        fn.restype = ctypes.c_int
        libs[name] = fn
    if failed:
        raise RuntimeError(f"{kernel} build failed:\n" + "\n".join(failed))
    return libs


def median_ms(call, warmup: int = 5, reps: int = 30, batch_ms: float = 1.0,
              batched: bool = True) -> float:
    """Median device time of one ``call()``, in ms, over ``reps`` readings
    timed with CUDA events. Batched, each reading times a batch of
    back-to-back calls and divides by the batch; the batch is sized from one
    timed call to run about ``batch_ms`` (at least one call, at most 20), so
    the host's time to enqueue a call hides behind the card's work wherever
    it is shorter. Otherwise each reading is one call between two events:
    with the queue empty, the host's time between the two records is read
    as well."""
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    batch = 1
    if batched:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        once_ms = (time.perf_counter() - t0) * 1e3
        batch = max(1, min(20, int(batch_ms / max(once_ms, 1e-3))))
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def host_us(call, warmup: int = 5, reps: int = 30) -> float:
    """Median host time of one ``call()``, in microseconds, on the host's
    clock: what the calling thread spends to issue it. The card runs the
    launches asynchronously and ``reps`` of them never fill its queue, so
    no reading waits for the card."""
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _bf16(gen, shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _flash_fwd_case(fns: dict, dims: tuple, gen) -> tuple:
    """(launch(name), {name: outputs}) of B2 at ``dims``."""
    b, s, h, d, with_lse = dims
    q, k, v = (_bf16(gen, (b, s, h, d)) for _ in range(3))
    args = _launch_args(q, k, order="sawtooth", causal=True, window=None, scale=None,
                        snake_group=None)
    outs = {name: (torch.empty_like(q), torch.empty((b, s, h), dtype=torch.float32,
                                                    device="cuda") if with_lse else None)
            for name in fns}

    def launch(name):
        o, lse = outs[name]
        return fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                         None if lse is None else lse.data_ptr(), None, *args)

    return launch, outs


def _paged_decode_case(fns: dict, dims: tuple, gen) -> tuple:
    """(launch(name), {name: outputs}) of B1 at ``dims``: a pool with a
    spare page and a shuffled block table, the sawtooth schedule folded
    once."""
    b, c, hq, hkv, d, page, max_len = dims
    nb = max_len // page
    n_pages = b * nb + 1
    q = _bf16(gen, (b, c, hq, d))
    k, v = _bf16(gen, (n_pages, page, hkv, d)), _bf16(gen, (n_pages, page, hkv, d))
    bt = (torch.randperm(n_pages - 1, generator=gen, device="cuda")[: b * nb] + 1)
    bt = bt.reshape(b, nb).to(torch.int32)
    lens = torch.randint(560, 641, (b,), generator=gen, device="cuda", dtype=torch.int32)
    q_lens = torch.ones((b,), dtype=torch.int32, device="cuda")
    q_lens[0] = c
    phys, logical = fold_schedule(lens, bt, order_group=nb)
    args = (b, c, hq, hkv, d, nb, page, -1, float(d ** -0.5),
            torch.cuda.current_stream().cuda_stream)
    outs = {name: (torch.empty_like(q),) for name in fns}

    def launch(name):
        return fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), phys.data_ptr(),
                         logical.data_ptr(), lens.data_ptr(), q_lens.data_ptr(),
                         outs[name][0].data_ptr(), *args)

    return launch, outs


def _contig_decode_case(fns: dict, dims: tuple, gen) -> tuple:
    """(launch(name), {name: outputs}) of B3 at ``dims``."""
    b, s_max, hq, hkv, d = dims
    q = _bf16(gen, (b, 1, hq, d))
    k, v = _bf16(gen, (b, s_max, hkv, d)), _bf16(gen, (b, s_max, hkv, d))
    lens = torch.randint(700, 732, (b,), generator=gen, device="cuda", dtype=torch.int32)
    args = (b, s_max, hq, hkv, d, -1, decode_chunk(512, s_max),
            cuda_lib.ORDER_CODES["sawtooth"], 1, float(d ** -0.5),
            torch.cuda.current_stream().cuda_stream)
    outs = {name: (torch.empty_like(q),) for name in fns}

    def launch(name):
        return fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                         outs[name][0].data_ptr(), *args)

    return launch, outs


def _flash_bwd_case(kernel: str):
    def case(fns: dict, dims: tuple, gen) -> tuple:
        """(launch(name), {name: outputs}) of B5 (dq) or B6 (dk, dv) at
        ``dims``, lse from B2 and delta from B4."""
        b, s, h, d = dims
        q, k, v, do = (_bf16(gen, (b, s, h, d)) for _ in range(4))
        o, lse = flash_attention_fwd(q, k, v, order="sawtooth", causal=True, return_lse=True)
        delta = torch.empty_like(lse)
        launch_flash_bwd_delta(o, do, delta)
        args = _launch_args(q, k, order="sawtooth", causal=True, window=None, scale=None,
                            snake_group=None)
        operands = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    delta.data_ptr())
        if kernel == "flash_bwd_dq":
            outs = {name: (torch.empty_like(q),) for name in fns}
        else:
            outs = {name: (torch.empty_like(k), torch.empty_like(v)) for name in fns}

        def launch(name):
            return fns[name](*operands, *(t.data_ptr() for t in outs[name]), None, *args)

        return launch, outs

    return case


def _ssd_case(fns: dict, dims: tuple, gen) -> tuple:
    """(launch(name), {name: (y, final state)}) of B7 at ``dims``, inputs at
    the model's scales as ``chip_smoke._ssd_case`` draws them."""
    b, s, h, p, n, with_state = dims
    x = _bf16(gen, (b, s, h, p))
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda") - 3)
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    bm, cm = _bf16(gen, (b, s, n)), _bf16(gen, (b, s, n))
    init = torch.randn((b, h, p, n), generator=gen, device="cuda") if with_state else None
    outs = {name: (torch.empty_like(x), torch.empty((b, h, p, n), device="cuda"))
            for name in fns}
    args = (b, s, h, p, n, torch.cuda.current_stream().cuda_stream)

    def launch(name):
        y, fin = outs[name]
        return fns[name](x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                         cm.data_ptr(), None if init is None else init.data_ptr(), y.data_ptr(),
                         fin.data_ptr(), *args)

    return launch, outs


_CASES = {"paged_decode": _paged_decode_case, "flash_fwd": _flash_fwd_case,
          "contig_decode": _contig_decode_case,
          "flash_bwd_dq": _flash_bwd_case("flash_bwd_dq"),
          "flash_bwd_dkv": _flash_bwd_case("flash_bwd_dkv"),
          "ssd": _ssd_case}


def _diffs(kernel: str, got: tuple, first: tuple) -> list:
    """Max-abs difference of each of ``got``'s outputs from ``first``'s;
    relative to max |first| for the kernels of ``_RELATIVE``."""
    out = []
    for x, y in zip(got, first):
        if x is None:
            continue
        d = (x.float() - y.float()).abs().max().item()
        if kernel in _RELATIVE:
            d /= max(y.float().abs().max().item(), 1e-30)
        out.append(d)
    return out


def _within(kernel: str, diffs: list) -> bool:
    if kernel == "ssd":
        return diffs[0] <= SSD_Y_TOL and diffs[1] <= SSD_STATE_TOL
    return all(d <= OUTPUT_TOL for d in diffs)


def compare(kernel: str, fns: dict, shape: str, rounds: int, seed: int = 0) -> dict:
    dims = SHAPES[kernel][shape]
    launch, outs = _CASES[kernel](fns, dims, torch.Generator(device="cuda").manual_seed(seed))

    def call(name):
        err = launch(name)
        if err:
            raise RuntimeError(f"{kernel} ({name}) returned cudaError_t {err}")

    names = list(fns)
    for name in names:
        call(name)
    torch.cuda.synchronize()
    diffs = {name: _diffs(kernel, outs[name], outs[names[0]]) for name in names}
    diff = {name: max(d) for name, d in diffs.items()}
    readings = {
        "ms": lambda fn: median_ms(fn),
        "ms_single": lambda fn: median_ms(fn, batched=False),
        "host_us": host_us,
    }
    runs = {key: {name: [] for name in names} for key in readings}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            for key, read in readings.items():
                runs[key][name].append(read(lambda: call(name)))
    rec = {"kernel": kernel, "shape": shape, "dims": dims,
           ("max_rel_diff_vs_" if kernel in _RELATIVE else "max_abs_diff_vs_") + names[0]: diff,
           "within_tol": all(_within(kernel, d) for d in diffs.values())}
    if kernel == "ssd":
        rec["rel_diff_y_state_vs_" + names[0]] = diffs
    for key, by_name in runs.items():
        rec[key + "_median_of_rounds"] = {n: statistics.median(t) for n, t in by_name.items()}
        rec[key + "_rounds"] = by_name
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(SHAPES), default="flash_fwd")
    ap.add_argument("--csrc", action="append", required=True, metavar="NAME=DIR",
                    help="a variant: its name and a directory holding the kernel's source")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    variants = {}
    for spec in args.csrc:
        name, _, path = spec.partition("=")
        variants[name] = Path(path)
    t0 = time.perf_counter()
    fns = build(args.kernel, variants)
    print(f"[compare_kernels] built {len(fns)} variants of {args.kernel} in "
          f"{time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    ok = True
    for shape in SHAPES[args.kernel]:
        rec = compare(args.kernel, fns, shape, args.rounds)
        ok = ok and rec["within_tol"]
        print(json.dumps(rec))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
