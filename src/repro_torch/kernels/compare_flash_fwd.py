"""Time B2, the flash forward (``csrc/flash_fwd.cu``), built from several
source trees in one process, so that two versions of the kernel are compared
on one card within one call.

    PYTHONPATH=src python -m repro_torch.kernels.compare_flash_fwd \
        --csrc parent=DIR --csrc this=src/repro_torch/csrc

Each DIR holds a ``flash_fwd.cu`` and the headers it includes (the ``csrc``
directory of another commit, unpacked with ``git archive`` into a directory
that git ignores, such as ``build/``). Every variant is compiled with the
port's flags into ``build/compare_flash_fwd/`` (one ``nvcc`` each, all
started together) and loaded with ``ctypes``; all take the same C entry
point. At two shapes, the static serve path's second prefill (B 8, Sq = Skv
= 700, 32 heads of 128, causal, sawtooth) and the training forward (B 4,
S 1024, 32 heads of 128, causal, sawtooth, with lse), each variant's output
is held to the first variant's, then the variants are timed in rounds whose
order alternates (A B C, C B A, ...), each reading the median of 30 launches
after 5 warm-ups, timed with CUDA events. Prints the card's name and power
limit, then one JSON line per shape. These launches are not counted in
``cuda_lib.launch_counts``.
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
from repro_torch.kernels.flash_attention import _launch_args

__all__ = ["SHAPES", "build", "main"]

# name -> (B, Sq = Skv, Hq = Hkv, D, with lse)
SHAPES = {"prefill": (8, 700, 32, 128, False), "train": (4, 1024, 32, 128, True)}


def build(variants: dict[str, Path]) -> dict:
    """Compile ``flash_fwd.cu`` of every ``{name: csrc dir}`` in parallel
    and load each; returns ``{name: C entry point}``; raises with the
    compiler's output if one fails."""
    out_dir = cuda_lib.BUILD_DIR.parent / "compare_flash_fwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, csrc in variants.items():
        files = [csrc / "flash_fwd.cu", *sorted(csrc.glob("*.cuh"))]
        src = b"".join(p.read_bytes() for p in files)
        lib = out_dir / f"{name}-{hashlib.sha256(src).hexdigest()[:16]}.so"
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
               str(csrc / "flash_fwd.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        fn = ctypes.CDLL(str(lib)).flash_fwd_bf16
        fn.argtypes = list(cuda_lib.KERNELS["flash_fwd"].argtypes)
        fn.restype = ctypes.c_int
        libs[name] = fn
    if failed:
        raise RuntimeError("flash_fwd build failed:\n" + "\n".join(failed))
    return libs


def _median_ms(call, warmup: int = 5, reps: int = 30) -> float:
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(fns: dict, shape: str, rounds: int, seed: int = 0) -> dict:
    b, s, h, d, with_lse = SHAPES[shape]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    args = _launch_args(q, k, order="sawtooth", causal=True, window=None, scale=None,
                        snake_group=None)
    outs = {}
    for name in fns:
        o = torch.empty_like(q)
        lse = torch.empty((b, s, h), dtype=torch.float32, device="cuda") if with_lse else None
        outs[name] = (o, lse)

    def call(name):
        o, lse = outs[name]
        err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        None if lse is None else lse.data_ptr(), None, *args)
        if err:
            raise RuntimeError(f"flash_fwd ({name}) returned cudaError_t {err}")

    names = list(fns)
    for name in names:
        call(name)
    torch.cuda.synchronize()
    o0, lse0 = outs[names[0]]
    diff = {name: max((outs[name][0].float() - o0.float()).abs().max().item(),
                      0.0 if lse0 is None else (outs[name][1] - lse0).abs().max().item())
            for name in names}
    runs = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            runs[name].append(_median_ms(lambda: call(name)))
    return {"shape": shape, "B": b, "S": s, "heads": h, "D": d, "lse": with_lse,
            "max_abs_diff_vs_" + names[0]: diff,
            "ms_median_of_rounds": {n: statistics.median(t) for n, t in runs.items()},
            "ms_rounds": runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", required=True, metavar="NAME=DIR",
                    help="a variant: its name and a directory holding flash_fwd.cu")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_flash_fwd: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    variants = {}
    for spec in args.csrc:
        name, _, path = spec.partition("=")
        variants[name] = Path(path)
    t0 = time.perf_counter()
    fns = build(variants)
    print(f"[compare_flash_fwd] built {len(fns)} variants in {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    for shape in SHAPES:
        print(json.dumps(compare(fns, shape, args.rounds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
