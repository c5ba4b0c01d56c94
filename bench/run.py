"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; the numbers compared, each beside
its limit, come last (``checks``) and close standard error too. Exits
non-zero without a result when the card or a cell's chips are missing, or
when JAX, Flax or the JAX package ``repro`` is loaded after the window.

The port's sources are ``src/`` of the checkout, and its kernels build
into ``build/repro_torch/`` there at first use; Python's bytecode is
cached in ``build/pycache/``.
"""

import time

_T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Python's bytecode is a build cache like the kernels': kept at a fixed path
# in the checkout, written by its first run, also where the environment
# sets PYTHONDONTWRITEBYTECODE or the installed packages ship no .pyc (then
# every process would compile torch's sources anew, seconds of set-up).
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / "build" / "pycache")

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

sys.path[0] = str(ROOT)                      # not bench/: its modules are bench.*
sys.path.insert(1, str(ROOT / "src"))
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(cell, args, device: str) -> int:
    """Run the cell, check what is loaded, print the checks and the line."""
    from bench.harness import forbidden_modules, run_cell

    out, info = run_cell(cell, args.seed, args.seconds, bool(args.trace), device=device, t0=_T0)
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    print("run: " + json.dumps(info), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)

    import torch

    from bench.spec import load_cell

    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    return emit(cell, args, "cuda")


if __name__ == "__main__":
    sys.exit(main())
