"""The readings a cell's correctness limits are set from, in one process
on the card: for each seed, the program's compared numbers (the widest and
the mean logit gap, ``bench/reference/check.py``) over the requests a run
compares (one wave at the cell's own load, which finishes the mix's
longest requests), and for the first ``--control`` seeds the control's:
the plain reference computed in float8 e4m3 in the program's place, the
gaps of the tokens it puts first at the same served positions.

    python3 bench/control.py --workload <cell> --seeds 1-12 --control 3

Prints one JSON line a seed and a summary line: for each number the
program's largest reading (the lower) and the control's smallest (the
upper). The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def _seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def readings(cell, seeds, n_control: int, device: str = "cuda"):
    """Yields one dict a seed: the program's numbers and (for the first
    ``n_control`` seeds) the control's."""
    from bench.harness import Bench, reference_numbers, sample

    b = Bench(cell, device)
    b.weights.fill(seeds[0])
    b.warm_up()
    n = int(cell.settings["check"]["requests"])
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        b.weights.fill(seed)
        served = b.serve(b.wave(seed, 0))[0].served
        chosen = sample(served, n, seed)
        row = {"seed": seed, "served_tokens": sum(len(s.tokens) for s in chosen),
               "program": reference_numbers(b.weights, cell.config, chosen)}
        if i < n_control:
            row["control"] = reference_numbers(b.weights, cell.config, chosen, control=True)
        row["seconds"] = time.perf_counter() - t
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from bench.spec import load_cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload)
    rows = []
    for row in readings(cell, _seeds(args.seeds), args.control):
        rows.append(row)
        print(json.dumps(row), flush=True)
    ctl = [r["control"] for r in rows if "control" in r]
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(0)}
    for name in rows[0]["program"]:
        summary[name] = {"lower": max(r["program"][name] for r in rows),
                         "upper": min(c[name] for c in ctl) if ctl else None,
                         "program": [r["program"][name] for r in rows],
                         "control": [c[name] for c in ctl]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
