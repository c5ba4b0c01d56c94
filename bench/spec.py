"""What a cell is made of, found by the names in ``BENCHMARK.json``: its
configuration file (``configs[].file``), its traffic mix
(``bench/mixes/<traffic>.json``), its engine settings and correctness limit
(``bench/cells/<workload>.json``) and the readers of its per-layer metrics
(``bench/metrics/<metric>.py``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

__all__ = ["Cell", "load_cell", "load_reader"]

BENCH = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    mix: dict             # the traffic mix file
    settings: dict        # the cell file: engine, wave, check
    end_to_end: list      # this cell's end-to-end metric entries
    per_layer: list       # this cell's per-layer metric entries


def _for(entries: list, workload: str) -> list:
    return [m for m in entries if workload in m.get("workloads", [workload])]


def load_cell(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(by_name)}")
    w = by_name[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        mix=json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text()),
        settings=json.loads((BENCH / "cells" / f"{workload}.json").read_text()),
        end_to_end=_for(bench["end_to_end"], workload),
        per_layer=_for(bench["per_layer"], workload),
    )


def load_reader(name: str):
    """The ``read(run)`` function of per-layer metric ``name``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
