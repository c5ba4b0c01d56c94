"""What a cell is made of, found by the names in ``BENCHMARK.json``: its
configuration file (``configs[].file``) and the module that file names, if
any (``"module"``), its traffic mix (``bench/mixes/<traffic>.json``), its
engine settings and correctness limit (``bench/cells/<workload>.json``) and
the readers of its per-layer metrics (``bench/metrics/<metric>.py``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Optional

__all__ = ["Cell", "load_cell", "load_reader", "load_module"]

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


def _exec(path: Path, name: str, *, keep: bool = False) -> ModuleType:
    """Run the file at ``path`` as module ``name``; with ``keep`` it is
    registered in ``sys.modules`` first (as an import would do, and as a
    dataclass defined in it needs) and taken from there again later."""
    if keep and name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    if keep:
        sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    """The ``read(run)`` function of per-layer metric ``name``."""
    return _exec(BENCH / "metrics" / f"{name}.py",
                 f"bench_metric_{name.replace('.', '_')}").read


def load_module(config: dict) -> Optional[ModuleType]:
    """The module a configuration file names under ``"module"`` (a path from
    the checkout's root to a ``.py`` file under ``bench/``), or None where it
    names none. Loaded once a process, so every caller gets the same
    objects. A path that leaves ``bench/`` or names no file is an error
    naming the configuration: it never falls back to the defaults."""
    rel = config.get("module")
    if rel is None:
        return None
    path = (BENCH.parent / rel).resolve()
    if path.suffix != ".py" or not path.is_relative_to(BENCH) or not path.is_file():
        raise FileNotFoundError(f"configuration {config.get('name')!r} names module {rel!r}, "
                                f"which is no .py file under {BENCH.name}/")
    return _exec(path, "bench_module_" + re.sub(r"\W", "_", str(path.relative_to(BENCH))),
                 keep=True)
