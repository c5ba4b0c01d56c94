"""Import isolation and the shape of the result line: a cell's run driven
end to end on the CPU (everything but ``run.py``'s look for the card) at a
reduced size with a 2-second window, in a fresh process; the JAX package
``repro`` and JAX never load, compared by whole top-level names
(``repro_torch`` starts with ``repro``); the reference, and every module a
configuration file or a test names, imports nothing of the port (such a
module's ``port_config`` imports the port inside the function); the last
line holds the contract's keys, the checks last."""

import ast
import json
import os
import subprocess
import sys

import pytest

import portbench_cells

ROOT = portbench_cells.ROOT
BENCH = ROOT / "bench"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]

_DRIVER = """
import json, sys
sys.path[:0] = [{tests!r}]
import portbench_cells
from bench import run
args = run.parse(["--workload", {wl!r}, "--seed", "4294967311", "--seconds", "2",
                  "--trace", {trace!r}])
rc = run.emit(portbench_cells.tiny_cell({wl!r}), args, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})), file=sys.stderr)
sys.exit(rc)
"""


def _top_imports(path, *, module_level: bool = False) -> set[str]:
    """Top-level names of what ``path`` imports, anywhere in it, or with
    ``module_level`` only in statements that run when it is imported."""
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if not (module_level and isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))):
                yield child
                yield from walk(child)

    names = set()
    for node in walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("workload,trace", [("deepseek-7b.chat", "0"),
                                            ("deepseek-7b.long-prompt", "1")])
def test_a_run_loads_no_jax_and_prints_the_contracts_keys(workload, trace):
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER.format(tests=str(BENCH / "tests"), wl=workload,
                                              trace=trace)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    modules = set(json.loads(proc.stderr.strip().splitlines()[-1]))
    assert "repro_torch" in modules and "torch" in modules
    assert not modules & {"jax", "jaxlib", "flax", "repro"}
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    limits = portbench_cells.load_cell(ROOT, workload).settings["check"]["limits"]
    assert all(f"check {name}:" in proc.stderr for name in limits)


def _named_modules() -> list[str]:
    """Every module a configuration file or a test names."""
    files = [json.loads(p.read_text()) for p in (BENCH / "configs").glob("*.json")]
    return sorted({c["module"] for c in files if "module" in c} | set(portbench_cells.MODULES))


def test_the_reference_imports_nothing_of_the_port():
    port = {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    for path in (BENCH / "reference").glob("*.py"):
        assert not _top_imports(path) & port, path
    named = _named_modules()
    assert portbench_cells.LOWERED in named
    for rel in named:
        assert not _top_imports(ROOT / rel) & {"repro", "jax", "jaxlib", "flax"}, rel
        assert not _top_imports(ROOT / rel, module_level=True) & port, rel
    load = "".join(f"load_module({{'name': 'isolation', 'module': {rel!r}}});" for rel in named)
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; import bench.reference.model, bench.reference.check;"
         f"from bench.spec import load_module; {load}"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=""), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = set(ast.literal_eval(proc.stdout.strip().splitlines()[-1]))
    assert "bench_module_tests_portbench_lowered_py" in loaded
    assert not loaded & port


def test_nothing_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _top_imports(path) & {"repro", "jax", "jaxlib", "flax"}, path


def test_without_a_card_the_command_fails_and_prints_no_result(tmp_path):
    """Here there is no card; in a directory of ``BENCHMARK.json`` and
    ``bench/`` alone there is no program either."""
    import shutil

    bare = tmp_path / "bare"
    shutil.copytree(BENCH, bare / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare / "BENCHMARK.json")
    for cwd in (ROOT, bare):
        proc = subprocess.run(
            [sys.executable, "bench/run.py", "--workload", "deepseek-7b.chat", "--seed", "1",
             "--seconds", "1", "--trace", "0"],
            cwd=cwd, env=dict(os.environ, PYTHONPATH=""), capture_output=True, text=True,
            timeout=120)
        assert proc.returncode != 0 and proc.stdout.strip() == ""
