"""Every family's dry-run cells, reduced, on a fake (2, 4) process group.

Each arch's train_4k, prefill_32k and decode_32k cells (the reduced config,
batch 4, which the data axis divides) trace to the end through the port's
sharded steps, in a subprocess each (the fake group is process-wide). The
cells met DTensor faults the 1×1 and 2×2 meshes of the sharding tests never
showed: KV heads fewer than the tensor axis, the VLM's prefix joined to the
tokens, the Mamba decode state's head shard, the causal conv's gradient
(ROADMAP §C).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_IDS as REF_ARCH_IDS

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ARCHS = [a for a in REF_ARCH_IDS if a != "paper-gb10"]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_cells_trace_on_a_fake_2x4_mesh(arch):
    code = textwrap.dedent(f"""
        import json
        from repro_torch.launch.dryrun import fake_world, lower_cell
        from repro_torch.launch.mesh import make_local_mesh

        out = {{}}
        with fake_world(8):
            mesh = make_local_mesh(2, 4, device="cpu")
            for shape in ("train_4k", "prefill_32k", "decode_32k"):
                rec, _ = lower_cell({arch!r}, shape, mesh, "2x4", reduced=True,
                                    shape_overrides={{"global_batch": 4}},
                                    par_overrides={{"microbatches": 1}})
                out[shape] = {{"status": rec["status"], "flops": rec["cost"]["flops"],
                              "coll": rec["collectives"]["total"]}}
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=600, cwd=ROOT)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-8000:]}"
    got = json.loads(r.stdout.strip().splitlines()[-1])
    for shape, rec in got.items():
        assert rec["status"] == "ok" and rec["flops"] > 0 and rec["coll"] > 0, (shape, rec)
