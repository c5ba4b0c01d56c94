"""The port's ``analysis`` package against the JAX package's.

``roofline``'s parameter and FLOP counts and its rows are the reference's
arithmetic over the port's configs: equal exactly, for every arch and shape.
``analysis.constants`` holds the H100's data-sheet numbers, so the rows are
compared with the port's constants set to the reference's (TPU v5e) values,
read from ``repro.analysis.constants``. ``analysis.trace`` replaces the
reference's HLO parse: the reference's collective test, issued as torch
collectives on a fake 4-rank process group (a subprocess: the group is
process-wide), must count what ``repro.analysis.hlo.collective_bytes`` reads
from the reference's own HLO text.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch

from repro.analysis import constants as ref_C
from repro.analysis import hlo as ref_hlo
from repro.analysis import roofline as ref_rf
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro_torch.analysis import constants as C
from repro_torch.analysis import roofline as rf
from repro_torch.analysis import trace as T
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.cache_model import H100

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _run(code: str, timeout: int = 300) -> str:
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-8000:]}"
    return r.stdout


def test_shapes_equal_reference():
    assert list(SHAPES) == list(REF_SHAPES)
    for name, ref in REF_SHAPES.items():
        assert dataclasses.asdict(SHAPES[name]) == dataclasses.asdict(ref)
        assert dataclasses.asdict(SHAPES[name].reduced()) == dataclasses.asdict(ref.reduced())


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_counts_equal_reference(arch, reduced):
    ref, got = ref_get_config(arch), get_config(arch)
    if reduced:
        ref, got = ref.reduced(), got.reduced()
    assert rf.param_count(got) == ref_rf.param_count(ref)
    assert rf.active_param_count(got) == ref_rf.active_param_count(ref)
    for name in SHAPES:
        assert rf.model_flops(got, SHAPES[name]) == ref_rf.model_flops(ref, REF_SHAPES[name])
        assert (rf.model_flops(got, SHAPES[name].reduced())
                == ref_rf.model_flops(ref, REF_SHAPES[name].reduced()))


@pytest.mark.parametrize("shape", list(REF_SHAPES))
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_analyze_rows_equal_reference(arch, shape, monkeypatch):
    monkeypatch.setattr(C, "PEAK_FLOPS_BF16", ref_C.PEAK_FLOPS_BF16)
    monkeypatch.setattr(C, "HBM_BW", ref_C.HBM_BW)
    monkeypatch.setattr(C, "NVLINK_BW", ref_C.ICI_BW_PER_LINK)
    for i, (flops, byts, coll) in enumerate([(3.5e14, 2.2e11, 4.1e9), (1e9, 8e12, 0.0),
                                             (0.0, 0.0, 0.0), (2e12, 1e10, 9e12)]):
        kw = dict(arch=arch, shape=shape, mesh_name="single", chips=256 * (1 + i % 2),
                  cost={"flops": flops, "bytes accessed": byts}, coll={"total": coll})
        want = ref_rf.analyze(**kw, cfg=ref_get_config(arch), shape_cfg=REF_SHAPES[shape])
        got = rf.analyze(**kw, cfg=get_config(arch), shape_cfg=SHAPES[shape])
        assert got.to_row() == want.to_row()


def test_constants_are_the_h100_data_sheet():
    assert C.PEAK_FLOPS_BF16 == H100.peak_flops == 989e12
    assert C.HBM_BW == H100.mem_bandwidth == 3.35e12
    assert C.NVLINK_BW == 450e9
    assert C.CHIP_HBM_BYTES == 80 * 2**30
    assert C.SMEM_PER_SM_BYTES == 228 * 2**10
    # none of the reference's TPU numbers
    ref = {ref_C.PEAK_FLOPS_BF16, ref_C.HBM_BW, ref_C.ICI_BW_PER_LINK, ref_C.CHIP_HBM_BYTES,
           ref_C.VMEM_BYTES}
    assert not ref & {C.PEAK_FLOPS_BF16, C.HBM_BW, C.NVLINK_BW, C.CHIP_HBM_BYTES,
                      C.SMEM_PER_SM_BYTES}


def test_parse_shape_bytes():
    assert T.parse_shape_bytes("float32[256,1024]") == 256 * 1024 * 4
    assert T.parse_shape_bytes("bfloat16[8]") == 16
    assert T.parse_shape_bytes("(float32[4], int32[2])") == 24
    assert T.parse_shape_bytes("bool[]") == 1
    assert T.parse_shape_bytes("float8_e4m3fn[3,5]") == 15
    assert T.parse_shape_bytes("nodtype[4]") == 0


def test_rank_trace_counts_flops_bytes_and_live_memory():
    """A plain (non-distributed) function under ``RankTrace``: the product's
    2·m·n·k flops, each op's input and output bytes, the peak of the
    storages it allocated while they lived, views and waits moving nothing."""
    a = torch.randn(32, 64)
    b = torch.randn(64, 16)
    with T.RankTrace() as tr:
        c = a @ b                    # 32 x 16 floats: 2048 bytes
        d = torch.relu(c)            # another 2048 while c lives
        e = d.view(16, 32)           # a view: no bytes, no storage
        del c
        f = e * 2.0                  # c was freed: peak stays at 4096
    assert tuple(f.shape) == (16, 32)
    ops = tr.ops
    assert [r.op for r in ops] == ["aten.mm.default", "aten.relu.default", "aten.view.default",
                                   "aten.mul.Tensor"]
    assert ops[0].flops == 2 * 32 * 64 * 16 and sum(r.flops for r in ops[1:]) == 0
    assert ops[0].bytes == (32 * 64 + 64 * 16 + 32 * 16) * 4
    assert ops[1].bytes == 2 * 32 * 16 * 4 and ops[2].bytes == 0
    assert ops[0].inputs == (((32, 64), "float32"), ((64, 16), "float32"))
    assert tr.peak_live_bytes == 2 * 32 * 16 * 4
    assert T.cost(tr) == {"flops": 2 * 32 * 64 * 16, "bytes accessed": sum(r.bytes for r in ops)}
    assert T.count_ops(tr) == {"aten.mm": 1, "aten.bmm": 0, "aten.addmm": 0}
    assert T.count_ops(tr, None)["aten.relu"] == 1
    assert T.collective_bytes(tr) == {"total": 0}
    text = T.trace_text(tr)
    assert text.splitlines()[0] == ("aten.mm.default(float32[32,64], float32[64,16]) -> "
                                    "(float32[32,16]) flops=65536 bytes=14336")


def test_collective_bytes_equal_reference():
    """The reference's ``test_collective_bytes_parsing`` collectives (an
    all-reduce of f32[1024], an all-gather to bf16[64,128], a reduce-scatter
    to f32[16] and a collective-permute of 64 bytes), issued on a fake
    4-rank group: the port's counts equal the reference's parse of its own
    HLO text, and waits count nothing."""
    hlo = """
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), replica_groups={}
  %ag.1 = bf16[64,128]{1,0} all-gather(bf16[32,128]{1,0} %y), dimensions={0}
  %rs = f32[16]{0} reduce-scatter(f32[64]{0} %z), dimensions={0}
  %cp-start = (f32[8]{0}, f32[8]{0}) collective-permute-start(f32[8]{0} %w)
  %cp-done = f32[8]{0} collective-permute-done(%cp-start)
"""
    want = ref_hlo.collective_bytes(hlo)
    out = _run("""
        import json, torch
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        from repro_torch.analysis import trace as T
        from repro_torch.launch.dryrun import fake_world

        with fake_world(4):
            group = dist.group.WORLD
            with T.RankTrace() as tr:
                funcol.all_reduce(torch.ones(1024), "sum", group).wait()
                funcol.all_gather_tensor(torch.ones(16, 128, dtype=torch.bfloat16), 0,
                                         group).wait()
                funcol.reduce_scatter_tensor(torch.ones(64), "sum", 0, group).wait()
                funcol.permute_tensor(torch.ones(16), [1, 2, 3, 0], group).wait()
            kinds = [r.collective for r in tr.ops if r.collective]
        print(json.dumps({"bytes": T.collective_bytes(tr), "kinds": kinds,
                          "joined": dist.is_initialized()}))
    """)
    got = json.loads(out.strip().splitlines()[-1])
    assert got["bytes"] == want
    assert got["kinds"] == ["all-reduce", "all-gather", "reduce-scatter", "collective-permute"]
    assert not got["joined"]
