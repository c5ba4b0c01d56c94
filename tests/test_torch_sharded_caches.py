"""Serving caches split across a mesh as the reference's ``cache_shardings``
lays them out, and the dry-run's uneven batches and sequence-sharded
residuals.

* Per-rank cache bytes: a reduced decode cell's caches, made by the port's
  ``make_serve_steps`` prefill on a fake process group (``FakeTensorMode``:
  shapes, no memory), hold on each rank exactly the shard shapes of the
  reference's ``cache_shardings`` on a matching ``AbstractMesh``: KV heads
  on the tensor axis (deepseek-7b on (4, 2)), the sequence where the heads
  do not divide it (mixtral-8x7b, 2 KV heads on 4), SSM states on the batch
  (mamba2-130m), at a batch the data axis divides and one it does not. The
  dry-run cell's ``alias_bytes`` are those shards and the 0-d ``len``.
* Uneven batches: every arch's three reduced cells at batch 2 on a fake (4,
  2) group trace; reduced deepseek-7b's train_4k there has the flops a rank
  of the same cell on (1, 2) (the data ranks each run the whole batch).
* Sequence sharding: the ``seq_shard_activations`` cell (reduced
  deepseek-7b train_4k on 2x2) traces with the flops of the cell without
  the rule, through all-gathers and reduce-scatters.
* The plain decode's lse (the sequence split's merge state) against a
  float64 log-sum-exp, and partial decodes over slices of a cache merged
  equal to the whole; ``write_local`` on plain tensors is the write it
  always was.

Each fake group runs in a subprocess (the group is process-wide).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import ParallelConfig as RefParallelConfig
from repro.configs import get_config as ref_get_config
from repro.dist import sharding as ref_shd
from repro.models import build_model as ref_build_model
from repro_torch.core.attention import MASK_VALUE, decode_attention, merge_decode_partials
from repro_torch.dist.context import write_local

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ARCHS = [a for a in REF_ARCH_IDS if a != "paper-gb10"]
MAX_LEN = 128  # the reduced decode_32k's
CACHE_LEAVES = ("k", "v", "k_scale", "v_scale", "conv", "ssd")


def _run(code: str, timeout: int = 420) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-8000:]}"
    return json.loads(r.stdout.strip().splitlines()[-1])


# (arch, mesh (data, model), batch): heads, the sequence, SSM states; each at
# a batch the data axis divides and one it does not (or, on (2, 4), does).
CASES = [("deepseek-7b", (4, 2), 4), ("deepseek-7b", (4, 2), 2),
         ("mixtral-8x7b", (2, 4), 4), ("mixtral-8x7b", (2, 4), 2),
         ("mamba2-130m", (4, 2), 4), ("mamba2-130m", (4, 2), 2)]


@pytest.fixture(scope="module")
def port_caches():
    """Each case's caches on rank 0 of a fake group: per leaf its global and
    local shapes, its item size and whether it is a DTensor; and the decode
    cell's alias bytes."""
    return _run(f"""
        import json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor
        from repro_torch.configs import ParallelConfig, get_config
        from repro_torch.dist import sharding as shd
        from repro_torch.launch.dryrun import fake_world, lower_cell
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import build_model
        from repro_torch.train.step import make_serve_steps

        pcfg = ParallelConfig(fsdp_axes=("data",), data_axes=("data",))
        out = {{}}
        for mesh_shape in sorted({{tuple(m) for _, m, _ in {CASES!r}}}):
            with fake_world(8):
                mesh = make_local_mesh(*mesh_shape, device="cpu")
                for arch, m, batch in {CASES!r}:
                    if tuple(m) != mesh_shape:
                        continue
                    with FakeTensorMode():
                        lm = build_model(get_config(arch).reduced(), device="cpu")
                        params = lm.init(0)
                        params = shd.distribute(params, shd.param_specs(params, pcfg, mesh), mesh)
                        prefill, _ = make_serve_steps(lm, pcfg, mesh, max_len={MAX_LEN})
                        _, caches = prefill(params, {{"tokens": torch.empty((batch, 16),
                                                                         dtype=torch.int32)}})
                    leaves = {{}}

                    def walk(t, pre):
                        if isinstance(t, dict):
                            for k, v in t.items():
                                walk(v, pre + (k,))
                            return
                        local = t.to_local() if isinstance(t, DTensor) else t
                        leaves["/".join(pre)] = [list(t.shape), list(local.shape),
                                                 local.element_size(), isinstance(t, DTensor)]
                    walk(caches, ())
                    rec, _ = lower_cell(arch, "decode_32k", mesh, "x".join(map(str, m)),
                                        reduced=True, shape_overrides={{"global_batch": batch}})
                    out[f"{{arch}} {{m[0]}}x{{m[1]}} {{batch}}"] = {{
                        "leaves": leaves, "alias": rec["memory"]["alias_bytes"],
                        "status": rec["status"]}}
        print(json.dumps(out))
    """)


def _ref_shards(arch, mesh, batch):
    """The reference's caches at this batch and ``MAX_LEN``: per leaf (by
    path) the global shape, its shard shape under ``cache_shardings`` on an
    ``AbstractMesh`` of ``mesh``, and the item size."""
    rcfg = ref_get_config(arch).reduced()
    rlm = ref_build_model(rcfg)
    rparams = jax.eval_shape(rlm.init, jax.random.PRNGKey(0))
    b = {"tokens": jax.ShapeDtypeStruct((batch, 16), jnp.int32)}
    _, caches = jax.eval_shape(lambda p, x: rlm.prefill(p, x, MAX_LEN), rparams, b)
    rpcfg = RefParallelConfig(fsdp_axes=("data",), data_axes=("data",))
    shardings = ref_shd.cache_shardings(caches, rpcfg,
                                        jax.sharding.AbstractMesh(mesh, ("data", "model")))
    out = {}
    for (path, leaf), (_, sh) in zip(jax.tree_util.tree_flatten_with_path(caches)[0],
                                     jax.tree_util.tree_flatten_with_path(shardings)[0]):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = (tuple(leaf.shape), tuple(sh.shard_shape(leaf.shape)),
                    np.dtype(leaf.dtype).itemsize)
    return out


@pytest.mark.parametrize("arch,mesh,batch", CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}-b{b}" for a, m, b in CASES])
def test_cache_shards_equal_the_reference_layout(port_caches, arch, mesh, batch):
    """Every cache leaf is a DTensor whose local shape on rank 0 is the
    reference's shard shape of the same leaf; the decode cell's alias bytes
    are those shards' bytes and the 0-d ``len``."""
    got = port_caches[f"{arch} {mesh[0]}x{mesh[1]} {batch}"]
    ref = _ref_shards(arch, mesh, batch)
    total = 0
    for key, (shape, local, item, is_dt) in got["leaves"].items():
        name = key.rsplit("/", 1)[-1]
        if name not in CACHE_LEAVES:
            assert not is_dt and shape == [], key  # len: plain, every rank whole
            continue
        rshape, rlocal, ritem = ref[key]
        assert is_dt and tuple(shape) == rshape and tuple(local) == rlocal, (key, local, rlocal)
        assert item == ritem, key
        total += int(np.prod(local)) * item
    assert got["status"] == "ok" and got["alias"] == total + 4


def test_kinds_of_split_are_the_reference_rules(port_caches):
    """Which dim each case splits: deepseek-7b's heads (2 on 2), mixtral's
    sequence (2 KV heads on 4), mamba2's batch only; batch 2 on 4 data
    ranks stays whole on them (so mamba2's states there are whole, as the
    reference's)."""
    def local(case, leaf):
        return port_caches[case]["leaves"][leaf][1]

    assert local("deepseek-7b 4x2 4", "k")[1:] == [1, MAX_LEN, 1, 16]
    assert local("deepseek-7b 4x2 2", "k")[1:] == [2, MAX_LEN, 1, 16]
    assert local("mixtral-8x7b 2x4 4", "k")[1:] == [2, 8, 2, 16]  # ring of 32 over 4
    assert local("mamba2-130m 4x2 4", "mamba/ssd")[1] == 1
    assert local("mamba2-130m 4x2 2", "mamba/ssd")[1] == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_uneven_batch_cells_trace(arch):
    """Batch 2 on a fake (4, 2) group: the data axis does not divide the
    batch, which stays replicated; every shape traces (a strided shard of
    the sequence failed here before, ROADMAP §C)."""
    got = _run(f"""
        import json
        from repro_torch.launch.dryrun import fake_world, lower_cell
        from repro_torch.launch.mesh import make_local_mesh

        out = {{}}
        with fake_world(8):
            mesh = make_local_mesh(4, 2, device="cpu")
            for shape in ("train_4k", "prefill_32k", "decode_32k"):
                rec, _ = lower_cell({arch!r}, shape, mesh, "4x2", reduced=True,
                                    shape_overrides={{"global_batch": 2}})
                out[shape] = [rec["status"], rec["cost"]["flops"]]
        print(json.dumps(out))
    """)
    for shape, (status, flops) in got.items():
        assert status == "ok" and flops > 0, (arch, shape)


def test_uneven_batch_runs_whole_on_each_data_rank():
    """Reduced deepseek-7b train_4k at batch 2: on (4, 2) each rank does
    the flops of a rank of (1, 2), exactly: the data ranks each run the
    whole batch, as the reference's tightened batch spec says."""
    got = _run("""
        import json
        from repro_torch.launch.dryrun import fake_world, lower_cell
        from repro_torch.launch.mesh import make_local_mesh

        out = {}
        for d in (4, 1):
            with fake_world(2 * d):
                rec, _ = lower_cell("deepseek-7b", "train_4k", make_local_mesh(d, 2, device="cpu"),
                                    f"{d}x2", reduced=True, shape_overrides={"global_batch": 2})
            out[d] = [rec["status"], rec["cost"]["flops"], rec["collectives"]]
        print(json.dumps(out))
    """)
    assert got["4"][0] == got["1"][0] == "ok"
    assert got["4"][1] == got["1"][1] > 0
    assert got["4"][2]["all-gather"] > got["1"][2].get("all-gather", 0)  # the params, on data


def test_sequence_sharded_residuals():
    """``seq_shard_activations`` (the residual's sequence on the tensor
    axis, Megatron's sequence parallelism) on reduced deepseek-7b train_4k
    on 2x2: the cell traces, with the flops of the cell without the rule,
    gathering the sequence before the column-parallel products and
    reduce-scattering the row-parallel partial sums back onto it."""
    got = _run("""
        import json
        from repro_torch.launch.dryrun import fake_world, lower_cell
        from repro_torch.launch.mesh import make_local_mesh

        out = {}
        with fake_world(4):
            mesh = make_local_mesh(2, 2, device="cpu")
            for on in (True, False):
                rec, _ = lower_cell("deepseek-7b", "train_4k", mesh, "2x2", reduced=True,
                                    par_overrides={"seq_shard_activations": on})
                out[str(on)] = [rec["status"], rec["cost"]["flops"], rec["collectives"]]
        print(json.dumps(out))
    """)
    (s_on, f_on, c_on), (s_off, f_off, _) = got["True"], got["False"]
    assert s_on == s_off == "ok"
    assert f_on == f_off > 0
    assert c_on["all-gather"] > 0 and c_on["reduce-scatter"] > 0


def _lse64(q, k, lens, scale):
    """float64 log-sum-exp of each row's scaled scores over its valid
    positions, (B, Hq); -inf where none."""
    qd, kd = q.double().numpy()[:, 0], k.double().numpy()
    b, hq, _ = qd.shape
    g = hq // kd.shape[2]
    out = np.full((b, hq), -np.inf)
    for i in range(b):
        n = int(lens[i])
        if n == 0:
            continue
        for h in range(hq):
            s = kd[i, :n, h // g] @ qd[i, h] * scale
            out[i, h] = np.log(np.exp(s - s.max()).sum()) + s.max()
    return out


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_plain_decode_lse_and_merge(hq, hkv):
    """``decode_attention(return_lse=True)``: the output equals the plain
    decode's, the lse a float64 log-sum-exp's (``MASK_VALUE`` and exact
    zeros for a row of length 0); halves and quarters of the cache, each
    with its local lengths, merged by ``merge_decode_partials`` equal the
    whole within 1e-6; merging by plain averaging or dropping one half's
    lse does not."""
    g = torch.Generator().manual_seed(11)
    b, s, d = 4, 64, 16
    q = torch.randn(b, 1, hq, d, generator=g)
    k, v = torch.randn(b, s, hkv, d, generator=g), torch.randn(b, s, hkv, d, generator=g)
    lens = torch.tensor([0, 5, 40, 64], dtype=torch.int32)
    o, lse = decode_attention(q, k, v, lens, return_lse=True)
    torch.testing.assert_close(o[1:], decode_attention(q, k, v, lens)[1:], rtol=1e-6, atol=1e-6)
    assert torch.equal(o[0], torch.zeros_like(o[0])) and bool((lse[0] == MASK_VALUE).all())
    want = _lse64(q, k, lens, d ** -0.5)
    np.testing.assert_allclose(lse[1:].double().numpy(), want[1:], rtol=1e-6, atol=1e-6)
    for n in (2, 4):
        w = s // n
        parts = [decode_attention(q, k[:, i * w:(i + 1) * w], v[:, i * w:(i + 1) * w],
                                  torch.clamp(lens - i * w, 0, w), return_lse=True)
                 for i in range(n)]
        po, pl = torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
        mo, ml = merge_decode_partials(po, pl)
        torch.testing.assert_close(mo, o, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(ml, lse, rtol=1e-6, atol=1e-6)
        assert (po.mean(0) - o).abs().max() > 1e-2                     # averaged
        dropped = merge_decode_partials(po, torch.cat([pl[:1] * 0 + MASK_VALUE, pl[1:]]))[0]
        assert (dropped - o).abs().max() > 1e-2                         # one lse dropped


def test_write_local_on_plain_tensors_is_the_old_write():
    """Off a mesh ``write_local`` is ``index_copy_`` along dim 1 (rows) or
    ``copy_`` (a whole state), in the destination's dtype."""
    g = torch.Generator().manual_seed(2)
    cache = torch.randn(2, 8, 3, 4, generator=g)
    want = cache.clone()
    val = torch.randn(2, 3, 3, 4, generator=g, dtype=torch.float64)
    rows = torch.tensor([2, 3, 4])
    want.index_copy_(1, rows, val.float())
    write_local(cache, val, rows)
    assert torch.equal(cache, want)
    state = torch.zeros(2, 5)
    new = torch.randn(2, 5, generator=g)
    write_local(state, new)
    assert torch.equal(state, new)
