"""The port's sharded paths on CPU meshes: several gloo processes.

A CPU has no devices to split, so a mesh larger than 1x1 is N processes,
each one rank of a ``torch.distributed`` gloo group joined on a
``FileStore`` under ``tmp_path`` (the counterpart of the reference's
``--xla_force_host_platform_device_count`` in ``tests/test_multidevice.py``).
Every group is joined with a 60 s timeout and the script runs under a
subprocess timeout, so a lost rank fails the test instead of hanging it.
One module-scoped run of 4 ranks does the work and saves each rank's
results; the tests read them:

* the sharded train step on a 2x2 mesh (FSDP and the batch on "data", TP
  on "model", 2 microbatches) from the reference's weights, against the
  unsharded port's step on the same weights and batches: each step's loss
  and gradient norm, and params after 2 steps, at f32 tolerance (a sum of
  the data ranks' gradients, or one rank's half of the batch, moves the
  gradient norm past it), beside the reference's 5e-3 on the loss
  (``test_multidevice.py:30-61``); the params really split. The unsharded
  step is in turn held to the reference's ``make_train_step`` (losses and
  gradient norms), which ties the sharded step to the JAX package;
* ``reduce_grads_compressed`` over the mesh's "data" dim against a host
  computation of the reference's ``pmean`` of its own ``quantize_int8``;
* ``elastic_remesh`` onto 3 of the 4 ranks and a restore of the 2x2
  checkpoint there (``state_shardings``), params equal and a finite step;
* a sharded ``ServeEngine`` (static and continuous) twice: the two runs
  equal, and the streams equal the unsharded port's at the reference's tie
  tolerance (``test_multidevice.py:174-215``); one step of each kind under
  the host-read guard of ``test_torch_step_graph.py`` (``NoHostRead``), the
  continuous ones over pools split on their KV heads;
* ``make_serve_steps`` on 2x2 and on a (1, 4) mesh over the same group:
  the caches placed by ``cache_shardings`` (KV heads, or the sequence where
  2 KV heads do not divide 4), their local shapes the reference's shard
  shapes, the prefill and two decode steps' logits against the unsharded
  port's; the static engine on 1x4 twice, and its decode step under the
  guard;
* ``constrain`` inside and outside an activation-rules context.

``usable_mesh_shape`` on the reference's cases, the mesh builders' refusal
of a size the process group does not have, importing them without touching
a device, and ``--mesh 2x1`` through the train launcher run on their own.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import torch

from repro.configs import ParallelConfig as RefParallelConfig
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.dist import compression as ref_comp
from repro.launch.mesh import make_local_mesh as ref_local_mesh
from repro.models import build_model as ref_build_model
from repro.train import fault_tolerance as ref_ft
from repro.train import step as ref_step
from repro_torch.configs import ParallelConfig, TrainConfig, get_config
from repro_torch.dist import compression
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.testing import params_from_jax
from repro_torch.train import fault_tolerance as ft
from repro_torch.train.step import make_train_state, make_train_step

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
WORLD = 4
TCFG = dict(lr=1e-3, warmup_steps=0)
# The train step's params compared after the steps: the embedding (its
# gradient gathered back from the whole-table lookup), an attention and an
# FFN weight split on both mesh dims, the final norm.
LEAVES = (("embed", "table"), ("layers", 0, "attn", "wq", "w"),
          ("layers", 1, "ffn", "w_down", "w"), ("ln_f", "scale"))

_HARNESS = '''
import datetime, os, sys, traceback
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        res = body(rank, world, out)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mp.spawn(_rank, args=(world, store, out), nprocs=world)
'''

# The MoE and SSM families' serving, sharded in the ranks and unsharded here.
_FAMILIES = '''
FAMILIES = (("olmoe-1b-7b", "continuous"), ("mamba2-130m", "static"))
FAMILY_KW = {"continuous": dict(page_size=8, prefill_chunk=16), "static": {}}


def family_reqs():
    rng = np.random.default_rng(4)
    return [Request(tokens=rng.integers(2, 200, size=6 + 5 * i).astype(np.int32),
                    max_new_tokens=4, rid=i) for i in range(3)]
'''
exec(_FAMILIES)

_BODY = '''
from torch.distributed.tensor import DTensor, Replicate, Shard
# The guard every captured step is held to. A dispatch mode sees the ops
# called on DTensors, not the local ops DTensor's own dispatch issues under
# them: the card's graph capture (chip_smoke's sharded-serve) is the only
# check of reads there.
from test_torch_step_graph import NoHostRead

from repro_torch.configs import ParallelConfig, TrainConfig, get_config
from repro_torch.dist import activation_rules, constrain, reduce_grads_compressed, init_residuals
from repro_torch.dist.sharding import P
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import elastic_remesh
from repro_torch.train.step import (make_serve_steps, make_train_state, make_train_step,
                                    shard_state, state_shardings)
from repro_torch.dist.sharding import distribute, param_specs

PCFG = ParallelConfig(fsdp_axes=("data",), data_axes=("data",), microbatches=2)


def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def body(rank, world, out):
    res = {}
    mesh = make_local_mesh(2, 2, device="cpu")
    try:
        make_local_mesh(2, 1, device="cpu")
        res["wrong_size"] = None
    except ValueError as e:
        res["wrong_size"] = str(e)
    cfg = get_config("deepseek-7b").reduced()
    lm = build_model(cfg, device="cpu")

    # -- the sharded train step, from the reference's weights
    inputs = torch.load(os.path.join(os.path.dirname(out), "inputs.pt"), weights_only=False)
    tcfg = TrainConfig(**TCFG)
    batch = {"tokens": inputs["batches"][0]}
    state = make_train_state(lm, tcfg, 0, device="cpu")
    state = shard_state(dict(state, params=inputs["params"]), PCFG, mesh)
    wq = state["params"]["layers"][0]["attn"]["wq"]["w"]
    res["wq"] = (tuple(wq.placements), tuple(wq.shape), tuple(wq.to_local().shape))
    step = make_train_step(lm, tcfg, PCFG, mesh)
    res["losses"], res["grad_norms"] = [], []
    for b in inputs["batches"]:
        state, m = step(state, {"tokens": b})
        res["losses"].append(float(m["loss"]))
        res["grad_norms"].append(float(m["grad_norm"]))
    res["metrics_plain"] = all(not isinstance(v, DTensor) for v in m.values())
    res["leaves"] = [leaf(state["params"], p).full_tensor() for p in LEAVES]

    # -- the compressed all-reduce over "data"
    g = {"w": torch.from_numpy(np.random.default_rng(10 + rank).normal(size=(3, 100))
                               .astype(np.float32))}
    red, new_r = reduce_grads_compressed(g, init_residuals(g), (mesh, "data"))
    res["grad"], res["reduced"], res["residual"] = g["w"], red["w"], new_r["w"]
    res["coord"] = mesh.get_coordinate()

    # -- a checkpoint of the 2x2 state, restored onto 3 survivors
    ck = CheckpointManager(os.path.join(out, "ck"), keep=2)
    ck.save(state, 1, blocking=True)
    full = {k: v.full_tensor() for k, v in state["params"]["layers"][1]["ffn"]["w_up"].items()}
    dist.barrier()
    small = elastic_remesh([0, 1, 2], model_parallel=2, device_type="cpu")
    res["small_shape"] = tuple(small.mesh.shape)
    if small.get_coordinate() is not None:
        template = make_train_state(lm, tcfg, 5, device="cpu")
        sh = state_shardings(template, PCFG, small)
        restored, n = ck.restore_latest(template, shardings=sh, mesh=small)
        got = restored["params"]["layers"][1]["ffn"]["w_up"]["w"]
        res["restored_equal"] = bool(torch.equal(got.full_tensor(), full["w"])) and n == 1
        res["restored_step"] = restored["opt"].step
        step6 = make_train_step(lm, tcfg, PCFG, small)
        _, m6 = step6(restored, {"tokens": batch["tokens"][:6]})
        res["restored_loss"] = float(m6["loss"])
    dist.barrier()

    # -- sharded serving, both engines, twice each
    params = lm.init(0)
    prompt = np.arange(2, 10, dtype=np.int32)
    reqs = [Request(tokens=prompt + 3 * i, max_new_tokens=5, rid=i) for i in range(4)]
    for sched, kw in (("static", {}), ("continuous", dict(page_size=8, prefill_chunk=16))):
        eng = ServeEngine(lm, params, batch_size=4, max_len=64, mesh=mesh, scheduler=sched,
                          device="cpu", **kw)
        a = eng.generate(reqs)
        b = eng.generate(reqs)
        res[sched] = [[r.tokens.tolist() for r in a], [r.tokens.tolist() for r in b]]
        res[sched + "_params_sharded"] = isinstance(
            eng.params["layers"][0]["attn"]["wo"]["w"], DTensor)
        for name, st in eng.step_graphs().items():
            with NoHostRead():
                logits, greedy = st()
            res[f"guard {sched} {name}"] = bool(torch.isfinite(logits).all())
        if sched == "continuous":
            res["continuous pools"] = {k: tuple(t.placements)
                                       for k, t in eng.last_pool.pages.items()}

    # -- the MoE (dropless: ragged_dot) and SSM (ssd) families, sharded
    for arch, sched in FAMILIES:
        flm = build_model(get_config(arch).reduced(), device="cpu")
        eng = ServeEngine(flm, flm.init(0), batch_size=2, max_len=64, mesh=mesh,
                          scheduler=sched, device="cpu", **FAMILY_KW[sched])
        res["family " + arch] = [r.tokens.tolist() for r in eng.generate(family_reqs())]

    # -- make_serve_steps: prefill and one decode step on the mesh
    prefill, decode = make_serve_steps(lm, PCFG, mesh, max_len=32)
    dparams = distribute(params, param_specs(params, PCFG, mesh), mesh)
    toks = torch.as_tensor(batch["tokens"][:4, :12])
    logits, caches = prefill(dparams, {"tokens": toks})
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    logits2, _ = decode(dparams, nxt, caches)
    res["serve_steps"] = (logits, logits2, isinstance(logits, DTensor))

    # -- caches placed by cache_shardings: heads on 2x2, the sequence on 1x4
    mesh14 = make_local_mesh(1, 4, device="cpu")
    for name, m in (("2x2", mesh), ("1x4", mesh14)):
        prefill, decode = make_serve_steps(lm, PCFG, m, max_len=32)
        mparams = distribute(params, param_specs(params, PCFG, m), m)
        steps = [prefill(mparams, {"tokens": toks})]
        for _ in range(2):
            nxt = steps[-1][0][:, -1].argmax(-1).to(torch.int32)[:, None]
            steps.append(decode(mparams, nxt, steps[-1][1]))
        res["split " + name] = (
            [lg for lg, _ in steps],
            {k: (type(c).__name__, tuple(c.shape), tuple(c.to_local().shape)
                 if isinstance(c, DTensor) else tuple(c.shape))
             for k, c in steps[-1][1].items()})

    # -- the static engine on 1x4 (every cache split along its sequence), twice
    eng = ServeEngine(lm, params, batch_size=4, max_len=64, mesh=mesh14, scheduler="static",
                      device="cpu")
    a = eng.generate(reqs)
    b = eng.generate(reqs)
    res["static 1x4"] = [[r.tokens.tolist() for r in a], [r.tokens.tolist() for r in b]]
    res["static 1x4 caches"] = {k: tuple(c.placements) for k, c in eng._decode_caches.items()
                                if isinstance(c, DTensor)}
    with NoHostRead():
        logits, _ = eng.step_graphs()["decode"]()
    res["guard static 1x4 decode"] = bool(torch.isfinite(logits).all())

    # -- constrain
    x = DTensor.from_local(torch.ones(4, 6), mesh, [Replicate(), Replicate()])
    res["constrain_off"] = constrain(x, "residual") is x
    with activation_rules({"residual": P("data", "model"), "moe_tokens": P("data")}):
        y = constrain(x, "residual")
        z = constrain(x, "moe_tokens")
        u = constrain(x, "unlisted")
        plain = torch.ones(3)
        res["constrain_plain"] = constrain(plain, "residual") is plain
    res["constrain_on"] = (tuple(y.placements), tuple(z.placements), u is x,
                           bool(torch.equal(y.full_tensor(), x.full_tensor())))
    return res
'''


def _run_ranks(tmp: Path, body: str, inputs: dict, world: int = WORLD,
               timeout: int = 420) -> list:
    script = tmp / "ranks.py"
    script.write_text(f"TCFG = {TCFG!r}\nLEAVES = {LEAVES!r}\n" + _FAMILIES + body + _HARNESS)
    torch.save(inputs, tmp / "inputs.pt")
    out = tmp / "out"
    out.mkdir()
    # The tests' folder for the host-read guard of test_torch_step_graph.py.
    path = os.pathsep.join([str(SRC), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), str(world), str(tmp / "store"), str(out)],
                       capture_output=True, text=True, env=env, timeout=timeout, cwd=tmp)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-8000:]}"
    return [torch.load(out / f"rank{i}.pt", weights_only=False) for i in range(world)]


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def reference():
    """The reference's reduced deepseek-7b weights (PRNGKey(0)), one batch
    of 8 x 64 taken twice (the second loss reads the first update), and
    the reference's ``make_train_step`` (2 microbatches, on its 1x1 mesh)
    over them: losses and gradient norms."""
    jcfg = ref_get_config("deepseek-7b").reduced()
    jlm = ref_build_model(jcfg)
    jparams = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
    batches = [np.random.default_rng(1).integers(0, jcfg.vocab, (8, 64)).astype(np.int32)] * 2
    rtcfg = RefTrainConfig(**dataclasses.asdict(TrainConfig(**TCFG)))
    mesh = ref_local_mesh(1, 1)
    with jax.set_mesh(mesh):
        jstate = ref_step.make_train_state(jlm, rtcfg, jax.random.PRNGKey(0))
        jstate = dict(jstate, params=jax.tree.map(jnp.asarray, jparams))
        _, compile_step = ref_step.make_train_step(jlm, rtcfg, RefParallelConfig(microbatches=2),
                                                   mesh)
        compiled = compile_step(jstate, {"tokens": jnp.asarray(batches[0])})
        losses, gnorms = [], []
        for b in batches:
            jstate, m = compiled(jstate, {"tokens": jnp.asarray(b)})
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    return {"params": jparams, "batches": batches, "losses": losses, "grad_norms": gnorms}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    inputs = {"params": params_from_jax(reference["params"]), "batches": reference["batches"]}
    return _run_ranks(tmp_path_factory.mktemp("mesh2x2"), _BODY, inputs)


@pytest.fixture(scope="module")
def single(reference):
    """The unsharded port: the same train steps from the same weights, and
    the same serving."""
    cfg = get_config("deepseek-7b").reduced()
    lm = build_model(cfg, device="cpu")
    tcfg = TrainConfig(**TCFG)
    state = make_train_state(lm, tcfg, 0, device="cpu")
    state = dict(state, params=params_from_jax(reference["params"]))
    step = make_train_step(lm, tcfg, ParallelConfig(microbatches=2))
    losses, gnorms = [], []
    for b in reference["batches"]:
        state, m = step(state, {"tokens": b})
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    leaves = [_leaf(state["params"], p).detach().clone() for p in LEAVES]
    prompt = np.arange(2, 10, dtype=np.int32)
    reqs = [Request(tokens=prompt + 3 * i, max_new_tokens=5, rid=i) for i in range(4)]
    streams = {}
    for sched, kw in (("static", {}), ("continuous", dict(page_size=8, prefill_chunk=16))):
        eng = ServeEngine(lm, lm.init(0), batch_size=4, max_len=64, scheduler=sched,
                          device="cpu", **kw)
        streams[sched] = [r.tokens.tolist() for r in eng.generate(reqs)]
    for arch, sched in FAMILIES:  # noqa: F821 (defined by _FAMILIES)
        flm = build_model(get_config(arch).reduced(), device="cpu")
        eng = ServeEngine(flm, flm.init(0), batch_size=2, max_len=64, scheduler=sched,
                          device="cpu", **FAMILY_KW[sched])  # noqa: F821
        streams["family " + arch] = [r.tokens.tolist()
                                     for r in eng.generate(family_reqs())]  # noqa: F821
    return {"losses": losses, "grad_norms": gnorms, "leaves": leaves, "streams": streams}


# Two f32 runs whose sums run in another order (the sharded matmuls' partial
# sums, the gradients' reductions over the data ranks): losses and gradient
# norms agree to ~1e-6 relative. Summing the data ranks' gradients instead
# of averaging them doubles the gradient norm; one rank's half of the batch
# moves it by ~1e-2. AdamW divides each gradient by its own running scale,
# so where a gradient is near 0 that reordering moves the update by up to
# ~1e-3 of lr: the params are held to 1e-2 of lr, where one rank's half of
# the batch moves many of them by about lr.
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-2 * TCFG["lr"])


def test_unsharded_train_step_equals_reference(reference, single):
    """The 1x1 side of the sharded comparison (the port's step, no mesh,
    2 microbatches, from the reference's weights) against the reference's
    ``make_train_step`` on the same batches: losses and gradient norms
    within 1e-4, as ``test_torch_train.py`` holds the unsharded step."""
    np.testing.assert_allclose(single["losses"], reference["losses"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(single["grad_norms"], reference["grad_norms"], rtol=1e-4,
                               atol=1e-4)
    assert single["losses"][1] < single["losses"][0]


def test_sharded_train_step_matches_single_device(ranks, single):
    """2x2 against 1x1 over 2 steps of 2 microbatches: each step's loss and
    gradient norm at f32 tolerance (STEP_TOL), the params after the steps
    (PARAM_TOL), and the loss within the reference's 5e-3; every rank reads
    the same metrics; wq (d, H*hd) is split on both mesh dims."""
    from torch.distributed.tensor import Shard

    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        assert r["grad_norms"] == ranks[0]["grad_norms"]
        assert r["metrics_plain"]
        assert abs(r["losses"][1] - single["losses"][1]) < 5e-3, (r["losses"], single)
        np.testing.assert_allclose(r["losses"], single["losses"], **STEP_TOL)
        np.testing.assert_allclose(r["grad_norms"], single["grad_norms"], **STEP_TOL)
        for path, got, want in zip(LEAVES, r["leaves"], single["leaves"]):
            torch.testing.assert_close(got, want, **PARAM_TOL, msg=lambda m, p=path: f"{p}: {m}")
        placements, shape, local = r["wq"]
        assert placements == (Shard(0), Shard(1))
        assert local == (shape[0] // 2, shape[1] // 2)


def test_compressed_allreduce_equals_host_pmean(ranks):
    """Each rank's reduced gradient is the mean over its "data" group of the
    reference's dequantized int8 blocks, to the bit; the residual is the
    rank's own quantization error; the port's ``quantize_int8`` is the
    reference's, bit for bit."""
    for r in ranks:
        group = [q for q in ranks if q["coord"][1] == r["coord"][1]]
        locals_ = []
        for q in group:
            g = q["grad"].numpy()
            rq, rs = ref_comp.quantize_int8(jnp.asarray(g))
            pq, ps = compression.quantize_int8(q["grad"])
            np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
            np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
            locals_.append(np.asarray(ref_comp.dequantize_int8(rq, rs, g.shape, jnp.float32)))
        want = (locals_[0] + locals_[1]) / np.float32(2)
        np.testing.assert_array_equal(r["reduced"].numpy(), want)
        mine = locals_[[q["coord"] for q in group].index(r["coord"])]
        np.testing.assert_array_equal(r["residual"].numpy(), r["grad"].numpy() - mine)
        assert np.abs(r["residual"].numpy()).sum() > 0


def test_restore_onto_a_smaller_mesh(ranks):
    """The 2x2 state's checkpoint restores onto 3 survivors (a 3x1 mesh):
    params equal the saved ones, the step count comes back, and a step
    there gives a finite loss. The rank left out holds no coordinate."""
    for r in ranks:
        assert r["small_shape"] == (3, 1)
    for r in ranks[:3]:
        assert r["restored_equal"] and r["restored_step"] == 2
        assert np.isfinite(r["restored_loss"])
    assert "restored_equal" not in ranks[3]


@pytest.mark.parametrize("sched", ["static", "continuous"])
def test_sharded_serve_engine(ranks, single, sched):
    """Sharded params, the same streams on every rank and in both runs, and
    the unsharded port's streams (the reference's tie tolerance: at least
    3 of 4 equal)."""
    first = ranks[0][sched][0]
    for r in ranks:
        assert r[sched + "_params_sharded"]
        a, b = r[sched]
        assert a == b == first
    same = sum(x == y for x, y in zip(first, single["streams"][sched]))
    assert same >= 3, (first, single["streams"][sched])
    assert all(len(s) >= 1 for s in first)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-130m"])
def test_sharded_moe_and_ssm_serving(ranks, single, arch):
    """The MoE's dropless grouped products (``ragged_dot``) and the SSD scan
    on their local blocks: sharded streams equal the unsharded port's at
    the reference's tie tolerance (all but one request)."""
    want = single["streams"]["family " + arch]
    for r in ranks:
        got = r["family " + arch]
        assert got == ranks[0]["family " + arch]
        assert sum(x == y for x, y in zip(got, want)) >= len(want) - 1, (got, want)


def test_sharded_steps_read_no_host_value(ranks):
    """Each captured kind of step, sharded, under the host-read guard: the
    continuous steps over pools split on their KV heads (each rank's head
    shard, ``Shard(3)`` of (L, n_pages, page, Hkv, hd) on "model")."""
    from torch.distributed.tensor import Replicate, Shard

    keys = [k for k in ranks[0] if k.startswith("guard ")]
    assert {"guard static decode", "guard continuous mixed/1",
            "guard continuous mixed/16"} <= set(keys), keys
    for r in ranks:
        assert all(r[k] for k in keys)
        assert r["continuous pools"] == {"k_pages": (Replicate(), Shard(3)),
                                         "v_pages": (Replicate(), Shard(3))}


def test_make_serve_steps_on_the_mesh(ranks):
    """The dry-run's serve steps on the 2x2 mesh: whole logits on every
    rank, within 1e-4 of the unsharded prefill and decode step's."""
    cfg = get_config("deepseek-7b").reduced()
    lm = build_model(cfg, device="cpu")
    params = lm.init(0)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (8, 64))
                           .astype(np.int32)[:4, :12])
    logits, caches = lm.prefill(params, {"tokens": toks}, 32)
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    logits2, _ = lm.decode_step(params, nxt, caches)
    for r in ranks:
        got, got2, is_dt = r["serve_steps"]
        assert not is_dt
        torch.testing.assert_close(got, logits, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got2, logits2, atol=1e-4, rtol=1e-4)


def _ref_cache_shards(mesh_shape, batch, max_len):
    """The reference's reduced deepseek-7b caches: per leaf its shard shape
    under ``cache_shardings`` on an ``AbstractMesh`` of ``mesh_shape``."""
    from repro.dist import sharding as ref_shd

    rcfg = ref_get_config("deepseek-7b").reduced()
    rlm = ref_build_model(rcfg)
    rparams = jax.eval_shape(rlm.init, jax.random.PRNGKey(0))
    b = {"tokens": jax.ShapeDtypeStruct((batch, 12), jnp.int32)}
    _, caches = jax.eval_shape(lambda p, x: rlm.prefill(p, x, max_len), rparams, b)
    sh = ref_shd.cache_shardings(caches, RefParallelConfig(fsdp_axes=("data",),
                                                           data_axes=("data",)),
                                 jax.sharding.AbstractMesh(mesh_shape, ("data", "model")))
    return {k: tuple(sh[k].shard_shape(caches[k].shape)) for k in ("k", "v")}


@pytest.mark.parametrize("name,mesh_shape", [("2x2", (2, 2)), ("1x4", (1, 4))])
def test_make_serve_steps_split_caches(ranks, name, mesh_shape):
    """``make_serve_steps`` on 2x2 (KV heads on "model") and 1x4 (2 KV
    heads on 4 ranks: the sequence, each rank's partial decode merged by
    log-sum-exp): the prefill and 2 decode steps' logits within 1e-4 of the
    unsharded port's on every rank, and each rank's K/V a DTensor holding
    the reference's shard shape; ``len`` a plain 0-d tensor."""
    cfg = get_config("deepseek-7b").reduced()
    lm = build_model(cfg, device="cpu")
    params = lm.init(0)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (8, 64))
                           .astype(np.int32)[:4, :12])
    logits, caches = lm.prefill(params, {"tokens": toks}, 32)
    want = [logits]
    for _ in range(2):
        nxt = want[-1][:, -1].argmax(-1).to(torch.int32)[:, None]
        lg, caches = lm.decode_step(params, nxt, caches)
        want.append(lg)
    shards = _ref_cache_shards(mesh_shape, 4, 32)
    for r in ranks:
        got, leaves = r["split " + name]
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        assert leaves["len"] == ("Tensor", (), ())
        for k in ("k", "v"):
            kind, shape, local = leaves[k]
            assert kind == "DTensor" and local == shards[k] and local != shape, (k, local)


def test_static_engine_on_a_sequence_split_mesh(ranks, single):
    """The static engine on 1x4: its caches split along the sequence
    (``Shard(2)`` of the stacked (L, B, S, H, D) on "model", the batch on
    the one-rank "data"), the same
    streams on every rank and in both runs, the unsharded port's at the
    reference's tie tolerance (at least 3 of 4 equal), and its captured
    decode step under the host-read guard."""
    from torch.distributed.tensor import Shard

    first = ranks[0]["static 1x4"][0]
    for r in ranks:
        a, b = r["static 1x4"]
        assert a == b == first
        assert r["static 1x4 caches"] == {"k": (Shard(1), Shard(2)), "v": (Shard(1), Shard(2))}
        assert r["guard static 1x4 decode"]
    same = sum(x == y for x, y in zip(first, single["streams"]["static"]))
    assert same >= 3, (first, single["streams"]["static"])


def test_constrain_identity_outside_rules_and_placements_inside(ranks):
    """Outside a rules context ``constrain`` returns its input itself;
    inside one, a listed role is redistributed to its placements (same
    values), an unlisted role and a plain tensor pass through."""
    from torch.distributed.tensor import Replicate, Shard

    for r in ranks:
        assert r["constrain_off"] and r["constrain_plain"]
        res_pl, tok_pl, unlisted, same = r["constrain_on"]
        assert res_pl == (Shard(0), Shard(1))
        assert tok_pl == (Shard(0), Replicate())
        assert unlisted and same


def test_constrain_is_the_identity_without_rules():
    from repro_torch.dist.context import activation_rules, constrain, current_rules

    x = torch.randn(2, 3)
    assert constrain(x, "residual") is x and current_rules() is None
    with activation_rules({"residual": ("data",)}):
        assert current_rules() == {"residual": ("data",)}
        assert constrain(x, "residual") is x  # a plain tensor: nothing to place
        with activation_rules(None):
            assert current_rules() is None
    assert current_rules() is None


def test_mesh_builders(ranks):
    """A mesh of another size than the process group raises instead of
    building something else; without a group only a 1-rank mesh joins one
    on its own."""
    for r in ranks:
        assert "needs 2 ranks; the process group has 4" in r["wrong_size"]
    from repro_torch.launch import mesh as port_mesh

    assert port_mesh.production_mesh_shape().shape == {"data": 16, "model": 16}
    assert port_mesh.production_mesh_shape(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="process group of 256 ranks"):
        port_mesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group of 512 ranks"):
        port_mesh.make_production_mesh(multi_pod=True, device="cpu")


def test_importing_the_mesh_module_touches_no_device_state():
    code = ("import torch, repro_torch.launch.mesh, repro_torch.dist, repro_torch.train.step\n"
            "assert not torch.distributed.is_initialized()\n"
            "assert not torch.cuda.is_initialized()\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.mark.parametrize("n,mp,want", [(6, 4, (3, 2)), (8, 4, (2, 4)), (7, 4, (7, 1)),
                                       (16, 16, (1, 16)), (12, 8, (3, 4)), (1, 2, (1, 1))])
def test_usable_mesh_shape_equals_reference(n, mp, want):
    assert ft.usable_mesh_shape(n, model_parallel=mp) == want
    assert ref_ft.usable_mesh_shape(n, model_parallel=mp) == want


def test_quantize_int8_equals_reference_on_odd_sizes():
    """Blockwise int8 with padding, an all-zero block and ties at .5: the
    payload and scales equal the reference's, and dequantizing trims the
    padding."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 117)).astype(np.float32)
    x[2] = 0.0
    x[0, :4] = [127.0, 0.5, 1.5, -2.5]
    for block in (256, 64):
        rq, rs = ref_comp.quantize_int8(jnp.asarray(x), block=block)
        q, s = compression.quantize_int8(torch.from_numpy(x), block=block)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        back = compression.dequantize_int8(q, s, x.shape, torch.float32)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(ref_comp.dequantize_int8(rq, rs, x.shape, jnp.float32)))


def test_train_launcher_runs_on_a_gloo_mesh(tmp_path):
    """``--mesh 2x1`` starts two gloo ranks and trains; rank 0 reports."""
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "deepseek-7b",
         "--reduced", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "32",
         "--mesh", "2x1", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.count("done: final_step=1 resumed_from=None") == 1, r.stdout
    assert "interrupted=False" in r.stdout
