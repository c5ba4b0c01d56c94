"""The port's sharding specs against the JAX package's.

``tighten``, ``spec_for``, ``param_specs``, ``batch_spec`` and
``cache_shardings`` are pure shape logic: both packages run them on
device-free meshes (the reference's ``AbstractMesh``, the port's
``MeshShape``). The reference's params are ``jax.eval_shape``'s; the
port's come from its own ``lm.init`` under ``FakeTensorMode`` (shapes, no
memory), so full-size configs cost nothing.

The port keeps its layer stacks as lists (``layers/3/attn/wq/w``, shape
(d, h*hd)) where the reference stacks them (``layers/attn/wq/w``, (L, d,
h*hd)): a port leaf is compared with the reference's spec with its stacked
axes removed, and must equal it exactly. The optimizer's moments are
stacked in both packages, so their specs must be equal as they are. The
caches are stacked in both; the reference's per-layer ``len`` (L,) is the
port's one 0-d ``len`` (ROADMAP §C, kept on purpose), so the stacked axis
comes off there too.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import ParallelConfig as RefParallelConfig
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.dist import sharding as ref_shd
from repro.models import build_model as ref_build_model
from repro.train import step as ref_step
from repro_torch.configs import ARCH_IDS, ParallelConfig, TrainConfig, get_config
from repro_torch.dist import sharding as shd
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.train import step as port_step

torch.set_num_threads(1)

ARCHS = [a for a in ARCH_IDS if a in REF_ARCH_IDS]
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
SMALL_MESHES = [((2, 2), ("data", "model")), ((4, 2), ("data", "model"))]
PCFGS = {"default": {}, "fsdp_data": dict(fsdp_axes=("data",), data_axes=("data",))}


def _pair(name):
    kw = PCFGS[name]
    return ParallelConfig(**kw), RefParallelConfig(**kw)


def _ref_mesh(shape, names):
    return jax.sharding.AbstractMesh(shape, names)


def _norm(spec) -> tuple:
    """A spec as a plain tuple: entries None, a name, or a tuple of names."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in spec)


def _flat(tree, prefix=()):
    """(path, leaf) of a port tree (dicts, lists, NamedTuples)."""
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flat(getattr(tree, f), prefix + (f,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


def _ref_flat(tree) -> dict:
    """{path string: leaf} of a reference tree."""
    return {ref_shd._path_str(p): x for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _unstacked(path) -> tuple[str, int]:
    """The reference's path of a port leaf (list indices dropped) and the
    number of stacked axes that dropped."""
    return "/".join(str(p) for p in path if not isinstance(p, int)), sum(
        isinstance(p, int) for p in path)


@functools.lru_cache(maxsize=None)
def _trees(arch: str, reduced: bool):
    """(port params, reference params) of ``arch``: fake tensors and
    ShapeDtypeStructs."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    if reduced:
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    lm = build_model(cfg, device="cpu")
    with FakeTensorMode():
        params = lm.init(0)
    rparams = jax.eval_shape(ref_build_model(rcfg).init, jax.random.PRNGKey(0))
    return params, rparams


def _check_params(arch, reduced, shape, names, pcfg_name):
    params, rparams = _trees(arch, reduced)
    pcfg, rpcfg = _pair(pcfg_name)
    specs = shd.param_specs(params, pcfg, shd.MeshShape(shape, names))
    rspecs = _ref_flat(ref_shd.param_specs(rparams, rpcfg, _ref_mesh(shape, names)))
    seen = set()
    n_sharded = 0
    for path, spec in _flat(specs):
        key, n_stack = _unstacked(path)
        seen.add(key)
        want = _norm(rspecs[key])[n_stack:]
        assert _norm(spec) == want, (arch, path, spec, rspecs[key])
        n_sharded += any(e is not None for e in spec)
    assert seen == set(rspecs), (arch, set(rspecs) ^ seen)
    return n_sharded


@pytest.mark.parametrize("pcfg_name", sorted(PCFGS))
@pytest.mark.parametrize("mesh", MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference_on_production_meshes(arch, mesh, pcfg_name):
    """Every leaf of every arch at full size, on both production meshes."""
    assert _check_params(arch, False, *mesh, pcfg_name) > 0


@pytest.mark.parametrize("mesh", SMALL_MESHES, ids=["2x2", "4x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference_on_small_meshes(arch, mesh):
    """``.reduced()`` configs on the CPU tests' meshes."""
    _check_params(arch, True, *mesh, "fsdp_data")


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_factored"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "olmoe-1b-7b", "zamba2-2_7b",
                                  "seamless-m4t-medium"])
def test_state_shardings_equal_reference(arch, optimizer):
    """The optimizer's moments, stacked in both packages, and the factored
    statistics: equal specs as they are, on the production mesh."""
    params, rparams = _trees(arch, False)
    pcfg, rpcfg = _pair("fsdp_data")
    tcfg = TrainConfig(optimizer=optimizer)
    from repro_torch.train.optimizer import make_optimizer

    with FakeTensorMode():
        opt = make_optimizer(tcfg)[0](params)
    mesh = shd.MeshShape(*MESHES[0])
    specs = port_step.state_shardings({"params": params, "opt": opt}, pcfg, mesh)
    rtree = jax.eval_shape(
        lambda k: ref_step.make_train_state(
            ref_build_model(ref_get_config(arch)), RefTrainConfig(optimizer=optimizer), k),
        jax.random.PRNGKey(0))
    rmesh = _ref_mesh(*MESHES[0])
    for field in ("m", "v"):
        ropt = getattr(rtree["opt"], field)
        want = {ref_shd._path_str(p): _norm(ref_shd.spec_for(ref_shd._path_str(p), x.shape,
                                                             rpcfg, rmesh))
                for p, x in jax.tree_util.tree_flatten_with_path(ropt)[0]}
        got = {shd.path_str(p): _norm(s) for p, s in _flat(getattr(specs["opt"], field))}
        assert got == want, (arch, field)
    assert specs["opt"].step == shd.P()


def test_stacked_only_leaves_are_the_caches_len():
    """The one stacked-axis difference kept on purpose: no param leaf of any
    arch is stacked with no per-layer dim (the reference's fallback would
    shard the stack axis itself); only the caches' ``len`` is, (L,) in the
    reference against the port's one 0-d ``len``."""
    for arch in ARCHS:
        params, _ = _trees(arch, False)
        for path, leaf in _flat(params):
            assert not (_unstacked(path)[1] and leaf.dim() == 0), (arch, path)


def _ref_caches(arch, batch, max_len, reduced=True):
    rcfg = ref_get_config(arch)
    if reduced:
        rcfg = rcfg.reduced()
    rlm = ref_build_model(rcfg)
    rparams = jax.eval_shape(rlm.init, jax.random.PRNGKey(0))
    if rcfg.family == "encdec":
        b = {"src_embeds": jax.ShapeDtypeStruct((batch, 16, rcfg.d_model), jnp.float32),
             "tgt_tokens": jax.ShapeDtypeStruct((batch, 16), jnp.int32)}
    elif rcfg.family == "vlm":
        b = {"tokens": jax.ShapeDtypeStruct((batch, 16), jnp.int32),
             "prefix_embeds": jax.ShapeDtypeStruct((batch, 4, rcfg.d_model), jnp.float32)}
    else:
        b = {"tokens": jax.ShapeDtypeStruct((batch, 16), jnp.int32)}
    _, caches = jax.eval_shape(lambda p, x: rlm.prefill(p, x, max_len), rparams, b)
    return caches


def _port_caches(arch, batch, max_len):
    cfg = get_config(arch).reduced()
    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models import hybrid, ssm

        if cfg.family == "ssm":
            return {"mamba": ssm.mamba_init_state(cfg, batch, lead=(cfg.n_layers,)),
                    "len": torch.zeros((), dtype=torch.int32)}
        return hybrid.hybrid_init_caches(cfg, batch, max_len)
    caches = T.init_cache(cfg, batch, max_len, n_layers=cfg.n_layers)
    if cfg.family == "encdec":
        return {"self": caches}
    return caches


@pytest.mark.parametrize("mesh", SMALL_MESHES + MESHES[:1], ids=["2x2", "4x2", "16x16"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen2-72b", "mixtral-8x7b", "olmoe-1b-7b",
                                  "mamba2-130m", "zamba2-2_7b", "seamless-m4t-medium",
                                  "phi-3-vision-4_2b"])
@pytest.mark.parametrize("batch", [1, 4, 32])
def test_cache_shardings_equal_reference(arch, mesh, batch):
    """The serving caches of every family (enc-dec: the self-attention
    caches; the port's cross caches have ``max_len`` rows by design)."""
    pcfg, rpcfg = _pair("fsdp_data")
    max_len = 64
    port = _port_caches(arch, batch, max_len)
    ref = _ref_caches(arch, batch, max_len)
    if "self" in port:
        ref = {"self": ref["self"]}
    rspecs = _ref_flat(jax.tree.map(lambda s: s.spec,
                                    ref_shd.cache_shardings(ref, rpcfg, _ref_mesh(*mesh))))
    rshapes = _ref_flat(ref)
    got = dict(_flat(shd.cache_specs(port, pcfg, shd.MeshShape(*mesh))))
    assert {shd.path_str(p) for p in got} == set(rspecs), arch
    for path, spec in got.items():
        key = shd.path_str(path)
        leaf = dict(_flat(port))[path]
        n_stack = len(rshapes[key].shape) - leaf.dim()
        assert tuple(rshapes[key].shape[n_stack:]) == tuple(leaf.shape), (arch, key)
        assert _norm(spec) == _norm(rspecs[key])[n_stack:], (arch, key, spec, rspecs[key])


# The reference's own cases (tests/test_sharding.py) through both packages.


def _both(shape=(16, 16), axes=("data", "model")):
    return (shd, shd.MeshShape(shape, axes)), (ref_shd, _ref_mesh(shape, axes))


def test_tighten_drops_nondividing_axes():
    for mod, mesh in _both():
        assert _norm(mod.tighten((128, 60), ("data", "model"), mesh)) == ("data", None)
        assert _norm(mod.tighten((256, 256), ("data", "model"), mesh)) == ("data", "model")
        assert _norm(mod.tighten((3, 5), ("data", "model"), mesh)) == (None, None)


def test_tighten_multi_axis_prefix():
    for mod, mesh in _both((2, 16, 16), ("pod", "data", "model")):
        assert _norm(mod.tighten((32,), (("pod", "data"),), mesh)) == (("pod", "data"),)
        assert _norm(mod.tighten((16,), (("pod", "data"),), mesh)) == ("pod",)


@pytest.mark.parametrize("arch", ["deepseek-7b", "olmoe-1b-7b", "zamba2-2_7b"])
def test_param_specs_cover_all_leaves(arch):
    """Every leaf gets a spec of its rank, and some leaves shard."""
    params, _ = _trees(arch, True)
    mesh = shd.MeshShape((16, 16), ("data", "model"))
    specs = shd.param_specs(params, _pair("fsdp_data")[0], mesh)
    leaves = dict(_flat(params))
    n_sharded = 0
    for path, spec in _flat(specs):
        assert len(spec) == leaves[path].dim(), (path, spec)
        n_sharded += any(s is not None for s in spec)
    assert n_sharded > 0


def test_full_config_shards_model_axis():
    """On the production mesh the big matrices split: wq (d, H*hd) on data
    and model, the embedding's vocab on model."""
    params, _ = _trees("deepseek-7b", False)
    specs = shd.param_specs(params, ParallelConfig(fsdp_axes=("data",)),
                            shd.MeshShape((16, 16), ("data", "model")))
    assert all(layer["attn"]["wq"]["w"] == shd.P("data", "model") for layer in specs["layers"])
    assert specs["embed"]["table"][0] == "model"


def test_batch_spec_fallbacks():
    for (mod, mesh), pc in zip(_both(), _pair("fsdp_data")):
        assert mod.batch_spec(256, pc, mesh)[0] == "data"
        assert mod.batch_spec(1, pc, mesh)[0] is None  # can't shard batch=1


@pytest.mark.parametrize("n", [1, 6, 8, 12, 48, 256])
def test_batch_spec_equals_reference(n):
    for pcfg_name in PCFGS:
        pcfg, rpcfg = _pair(pcfg_name)
        for shape, names in MESHES + SMALL_MESHES:
            got = shd.batch_spec(n, pcfg, shd.MeshShape(shape, names))
            want = ref_shd.batch_spec(n, rpcfg, _ref_mesh(shape, names))
            assert _norm(got) == _norm(want), (n, pcfg_name, shape)


def test_placements_follow_mesh_dim_order():
    """A multi-axis entry is two ``Shard(d)`` in mesh-dim order; an entry
    against the mesh's order cannot be expressed and raises. The rules
    never make one: the FSDP and data axes are ("pod", "data") or a
    single axis, in the production mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:  # the attribute placements() reads of a DeviceMesh
        mesh_dim_names = ("pod", "data", "model")

    assert shd.placements(shd.P(("pod", "data"), "model"), Mesh) == (Shard(0), Shard(0),
                                                                      Shard(1))
    assert shd.placements(shd.P(None, "data"), Mesh) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh-dim order"):
        shd.placements(shd.P(("data", "pod")), Mesh)
    params, _ = _trees("llama3-405b", False)
    mesh = shd.MeshShape(*MESHES[1])
    for _, spec in _flat(shd.param_specs(params, ParallelConfig(), mesh)):
        shd.placements(spec, Mesh)


class _Mesh:
    """What the placement functions read of a ``DeviceMesh``: its dim names
    and its grid's shape."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.mesh = np.zeros(shape)


def test_shardings_are_the_specs_placements():
    """``param_shardings``, ``batch_shardings`` and ``cache_shardings`` are
    the specs' DTensor placements on a (2, 2) mesh."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Mesh((2, 2), ("data", "model"))
    pcfg = _pair("fsdp_data")[0]
    params, _ = _trees("deepseek-7b", True)
    got = shd.param_shardings(params, pcfg, mesh)
    specs = shd.param_specs(params, pcfg, mesh)
    for (path, pl), (_, spec) in zip(_flat(got), _flat(specs)):
        assert pl == shd.placements(spec, mesh), path
    assert got["layers"][0]["attn"]["wq"]["w"] == (Shard(0), Shard(1))
    assert got["embed"]["table"] == (Shard(1), Shard(0))
    batch = {"tokens": np.zeros((8, 64), np.int32), "n": np.zeros((), np.int32)}
    assert shd.batch_shardings(batch, pcfg, mesh) == {
        "tokens": (Shard(0), Replicate()), "n": (Replicate(), Replicate())}
    caches = _port_caches("deepseek-7b", 4, 64)
    cs = shd.cache_shardings(caches, pcfg, mesh)
    assert cs["k"] == (Shard(1), Shard(3)) and cs["len"] == (Replicate(), Replicate())


def test_specs_allocate_nothing():
    """The spec functions read shapes only: meta tensors do."""
    cfg = get_config("qwen2-72b")
    t = torch.empty((cfg.vocab, cfg.d_model), device="meta")
    spec = shd.spec_for("embed/table", t.shape, ParallelConfig(), shd.MeshShape(*MESHES[1]))
    want = ref_shd.spec_for("embed/table", (cfg.vocab, cfg.d_model), RefParallelConfig(),
                            _ref_mesh(*MESHES[1]))
    assert _norm(spec) == _norm(want)
    assert np.prod(t.shape) > 1e9
