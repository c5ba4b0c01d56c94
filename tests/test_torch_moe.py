"""The port's MoE family (``repro_torch.models.moe``, ``ops.ragged_dot``)
against the JAX package's, on inputs drawn from a numpy seed.

olmoe-1b-7b and mixtral-8x7b ``.reduced()`` (f32, 4 experts, top-2,
``d_ff_expert`` 32), with the reference's ``moe_init`` weights loaded into
the port:

* ``expert_capacity`` equal for several token counts;
* the capacity path at capacity factors 0.25 (choices dropped), 1.25 and
  100 (none dropped): ``y`` and ``aux`` within atol = rtol = 2e-4, the
  routing ``sel`` and the kept choices ``keep`` exactly;
* the dropless path: ``y`` within 2e-4, the stable sort order and the group
  sizes exactly (``jnp.argsort``, ``jnp.bincount``);
* the capacity path's gradients (router and the three expert weights, and
  the input) against ``jax.grad``, within 2e-4;
* the plain ``ragged_dot`` against ``jax.lax.ragged_dot`` with empty
  groups, and its refusals;
* ``moe_init``: the reference's tree, shapes, dtypes and scales;
  ``params_from_jax``: the reduced models' router as a float32 ``dense``
  dict and the expert weights (E, d, ff) / (E, ff, d) per layer;
* ``build_model`` of both full configs, and the continuous scheduler's
  eligibility equal to the reference's predicate for every config.

``LM.loss`` with its ``aux_loss`` metric and gradients is a case of
``test_torch_train.py``; the prefill, decode steps and both engines' streams
are cases of ``test_torch_model.py``, ``test_torch_static_serve.py`` and
``test_torch_serve.py``.
"""

import math

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

from repro.configs import all_configs as ref_all_configs
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.models import moe as RM
from repro.serve import supports_continuous as ref_supports_continuous
from repro_torch.configs import all_configs, get_config
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import moe as M
from repro_torch.serve import supports_continuous
from repro_torch.testing import params_from_jax, to_torch

TOL = dict(atol=2e-4, rtol=2e-4)
ARCHS = ["olmoe-1b-7b", "mixtral-8x7b"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(arch, capacity_factor=None):
    jcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    if capacity_factor is not None:
        jcfg = jcfg.with_(moe=jcfg.moe.__class__(**{**vars(jcfg.moe),
                                                    "capacity_factor": capacity_factor}))
        cfg = cfg.with_(moe=cfg.moe.__class__(**{**vars(cfg.moe),
                                                 "capacity_factor": capacity_factor}))
    return jcfg, cfg


def _weights(jcfg, seed=1):
    jp = RM.moe_init(jax.random.PRNGKey(seed), jcfg)
    p = {k: ({kk: to_torch(np.asarray(vv)) for kk, vv in v.items()} if isinstance(v, dict)
             else to_torch(np.asarray(v))) for k, v in jp.items()}
    return jp, p


def _x(cfg, seed=0, shape=(4, 16)):
    return np.random.default_rng(seed).normal(size=shape + (cfg.d_model,)).astype(np.float32)


def _ref_routing(jp, jcfg, x):
    """The reference's routing of x, by its own ops: (sel (T, k), the flat
    expert ids, keep at the config's capacity)."""
    m = jcfg.moe
    xf = jnp.asarray(x).reshape(-1, jcfg.d_model)
    logits = RL.dense(jp["router"], xf.astype(jnp.float32))
    _, sel = jax.lax.top_k(logits, m.top_k)
    e_flat = sel.reshape(-1)
    oh = jax.nn.one_hot(e_flat, m.num_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - 1, e_flat[:, None], axis=1)[:, 0]
    keep = pos < RM.expert_capacity(xf.shape[0], jcfg)
    return np.asarray(sel), np.asarray(e_flat), np.asarray(keep)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_equals_reference(arch):
    for cf in (0.25, 1.25, 100.0):
        jcfg, cfg = _cfgs(arch, cf)
        for n in (1, 7, 64, 135, 1000, 16384):
            assert M.expert_capacity(n, cfg) == RM.expert_capacity(n, jcfg), (cf, n)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [0.25, 1.25, 100.0])
def test_capacity_path_equals_reference(arch, cf):
    jcfg, cfg = _cfgs(arch, cf)
    jp, p = _weights(jcfg)
    x = _x(cfg, seed=int(cf * 4))
    jy, jaux = RM.moe_apply(jp, jcfg, jnp.asarray(x))
    y, aux = M.moe_apply(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    assert aux.dtype == torch.float32 and y.dtype == torch.float32

    sel, e_flat, keep = _ref_routing(jp, jcfg, x)
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, _, got_sel = M._route(p, cfg, xf)
    np.testing.assert_array_equal(got_sel.numpy(), sel)
    cap = M.expert_capacity(xf.shape[0], cfg)
    _, got_keep, _ = M._capacity_slots(got_sel.reshape(-1), cfg.moe.num_experts, cap)
    np.testing.assert_array_equal(got_keep.numpy().astype(bool), keep)
    if cf == 0.25:
        assert not keep.all()      # 128 choices over 4 experts of 8 slots
    if cf == 100.0:
        assert keep.all()


@pytest.mark.parametrize("arch", ARCHS)
def test_dropless_path_equals_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jp, p = _weights(jcfg, seed=2)
    x = _x(cfg, seed=5, shape=(3, 11))
    jy, jaux = RM.moe_apply(jp, jcfg, jnp.asarray(x), dropless=True)
    y, aux = M.moe_apply(p, cfg, torch.from_numpy(x), dropless=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert float(jaux) == aux.item() == 0.0

    _, e_flat, _ = _ref_routing(jp, jcfg, x)
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    w_flat, order, inv, sizes = M._dropless_routing(p, cfg, xf)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jnp.argsort(jnp.asarray(e_flat))))
    np.testing.assert_array_equal(
        sizes.numpy(), np.asarray(jnp.bincount(jnp.asarray(e_flat), length=cfg.moe.num_experts)))
    assert sizes.dtype == torch.int32
    np.testing.assert_array_equal(order[inv].numpy(), np.arange(order.numel()))


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_path_gradients_equal_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jp, p = _weights(jcfg, seed=3)
    x = _x(cfg, seed=7)
    r = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def jloss(params, xx):
        y, aux = RM.moe_apply(params, jcfg, xx)
        return jnp.sum(y * r) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {"router": p["router"]["w"], **{k: p[k] for k in ("w_gate", "w_up", "w_down")}}
    xt = torch.from_numpy(x).requires_grad_(True)
    for t in leaves.values():
        t.requires_grad_(True)
    y, aux = M.moe_apply(p, cfg, xt)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux, [*leaves.values(), xt])
    want = {"router": jg["router"]["w"], **{k: jg[k] for k in ("w_gate", "w_up", "w_down")}}
    for (name, _), g in zip(leaves.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), err_msg=name, **TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **TOL)


@pytest.mark.parametrize("sizes", [[3, 0, 5, 0], [0, 0, 8, 0], [2, 2, 2, 2], [0, 1, 0, 6]],
                         ids=["two-empty", "one-group", "even", "short"])
def test_plain_ragged_dot_equals_reference(sizes):
    """Rows past the last group (``short``: 7 of 8) are zeros in both."""
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    x = rng.normal(size=(8, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12, 5)).astype(np.float32)
    gs = np.array(sizes, np.int32)
    want = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    got = ops.ragged_dot(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.shape == (8, 5) and got.dtype == torch.float32
    np.testing.assert_array_equal(
        ops.ragged_dot(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs),
                       impl="torch").numpy(), got.numpy())


def test_ragged_dot_zeroes_rows_past_the_groups_without_a_host_read():
    """The mask that zeroes the rows past the last group (which
    ``grouped_mm`` leaves unwritten on the card) is built on the device:
    it runs under the host-read guard of the captured steps and leaves the
    rows inside the groups as they are."""
    from test_torch_step_graph import NoHostRead

    out = torch.arange(1.0, 25.0).reshape(8, 3)
    offs = torch.cumsum(torch.tensor([2, 0, 3], dtype=torch.int32), 0, dtype=torch.int32)
    with NoHostRead():
        got = ops._zero_past_groups(out, offs)
    assert torch.equal(got[:5], out[:5]) and not got[5:].any()
    with NoHostRead():
        assert torch.equal(ops._zero_past_groups(out, offs.new_tensor([4, 8])), out)


def test_ragged_dot_refusals():
    x, w, gs = torch.zeros(4, 8), torch.zeros(2, 8, 3), torch.tensor([2, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.ragged_dot(x, w, gs, impl="cuda")
    for impl in ("reference", "xla", "pallas"):
        with pytest.raises(ValueError, match="ragged_dot impl"):
            ops.ragged_dot(x, w, gs, impl=impl)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_matches_reference_tree_and_scales(arch):
    jcfg, cfg = _cfgs(arch)
    jp = RM.moe_init(jax.random.PRNGKey(0), jcfg)
    mine = M.moe_init(torch.Generator().manual_seed(4), cfg)
    assert jax.tree.map(lambda a: (np.shape(a), str(np.asarray(a).dtype)), jp) == \
        jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), mine)
    d, ff = cfg.d_model, cfg.moe.d_ff_expert
    for key, fan_in in (("w_gate", d), ("w_up", d), ("w_down", ff)):
        assert abs(mine[key].std().item() * math.sqrt(fan_in) - 1.0) < 0.1, key
    assert mine["router"]["w"].dtype == torch.float32
    again = M.moe_init(torch.Generator().manual_seed(4), cfg)
    assert all(torch.equal(mine[k], again[k]) for k in ("w_gate", "w_up", "w_down"))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_moe_layouts(arch):
    jcfg = ref_get_config(arch).reduced()
    jparams = ref_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    m = jcfg.moe
    e, d, ff = m.num_experts, jcfg.d_model, m.d_ff_expert
    assert len(params["layers"]) == jcfg.n_layers
    for i, lp in enumerate(params["layers"]):
        ffn = lp["ffn"]
        assert set(ffn) == {"router", "w_gate", "w_up", "w_down"}
        assert set(ffn["router"]) == {"w"} and ffn["router"]["w"].dtype == torch.float32
        assert tuple(ffn["router"]["w"].shape) == (d, e)
        assert tuple(ffn["w_gate"].shape) == tuple(ffn["w_up"].shape) == (e, d, ff)
        assert tuple(ffn["w_down"].shape) == (e, ff, d)
        for key in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(ffn[key].numpy(),
                                          np.asarray(jparams["layers"]["ffn"][key])[i])
    lm = build_model(get_config(arch).reduced(), device="cpu")
    mine = lm.init(0)
    assert jax.tree.map(np.shape, jax.tree.map(lambda a: np.asarray(a)[0], jparams["layers"])) \
        == jax.tree.map(lambda t: tuple(t.shape), mine["layers"][0])


def test_moe_configs_build_and_continuous_eligibility_equals_reference():
    for arch in ARCHS:
        lm = build_model(get_config(arch), device="cpu")   # closures only: nothing allocated
        assert lm.cfg.moe is not None
    ref = ref_all_configs()
    assert set(all_configs()) == set(ref)
    for arch, cfg in all_configs().items():
        assert supports_continuous(cfg) == ref_supports_continuous(ref[arch]), arch
    assert supports_continuous(get_config("olmoe-1b-7b"))
    assert not supports_continuous(get_config("mixtral-8x7b"))
