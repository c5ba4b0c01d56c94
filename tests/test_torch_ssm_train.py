"""Training the port's SSM (mamba2-130m) and hybrid (zamba2-2.7b) families
against the JAX package, on the same weights.

The reference's params (``LM.init`` of the ``.reduced()`` configs, float32)
are loaded into the port with ``params_from_jax``; batches come from the
data pipeline, which both packages generate bit for bit alike.

* ``remat="dots"``: ``LM.loss`` and its gradients equal the reference's
  ``remat="dots"`` (relative 1e-4, as ``test_torch_ssm.py`` holds the
  loss), and the port's ``remat="full"`` to the bit: on the CPU a saved
  product and its recomputation are the same float32 sums in the same
  order.
* What ``"dots"`` keeps: counted with a dispatch mode, the backward runs
  as many 2-D matrix products as without remat (no projection
  recomputed), ``"full"`` more; for the dense family too.
* ``make_train_step`` over 3 AdamW steps under ``remat="full"``: losses
  within 1e-4 of the reference's compiled steps, as
  ``test_torch_train.py`` holds the dense model.
* The optimizers on the hybrid's nested layer stacks (a list of groups of
  Mamba layers beside the shared block): moments stacked (groups, layers a
  group, ...) as the reference's, and two updates from the same numpy
  gradients equal the reference's to float32 rounding.
* Checkpoints: a train state the JAX package saved for each family
  restores into the port, and the port's saves under the reference's key
  paths and shapes.
* The launcher trains both families on the CPU (the hybrid with the
  ``recompute`` attention impl).
"""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ParallelConfig as RefParallelConfig
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.data import pipeline as ref_data
from repro.launch.mesh import make_local_mesh
from repro.models import build_model as ref_build_model
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch.configs import ParallelConfig, TrainConfig, get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.testing import params_from_jax
from repro_torch.train import checkpoint as port_ckpt
from repro_torch.train.optimizer import make_optimizer, named_leaves
from repro_torch.train.step import make_train_state, make_train_step

ARCHS = ["mamba2-130m", "zamba2-2_7b"]
LOSS = 1e-4     # loss and gradients, relative to their scale
SEQ, BATCH = 64, 4
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want, tol, err_msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol, err_msg=err_msg)


def _batches(vocab, n, seed=0):
    src = ref_data.SyntheticPacked(ref_data.DataConfig(vocab=vocab, seq_len=SEQ,
                                                       global_batch=BATCH, seed=seed))
    return [src.batch(s) for s in range(n)]


def _ref(arch, **kw):
    jlm = ref_build_model(ref_get_config(arch).reduced().with_(**kw))
    return jlm, jlm.init(jax.random.PRNGKey(0))


def _port(arch, jparams, **kw):
    lm = build_model(get_config(arch).reduced().with_(**kw), device="cpu")
    return lm, params_from_jax(jax.tree.map(np.asarray, jparams))


def _loss_and_grads(lm, params, batch):
    leaves = [p.requires_grad_(True) for _, p in named_leaves(params)]
    try:
        loss, _ = lm.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), grads


class _CountProducts(TorchDispatchMode):
    """Counts the 2-D matrix products dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in _PRODUCTS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_dots_equals_reference_and_full(arch):
    jlm, jparams = _ref(arch, remat="dots")
    batch = _batches(jlm.cfg.vocab, 1, seed=2)[0]
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlm.loss(p, {"tokens": jnp.asarray(batch["tokens"])}), has_aux=True)(jparams)
    lm, params = _port(arch, jparams, remat="dots")
    loss, grads = _loss_and_grads(lm, params, batch)
    _close(loss, jloss, LOSS)
    want = dict(named_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads))))
    paths = [path for path, _ in named_leaves(params)]
    assert set(want) == set(paths)
    for path, g in zip(paths, grads):
        _close(g, want[path], LOSS, err_msg=str(path))
    full_lm, _ = _port(arch, jparams, remat="full")
    full_loss, full_grads = _loss_and_grads(full_lm, params, batch)
    assert torch.equal(loss, full_loss)
    for path, g, f in zip(paths, grads, full_grads):
        assert torch.equal(g, f), path


@pytest.mark.parametrize("arch", ["deepseek-7b", *ARCHS])
def test_remat_dots_recomputes_no_projection(arch):
    """The backward's 2-D matrix products: under ``"dots"`` as many as
    without remat (the gradients' own; every projection's output is kept),
    under ``"full"`` more (the projections of the recomputed forward)."""
    cfg = get_config(arch).reduced()
    params = build_model(cfg, device="cpu").init(0)
    batch = {"tokens": torch.from_numpy(_batches(cfg.vocab, 1)[0]["tokens"])}
    counts, losses = {}, {}
    for remat in ("none", "full", "dots"):
        lm = build_model(cfg.with_(remat=remat), device="cpu")
        leaves = [p.requires_grad_(True) for _, p in named_leaves(params)]
        loss, _ = lm.loss(params, batch)
        counter = _CountProducts()
        with counter:
            torch.autograd.grad(loss, leaves)
        counts[remat], losses[remat] = counter.n, loss.item()
    assert counts["dots"] == counts["none"] > 0
    assert counts["full"] > counts["dots"]
    assert losses["dots"] == losses["full"] == losses["none"]


def _ref_losses(jlm, jparams, tcfg, batches):
    mesh = make_local_mesh(1, 1)
    with jax.set_mesh(mesh):
        rtcfg = RefTrainConfig(**dataclasses.asdict(tcfg))
        jstate = ref_step.make_train_state(jlm, rtcfg, jax.random.PRNGKey(0))
        # The compiled step donates its state: hand it a copy of the weights.
        jstate = dict(jstate, params=jax.tree.map(jnp.copy, jparams))
        _, compile_step = ref_step.make_train_step(jlm, rtcfg, RefParallelConfig(), mesh)
        compiled = compile_step(jstate, {"tokens": jnp.asarray(batches[0]["tokens"])})
        out = []
        for b in batches:
            jstate, m = compiled(jstate, {"tokens": jnp.asarray(b["tokens"])})
            out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_track_reference(arch):
    """Three steps of make_train_step (adamw, warmup 1, remat full) from
    the same weights on one batch, three times: every loss within 1e-4 of
    the reference's, and the loss falls."""
    jlm, jparams = _ref(arch, remat="full")
    tcfg = TrainConfig(lr=3e-3, warmup_steps=1)
    batches = _batches(jlm.cfg.vocab, 1, seed=4) * 3
    want = _ref_losses(jlm, jparams, tcfg, batches)
    lm, params = _port(arch, jparams, remat="full")
    state = {"params": params, "opt": make_optimizer(tcfg)[0](params)}
    step = make_train_step(lm, tcfg, ParallelConfig())
    got = []
    for b in batches:
        state, m = step(state, b)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert got[-1] < got[0]


@pytest.mark.parametrize("arch,impl", [("mamba2-130m", None), ("zamba2-2_7b", "recompute")])
def test_launcher_trains_ssm_families_on_cpu(arch, impl, tmp_path, capsys):
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "48", "--ckpt-dir", str(tmp_path)]
    launch_train.main(args + (["--attn-impl", impl] if impl else []))
    out = capsys.readouterr().out
    assert "done: final_step=2 resumed_from=None" in out and "interrupted=False" in out


def _flat_ref(tree):
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {tuple(map(str, path)): t for path, t in named_leaves(tree)}


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_factored"])
def test_optimizer_on_hybrid_stacks_equals_reference(optimizer):
    """zamba2 ``.reduced()`` (2 groups of 2 Mamba layers): the moments' tree
    and shapes are the reference's, and two updates from the same numpy
    gradients give its params and moments."""
    jlm = ref_build_model(ref_get_config("zamba2-2_7b").reduced().with_(
        n_layers=4, ssm=dataclasses.replace(ref_get_config("zamba2-2_7b").reduced().ssm,
                                            shared_attn_every=2)))
    jparams = jlm.init(jax.random.PRNGKey(3))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert len(params["layers"]["mamba"]) == 2 and len(params["layers"]["mamba"][0]) == 2
    tcfg = TrainConfig(optimizer=optimizer, warmup_steps=1, lr=1e-2)
    r_init, r_update = ref_opt.make_optimizer(RefTrainConfig(**dataclasses.asdict(tcfg)))
    p_init, p_update = make_optimizer(tcfg)
    jstate, state = r_init(jparams), p_init(params)
    for mine, ref in ((state.m, jstate.m), (state.v, jstate.v)):
        want = {k: v.shape for k, v in _flat_ref(ref).items()}
        assert {k: tuple(t.shape) for k, t in _flat_port(mine).items()} == want
    rng = np.random.default_rng(7)
    for update in range(2):
        jgrads = jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.05),
            jparams)
        grads = params_from_jax(jax.tree.map(np.asarray, jgrads))
        jparams, jstate, _ = r_update(jgrads, jstate, jparams)
        params, state, _ = p_update(grads, state, params)
        # The second adamw_factored update reads the bf16 first moment, which
        # may lie one bf16 step (2^-8 relative) from the reference's: lr 1e-2
        # times that times |m| / sqrt(v), which the factored v lets reach a
        # few, moves such a param by up to about 1e-4.
        atol = 1e-4 if update and optimizer == "adamw_factored" else 1e-6
        want = dict(named_leaves(params_from_jax(jax.tree.map(np.asarray, jparams))))
        for path, t in named_leaves(params):
            np.testing.assert_allclose(t.numpy(), want[path].numpy(), atol=atol, rtol=1e-5,
                                       err_msg=f"update {update}: {path}")
    for mine, ref in ((state.m, jstate.m), (state.v, jstate.v)):
        want = _flat_ref(ref)
        for k, t in _flat_port(mine).items():
            # The factored first moment is bf16: a float32 sum that differs in
            # its last bit may round to the neighbouring bf16 value.
            rtol = 2.0 ** -7 if t.dtype == torch.bfloat16 else 1e-4
            np.testing.assert_allclose(t.float().numpy(), want[k].astype(np.float32),
                                       atol=1e-6, rtol=rtol, err_msg=str(k))


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_written_checkpoint_restores_into_port(arch, tmp_path):
    jlm, jparams = _ref(arch)
    tcfg = TrainConfig(optimizer="adamw_factored")
    jstate = ref_step.make_train_state(jlm, RefTrainConfig(**dataclasses.asdict(tcfg)),
                                       jax.random.PRNGKey(0))
    jstate = dict(jstate, params=jparams)
    ref_ckpt.save_pytree(jstate, str(tmp_path / "ref"), 7)
    lm = build_model(get_config(arch).reduced(), device="cpu")
    template = make_train_state(lm, tcfg, 1, device="cpu")
    got, step = port_ckpt.restore_pytree(template, str(tmp_path / "ref"))
    assert step == 7
    want = dict(named_leaves(params_from_jax(jax.tree.map(np.asarray, jparams))))
    mine = dict(named_leaves(got["params"]))
    assert mine.keys() == want.keys()
    for path, a in mine.items():
        assert torch.equal(a, want[path]), path
    port_ckpt.save_pytree(got, str(tmp_path / "port"), 8)
    saved = json.loads((tmp_path / "port" / "step_00000008" / "manifest.json").read_text())
    ref_keys = json.loads((tmp_path / "ref" / "step_00000007" / "manifest.json").read_text())
    assert {k: v["shape"] for k, v in saved["keys"].items()} == \
        {k: v["shape"] for k, v in ref_keys["keys"].items()}
