"""The port's training path against the JAX package, on the same weights.

deepseek-7b ``.reduced()`` (f32, 2 layers, d 64, GQA 4:2, 16-row tiles so
that attention spans several tiles) with the reference's params loaded
through ``params_from_jax``; batches from the data pipeline, which both
packages generate bit for bit alike.

* Configs: ``TrainConfig`` and ``ParallelConfig`` field by field.
* ``cross_entropy`` and ``LM.loss``: within 1e-5 relative; step-0
  gradients of every leaf within 1e-4 (``jax.grad`` of the reference's
  loss), also under ``remat="full"`` and ``remat="dots"``, with
  ``attn_impl="recompute"`` (the reference's ``"jnp"``), for a GQA (1 kv
  head) and a sliding-window (32) variant, and for the other dense configs
  (qwen2-72b, codeqwen1_5-7b, llama3-405b, paper-gb10) and the MoE configs
  (olmoe-1b-7b, mixtral-8x7b: the capacity path and its aux losses).
* The optimizers, ``adamw`` and ``adamw_factored``, fed the same numpy
  gradients: params and moments after two steps equal the reference's to
  float32 rounding (Adam's first step is about lr * sign(g), so the two are
  compared from identical gradients, not from gradients that differ by
  rounding).
* ``make_train_step`` over 3 steps: losses within 1e-4 of the reference's;
  2 microbatches equal 1 within 1e-5.
* Checkpoints: a round trip (bf16 included), ``latest_step`` ignoring a
  ``.tmp`` directory, retention, and a checkpoint the JAX package's
  ``save_pytree`` wrote restoring into the port.
* ``run_training``: a crash at step 3 and a resume give the losses of an
  uninterrupted run; a failure part way through the optimizer's in-place
  update writes no checkpoint of the half-updated state; the watchdog
  re-runs a step that overran.
* ``make_train_step`` takes the sharding fields of ``ParallelConfig``;
  without a mesh they change nothing (``tests/test_torch_dist.py`` runs
  them on a mesh).
* The launcher on the CPU, its refusal of a malformed ``--mesh`` and its
  refusal without ``--device cpu``.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

from repro.configs import ParallelConfig as RefParallelConfig
from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.data import pipeline as ref_data
from repro.launch.mesh import make_local_mesh
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch.configs import ParallelConfig, TrainConfig, get_config
from repro_torch.data import pipeline as port_data
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.testing import params_from_jax
from repro_torch.train import checkpoint as port_ckpt
from repro_torch.train import step as port_step
from repro_torch.train.fault_tolerance import FailureInjector
from repro_torch.train.loop import run_training
from repro_torch.train.optimizer import cosine_schedule, make_optimizer, named_leaves
from repro_torch.train.step import make_train_state, make_train_step

GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
TILES = dict(q_block=16, kv_block=16)
SEQ, BATCH = 64, 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(arch="deepseek-7b", **kw):
    kw = {**TILES, **kw}
    return ref_get_config(arch).reduced().with_(**kw), get_config(arch).reduced().with_(**kw)


def _batches(vocab, n, seed=0):
    src = ref_data.SyntheticPacked(ref_data.DataConfig(vocab=vocab, seq_len=SEQ,
                                                       global_batch=BATCH, seed=seed))
    return [src.batch(s) for s in range(n)]


@pytest.fixture(scope="module")
def dense():
    jcfg, cfg = _cfgs()
    jlm = ref_build_model(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = build_model(cfg, device="cpu")
    return jlm, jparams, lm, _batches(cfg.vocab, 4)


def _port_params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


def _ref_leaf(tree, path):
    """The reference's leaf for a port key path (layers stacked there)."""
    node = tree
    for k in (path[:1] + path[2:]) if path[0] == "layers" else path:
        node = node[k]
    node = np.asarray(node)
    return node[path[1]] if path[0] == "layers" else node


def _assert_tree_close(port_tree, ref_tree, **tol):
    n = 0
    for path, t in named_leaves(port_tree):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   _ref_leaf(ref_tree, path).astype(np.float32),
                                   err_msg="/".join(map(str, path)), **tol)
        n += 1
    assert n > 0


def test_train_configs_equal_reference():
    for ref, port in ((RefTrainConfig(), TrainConfig()),
                      (RefParallelConfig(), ParallelConfig())):
        rf = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
        pf = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)}
        assert pf == rf


def test_cross_entropy_equals_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    for m in (None, mask):
        for z in (0.0, 1e-4):
            want_l, want_m = ref_layers.cross_entropy(
                jnp.asarray(logits), jnp.asarray(labels),
                None if m is None else jnp.asarray(m), z_loss=z)
            got_l, got_m = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                           None if m is None else torch.from_numpy(m), z_loss=z)
            assert set(got_m) == set(want_m)
            np.testing.assert_allclose(got_l.item(), float(want_l), rtol=1e-5)
            for k in want_m:
                np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), rtol=1e-5)


@pytest.mark.parametrize("variant", ["dense", "gqa", "swa", "remat", "dots", "recompute",
                                     "qwen2-72b", "codeqwen1_5-7b", "llama3-405b", "paper-gb10",
                                     "olmoe-1b-7b", "mixtral-8x7b"])
def test_loss_and_step0_grads_equal_reference(dense, variant):
    """LM.loss within 1e-5 relative and d loss / d params within 1e-4; the
    variants of deepseek-7b (``dots``: remat "dots" in both packages;
    ``recompute``: the port's attention impl against the reference's
    "jnp"), then the other dense configs and the MoE configs (the capacity
    path, its ``aux_loss`` metric added to the loss)."""
    if variant == "dense":
        jlm, jparams, lm, batches = dense
    else:
        kw = {"gqa": dict(n_kv_heads=1), "swa": dict(window=32),
              "remat": dict(remat="full"), "dots": dict(remat="dots"),
              "recompute": dict(remat="full")}.get(variant, dict(arch=variant))
        jcfg, cfg = _cfgs(**kw)
        if variant == "recompute":
            jcfg, cfg = jcfg.with_(attn_impl="jnp"), cfg.with_(attn_impl="recompute")
        jlm = ref_build_model(jcfg)
        jparams = jlm.init(jax.random.PRNGKey(1))
        lm = build_model(cfg, device="cpu")
        batches = _batches(cfg.vocab, 1, seed=3)
    batch = batches[0]
    (want, want_m), want_g = jax.value_and_grad(
        lambda p: jlm.loss(p, {"tokens": jnp.asarray(batch["tokens"])}), has_aux=True)(jparams)
    params = _port_params(jparams)
    leaves = [p.requires_grad_(True) for _, p in named_leaves(params)]
    got, got_m = lm.loss(params, batch)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), rtol=1e-5)
    assert (got_m["aux_loss"].item() > 0) == (lm.cfg.moe is not None)
    grads = torch.autograd.grad(got, leaves)
    gtree = [(path, g) for (path, _), g in zip(named_leaves(params), grads)]
    for path, g in gtree:
        np.testing.assert_allclose(g.numpy(), _ref_leaf(want_g, path),
                                   err_msg="/".join(map(str, path)), **GRAD_TOL)


def test_cosine_schedule_equals_reference():
    for tcfg in (TrainConfig(), TrainConfig(warmup_steps=3, total_steps=10, lr=1e-3)):
        ref = ref_opt.cosine_schedule(RefTrainConfig(**dataclasses.asdict(tcfg)))
        port = cosine_schedule(tcfg)
        for step in (0, 1, 2, 5, 99, 100, 101, 500, 1000, 2000):
            np.testing.assert_allclose(port(step), float(ref(jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("optimizer", ["adamw", "adamw_factored"])
def test_optimizer_equals_reference(dense, optimizer):
    """Two updates from the same numpy gradients: params, moments and
    stats equal the reference's to float32 rounding."""
    _, jparams, _, _ = dense
    tcfg = TrainConfig(optimizer=optimizer, warmup_steps=1, lr=1e-2)
    r_init, r_update = ref_opt.make_optimizer(RefTrainConfig(**dataclasses.asdict(tcfg)))
    p_init, p_update = make_optimizer(tcfg)
    params = _port_params(jparams)
    jstate, state = r_init(jparams), p_init(params)
    rng = np.random.default_rng(7)
    for _ in range(2):
        jgrads = jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.05),
            jparams)
        grads = _port_params(jgrads)
        jparams, jstate, jstats = r_update(jgrads, jstate, jparams)
        params, state, stats = p_update(grads, state, params)
        for k in ("lr", "grad_norm", "clip"):
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5)
        _assert_tree_close(params, jparams, atol=1e-6, rtol=1e-5)
    assert state.step == int(jstate.step) == 2
    for port_tree, ref_tree in ((state.m, jstate.m), (state.v, jstate.v)):
        want = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
                for path, x in jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
        got = {"/".join(map(str, path)): t.float().numpy() for path, t in named_leaves(port_tree)}
        assert set(got) == set(want)
        for k, t in got.items():
            # The factored first moment is bf16: where the float32 sums differ
            # in their last bit it may round to the neighbouring bf16 value.
            rtol = 2.0 ** -7 if want[k].dtype != np.float32 else 1e-4
            np.testing.assert_allclose(t, want[k].astype(np.float32), atol=1e-6, rtol=rtol,
                                       err_msg=k)


def test_data_batches_equal_reference_bitwise():
    cfg = dict(vocab=300, seq_len=96, global_batch=4, seed=5, mean_doc_len=40)
    for hosts in ((0, 1), (1, 2)):
        kw = dict(cfg, host_index=hosts[0], host_count=hosts[1])
        ref = ref_data.SyntheticPacked(ref_data.DataConfig(**kw))
        port = port_data.SyntheticPacked(port_data.DataConfig(**kw))
        for s in (0, 1, 17):
            a, b = port.batch(s)["tokens"], ref.batch(s)["tokens"]
            assert a.dtype == b.dtype and np.array_equal(a, b)
    it = port_data.make_batch_iterator(port_data.DataConfig(**cfg), start_step=3)
    ref = ref_data.SyntheticPacked(ref_data.DataConfig(**cfg))
    for s in (3, 4):
        assert np.array_equal(next(it)["tokens"], ref.batch(s)["tokens"])
    it.close()


def _ref_losses(jlm, jparams, tcfg, pcfg, batches):
    mesh = make_local_mesh(1, 1)
    with jax.set_mesh(mesh):
        jstate = ref_step.make_train_state(jlm, RefTrainConfig(**dataclasses.asdict(tcfg)),
                                           jax.random.PRNGKey(0))
        # The compiled step donates its state: hand it a copy of the weights.
        jstate = dict(jstate, params=jax.tree.map(jnp.copy, jparams))
        _, compile_step = ref_step.make_train_step(
            jlm, RefTrainConfig(**dataclasses.asdict(tcfg)),
            RefParallelConfig(microbatches=pcfg.microbatches), mesh)
        jb = {"tokens": jnp.asarray(batches[0]["tokens"])}
        compiled = compile_step(jstate, jb)
        out = []
        for b in batches:
            jstate, m = compiled(jstate, {"tokens": jnp.asarray(b["tokens"])})
            out.append(float(m["loss"]))
    return out


def _port_losses(lm, jparams, tcfg, pcfg, batches):
    params = _port_params(jparams)
    state = {"params": params, "opt": make_optimizer(tcfg)[0](params)}
    step = make_train_step(lm, tcfg, pcfg)
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append(float(m["loss"]))
    return out, m


def test_train_steps_track_reference(dense):
    """Three steps of make_train_step (adamw, warmup 1) from the same
    weights and batches: every loss within 1e-4 of the reference's."""
    jlm, jparams, lm, batches = dense
    tcfg = TrainConfig(lr=3e-3, warmup_steps=1)
    want = _ref_losses(jlm, jparams, tcfg, ParallelConfig(), batches[:3])
    got, m = _port_losses(lm, jparams, tcfg, ParallelConfig(), batches[:3])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert got[-1] < got[0]
    assert {"loss", "tokens", "ppl_proxy", "aux_loss", "total_loss", "lr", "grad_norm", "clip",
            "loss_mean"} == set(m)


@pytest.mark.parametrize("field", [dict(fsdp_axes=("data",)), dict(tensor_axis="x"),
                                   dict(data_axes=("data",)), dict(seq_shard_activations=True),
                                   dict(grad_compression="int8_pod"), dict(zero_grads=False)],
                         ids=lambda kw: next(iter(kw)))
def test_sharding_fields_are_refused(dense, field):
    """No field is refused any more (the port shards, ROADMAP A14): each
    builds a step, and without a mesh the step's loss is the default's, bit
    for bit; ``grad_compression`` and ``zero_grads`` are read by nothing, as
    in the reference's step."""
    _, jparams, lm, batches = dense
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0)
    got, _ = _port_losses(lm, jparams, tcfg, ParallelConfig(**field), batches[:2])
    want, _ = _port_losses(lm, jparams, tcfg, ParallelConfig(), batches[:2])
    assert got == want


def test_microbatches_equal_full_batch(dense):
    _, jparams, lm, batches = dense
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0)
    one, _ = _port_losses(lm, jparams, tcfg, ParallelConfig(microbatches=1), batches[:2])
    two, _ = _port_losses(lm, jparams, tcfg, ParallelConfig(microbatches=2), batches[:2])
    np.testing.assert_allclose(two, one, atol=1e-5, rtol=1e-5)


def _bf16_state():
    cfg = get_config("deepseek-7b").reduced().with_(param_dtype="bfloat16")
    lm = build_model(cfg, device="cpu")
    return lm, make_train_state(lm, TrainConfig(optimizer="adamw_factored"), 3, device="cpu")


def test_checkpoint_round_trip_and_retention(tmp_path):
    lm, state = _bf16_state()
    state = dict(state, opt=state["opt"]._replace(step=5))
    port_ckpt.save_pytree(state, str(tmp_path), 5)
    template = make_train_state(lm, TrainConfig(optimizer="adamw_factored"), 4, device="cpu")
    got, step = port_ckpt.restore_pytree(template, str(tmp_path))
    assert step == 5 and got["opt"].step == 5
    for part in (lambda st: st["params"], lambda st: st["opt"].m, lambda st: st["opt"].v):
        a, b = dict(named_leaves(part(got))), dict(named_leaves(part(state)))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert got["params"]["embed"]["table"].dtype == torch.bfloat16
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        keys = json.load(f)["keys"]
    assert keys["params/layers/attn/wq/w"]["shape"][0] == lm.cfg.n_layers
    assert keys["params/embed/table"]["dtype"] == "bfloat16"
    # A half-written checkpoint is invisible; retention keeps the newest k.
    os.makedirs(tmp_path / "step_00000009.tmp")
    (tmp_path / "step_00000009.tmp" / "manifest.json").write_text("{}")
    assert port_ckpt.latest_step(str(tmp_path)) == 5
    mgr = port_ckpt.CheckpointManager(str(tmp_path / "m"), keep=2)
    for s in (1, 2, 3):
        mgr.save(state, s)
    mgr.wait()
    assert sorted(os.listdir(tmp_path / "m")) == ["step_00000002", "step_00000003"]
    assert mgr.latest_step() == 3


def test_jax_written_checkpoint_restores_into_port(dense, tmp_path):
    jlm, jparams, lm, _ = dense
    tcfg = TrainConfig(optimizer="adamw_factored")
    jstate = ref_step.make_train_state(jlm, RefTrainConfig(**dataclasses.asdict(tcfg)),
                                       jax.random.PRNGKey(0))
    jstate = dict(jstate, params=jparams)
    ref_ckpt.save_pytree(jstate, str(tmp_path), 7)
    template = make_train_state(lm, tcfg, 1, device="cpu")
    got, step = port_ckpt.restore_pytree(template, str(tmp_path))
    assert step == 7 and got["opt"].step == 0
    want = dict(named_leaves(_port_params(jparams)))
    mine = dict(named_leaves(got["params"]))
    assert mine.keys() == want.keys()
    for path, a in mine.items():
        assert torch.equal(a, want[path]), path
    assert got["opt"].m["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert set(got["opt"].v["layers"]["ln_attn"]["scale"]) == {"row", "col"}


def _train_cfg(d, steps):
    return TrainConfig(lr=2e-3, total_steps=steps, warmup_steps=2, checkpoint_every=2,
                       checkpoint_dir=str(d), keep_checkpoints=2)


def test_crash_and_resume_equal_uninterrupted(dense, tmp_path):
    _, _, lm, _ = dense
    batches = _batches(lm.cfg.vocab, 6, seed=9)
    fn = lambda s: batches[s]
    full = run_training(lm, _train_cfg(tmp_path / "a", 6), device="cpu", make_batch=fn,
                        log_every=0)
    assert not full.interrupted and len(full.losses) == 6
    crashed = run_training(lm, _train_cfg(tmp_path / "b", 6), device="cpu", make_batch=fn,
                           injector=FailureInjector(crash_at=(3,)), log_every=0)
    assert crashed.interrupted and crashed.losses == full.losses[:3]
    resumed = run_training(lm, _train_cfg(tmp_path / "b", 6), device="cpu", make_batch=fn,
                           log_every=0)
    assert resumed.resumed_from == 2 and not resumed.interrupted and resumed.final_step == 5
    np.testing.assert_allclose(resumed.losses, full.losses[3:], rtol=1e-6)
    names = {e.name for e in resumed.tracer.events()}
    assert {"train.step", "train.checkpoint", "train.restore"} <= names
    assert resumed.registry.value("train.steps") == 3
    assert resumed.registry.value("train.tokens") == 3 * BATCH * SEQ
    for name in ("train.loss", "train.grad_norm", "train.lr", "train.throughput_tokens_per_s"):
        assert resumed.registry.find(name) is not None, name


def test_failure_inside_the_optimizer_keeps_the_last_clean_checkpoint(dense, tmp_path,
                                                                     monkeypatch):
    _, _, lm, _ = dense
    batches = _batches(lm.cfg.vocab, 5, seed=4)
    fn = lambda s: batches[s]
    cfg = lambda d: TrainConfig(lr=2e-3, total_steps=5, warmup_steps=2, checkpoint_every=1,
                                checkpoint_dir=str(d), keep_checkpoints=10)
    full = run_training(lm, cfg(tmp_path / "a"), device="cpu", make_batch=fn, log_every=0)
    real = port_step.make_optimizer

    def failing_optimizer(tcfg):
        init, update = real(tcfg)

        def update_then_fail(grads, state, params):
            if state.step == 3:  # step 3 writes one leaf in place, then runs out of memory
                with torch.no_grad():
                    next(iter(named_leaves(params)))[1].add_(1.0)
                raise torch.OutOfMemoryError("injected")
            return update(grads, state, params)

        return init, update_then_fail

    monkeypatch.setattr(port_step, "make_optimizer", failing_optimizer)
    crashed = run_training(lm, cfg(tmp_path / "b"), device="cpu", make_batch=fn, log_every=0)
    monkeypatch.undo()
    assert crashed.interrupted and crashed.losses == full.losses[:3]
    assert port_ckpt.latest_step(str(tmp_path / "b")) == 2
    with np.load(tmp_path / "a" / "step_00000002" / "shard_0.npz") as want, \
            np.load(tmp_path / "b" / "step_00000002" / "shard_0.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    resumed = run_training(lm, cfg(tmp_path / "b"), device="cpu", make_batch=fn, log_every=0)
    assert resumed.resumed_from == 2 and not resumed.interrupted
    np.testing.assert_allclose(resumed.losses, full.losses[3:], rtol=1e-6)


def test_watchdog_reruns_a_step_that_overran(dense, tmp_path):
    _, _, lm, _ = dense
    batches = _batches(lm.cfg.vocab, 4, seed=2)
    calls = {"n": 0}
    inner = lm.loss

    def loss(params, batch):
        calls["n"] += 1
        if calls["n"] == 2:  # step 1's first try overruns the 1 s watchdog
            time.sleep(1.5)
        return inner(params, batch)

    res = run_training(dataclasses.replace(lm, loss=loss), _train_cfg(tmp_path, 4), device="cpu",
                       make_batch=lambda s: batches[s], step_timeout_s=1.0, log_every=0)
    assert res.final_step == 3 and not res.interrupted and len(res.losses) == 4
    assert any(e.name == "train.watchdog_retry" for e in res.tracer.events())
    assert res.registry.value("train.steps", event="watchdog_retry") == 1 and calls["n"] == 5


def test_launcher_trains_on_cpu_and_refuses_without_a_gpu(tmp_path, capsys):
    args = ["--arch", "deepseek-7b", "--reduced", "--steps", "4", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path)]
    launch_train.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: final_step=3 resumed_from=None" in out and "interrupted=False" in out
    with pytest.raises(SystemExit, match="must be DxM"):
        launch_train.main(args + ["--device", "cpu", "--mesh", "2x1x1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            launch_train.main(args)
