"""The port's dense decoder against the JAX package, on the same weights.

The reference's params (``LM.init`` of deepseek-7b ``.reduced()``, f32) are
loaded into the port with ``params_from_jax``. Both models run the ragged
chunk step ``decode_step`` over a paged cache with a shuffled block table:
one prefill chunk (ragged q_lens, a free row), then 8 greedy decode steps.
Logits and the written pages must agree within 2e-4 (f32; the layers sum in
other orders), and the greedy tokens must be equal. The other dense configs
(qwen2-72b, codeqwen1_5-7b, llama3-405b, paper-gb10) are cases of the same
test.
"""

import math

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.testing import params_from_jax

TOL = dict(atol=2e-4, rtol=2e-4)
PAGE, MAX_LEN, B = 8, 48, 3
# The other dense configs, held to the reference as cases of the tests below.
OTHER_DENSE = ["qwen2-72b", "codeqwen1_5-7b", "llama3-405b", "paper-gb10"]
# The MoE configs (dropless grouped products in the step), cases of the same.
MOE = ["olmoe-1b-7b", "mixtral-8x7b"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return _models("deepseek-7b")


def _models(arch):
    jcfg = ref_get_config(arch).reduced().with_(kv_layout="paged", page_size=PAGE)
    cfg = get_config(arch).reduced().with_(kv_layout="paged", page_size=PAGE)
    jlm = ref_build_model(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jlm, jparams, lm, params


def _caches(cfg, rng):
    """Zero pools of both layouts and one shuffled block table."""
    _, nb = T.page_geometry(cfg, MAX_LEN)
    n_pages = B * nb + 1
    bt = rng.permutation(np.arange(1, n_pages))[: B * nb].reshape(B, nb).astype(np.int32)
    shape = (cfg.n_layers, n_pages, PAGE, cfg.n_kv_heads, cfg.hd)
    port = {
        "k_pages": torch.zeros(shape), "v_pages": torch.zeros(shape),
        "block_table": torch.from_numpy(bt), "len": torch.zeros(B, dtype=torch.int32),
    }
    ref = {
        "k_pages": jnp.zeros(shape), "v_pages": jnp.zeros(shape),
        "block_table": jnp.broadcast_to(jnp.asarray(bt), (cfg.n_layers,) + bt.shape),
        "len": jnp.zeros((cfg.n_layers, B), jnp.int32),
    }
    return port, ref


def _step(jlm, jparams, lm, params, jc, pc, tokens, q_lens, order_group):
    n_layers = lm.cfg.n_layers
    jc = dict(jc, q_len=jnp.broadcast_to(jnp.asarray(q_lens), (n_layers, B)),
              order_group=jnp.full((n_layers,), order_group, jnp.int32))
    pc = dict(pc, q_len=torch.from_numpy(q_lens), order_group=order_group)
    jl, jc = jlm.decode_step(jparams, jnp.asarray(tokens), jc)
    pl, pc = lm.decode_step(params, torch.from_numpy(tokens), pc)
    return np.asarray(jl), jc, pl.numpy(), pc


def _check_pages(jc, pc):
    # Page 0 takes the invalid rows' writes in either order; it is never read.
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(pc[name].numpy()[:, 1:], np.asarray(jc[name])[:, 1:], **TOL)


@pytest.mark.parametrize("order,group,arch", [
    ("cyclic", 1, "deepseek-7b"), ("sawtooth", 6, "deepseek-7b"), ("block_snake", 2, "deepseek-7b"),
    *[("sawtooth", 6, arch) for arch in OTHER_DENSE + MOE],
], ids=["cyclic-1", "sawtooth-6", "block_snake-2", *OTHER_DENSE, *MOE])
def test_decode_step_matches_reference(models, order, group, arch):
    jlm, jparams, lm, params = models if arch == "deepseek-7b" else _models(arch)
    rng = np.random.default_rng(group)
    pc, jc = _caches(lm.cfg, rng)
    c = 13
    tokens = rng.integers(2, lm.cfg.vocab, size=(B, c)).astype(np.int32)
    q_lens = np.array([c, 9, 0], np.int32)                 # ragged; row 2 free
    jl, jc, pl, pc = _step(jlm, jparams, lm, params, jc, pc, tokens, q_lens, group)
    for b in range(B):
        np.testing.assert_allclose(pl[b, : q_lens[b]], jl[b, : q_lens[b]], **TOL)
    np.testing.assert_array_equal(pc["len"].numpy(), q_lens)
    np.testing.assert_array_equal(np.asarray(jc["len"])[0], q_lens)
    _check_pages(jc, pc)

    nxt_j = np.argmax(jl[np.arange(B), np.maximum(q_lens - 1, 0)], -1).astype(np.int32)
    nxt_p = np.argmax(pl[np.arange(B), np.maximum(q_lens - 1, 0)], -1).astype(np.int32)
    ones = np.array([1, 1, 0], np.int32)
    for _ in range(8):
        np.testing.assert_array_equal(nxt_p[:2], nxt_j[:2])
        jl, jc, pl, pc = _step(jlm, jparams, lm, params, jc, pc, nxt_p[:, None], ones, group)
        np.testing.assert_allclose(pl[:2, 0], jl[:2, 0], **TOL)
        nxt_j = np.argmax(jl[:, 0], -1).astype(np.int32)
        nxt_p = np.argmax(pl[:, 0], -1).astype(np.int32)
    np.testing.assert_array_equal(pc["len"].numpy(), np.asarray(jc["len"])[0])
    _check_pages(jc, pc)


def test_params_from_jax_unstacks_layers(models):
    _, jparams, lm, params = models
    assert isinstance(params["layers"], list) and len(params["layers"]) == lm.cfg.n_layers
    for i, lp in enumerate(params["layers"]):
        want = np.asarray(jparams["layers"]["attn"]["wq"]["w"])[i]
        np.testing.assert_array_equal(lp["attn"]["wq"]["w"].numpy(), want)
    np.testing.assert_array_equal(
        params["embed"]["table"].numpy(), np.asarray(jparams["embed"]["table"])
    )


def test_seeded_init_matches_reference_shapes_and_scales(models):
    """The port's own init (for the card, where JAX is absent): the
    reference's tree, shapes and dtypes, at its scales, and the same draw
    from the same seed."""
    _, jparams, lm, _ = models
    mine = lm.init(3)
    ref_layers = jax.tree.map(lambda a: np.asarray(a)[0], jparams["layers"])
    for key in ("embed", "ln_f"):
        assert jax.tree.map(np.shape, jax.tree.map(np.asarray, jparams[key])) == \
            jax.tree.map(lambda t: tuple(t.shape), mine[key])
    assert jax.tree.map(np.shape, ref_layers) == \
        jax.tree.map(lambda t: tuple(t.shape), mine["layers"][0])
    cfg = lm.cfg
    w = mine["layers"][0]["ffn"]["w_down"]["w"]
    assert w.dtype == cfg.parameter_dtype()
    assert abs(w.std().item() - 1 / math.sqrt(cfg.d_ff)) < 0.1 / math.sqrt(cfg.d_ff)
    assert abs(mine["embed"]["table"].std().item() - 0.02) < 0.002
    assert torch.equal(mine["layers"][1]["attn"]["wk"]["w"], lm.init(3)["layers"][1]["attn"]["wk"]["w"])


def test_layers_match_reference():
    from repro.models import layers as RL

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta=1e4).numpy(),
        np.asarray(RL.rope(jnp.asarray(x), jnp.asarray(pos), theta=1e4)), atol=1e-5,
    )
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(h), 1e-5).numpy(),
        np.asarray(RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(h), 1e-5)), atol=1e-5,
    )
    w = rng.normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_allclose(
        L.dense({"w": torch.from_numpy(w)}, torch.from_numpy(h)).numpy(),
        np.asarray(RL.dense({"w": jnp.asarray(w)}, jnp.asarray(h))), atol=1e-5,
    )


def test_unported_model_paths_raise():
    """An unknown family stops at ``build_model``, naming the families."""
    cfg = get_config("deepseek-7b").reduced().with_(family="retrieval")
    with pytest.raises(ValueError, match="unknown family 'retrieval'.*encdec.*vlm"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("arch,family", [("seamless-m4t-medium", "encdec"),
                                         ("phi-3-vision-4_2b", "vlm")])
def test_enc_dec_and_vlm_build_on_cpu(arch, family):
    """Both families of the last slice build on the CPU and make their
    params: enc-dec's two layer stacks, the VLM's ``vision_proj``."""
    cfg = get_config(arch).reduced()
    lm = build_model(cfg, device="cpu")
    assert lm.cfg.family == family and lm.device.type == "cpu"
    params = lm.init(0)
    if family == "encdec":
        assert "layers" not in params
        assert len(params["encoder"]) == cfg.n_encoder_layers
        assert len(params["decoder"]) == cfg.n_layers
        assert set(params["decoder"][0]) == {"ln_self", "self_attn", "ln_cross", "cross_attn",
                                             "ln_ffn", "ffn"}
    else:
        assert len(params["layers"]) == cfg.n_layers
        assert params["vision_proj"]["w"].shape == (cfg.d_model, cfg.d_model)


def test_init_cache_paged_layout():
    cfg = get_config("deepseek-7b").reduced().with_(kv_layout="paged", page_size=8)
    cache = T.init_cache(cfg, batch=2, max_len=20, device="cpu")
    assert cache["k_pages"].shape == (6, 8, cfg.n_kv_heads, cfg.hd)
    np.testing.assert_array_equal(cache["block_table"].numpy(), np.arange(6).reshape(2, 3))
    assert cache["len"].tolist() == [0, 0]
