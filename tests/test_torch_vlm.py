"""The port's VLM family (phi-3-vision-4.2B: the dense decoder with a
projected prefix of patch embeddings) against the JAX package's, on the
same weights.

The reference's params (``LM.init`` of the ``.reduced()`` config, float32)
are loaded into the port with ``params_from_jax``; inputs are drawn with
numpy from a seed, random prefix embeddings among them, so ``vision_proj``
counts (the serve engine's zero prefix makes it vanish). The prefix follows
the reference's rules: ``min(n_prefix_embeds, max(S // 4, 1))`` embeddings
in a training batch of S positions, ``min(n_prefix_embeds, 8)`` zero ones
when serving. Covered: the weight layout, ``LM.loss`` and its gradients,
``LM.prefill`` logits and caches then ``decode_step``, the reference's
prefill/decode consistency property on the port, greedy static
``ServeEngine`` streams over two groups of different buckets (one decode
step; capacity ``max_len`` less the prefix, and the reference's error when
nothing is left) and the decode step under the host-read guard.
Tolerances (float32), relative to the output's scale as in
``test_torch_ssm.py``: 1e-5 for caches, 1e-4 for logits, the loss and its
gradients; the consistency property at the reference's own 1e-3; greedy
streams equal token for token.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.testing import params_from_jax
from repro_torch.train.optimizer import named_leaves
from test_torch_step_graph import NoHostRead

ARCH = "phi-3-vision-4_2b"
CACHES = 1e-5
LOGITS = 1e-4   # logits, loss and gradients


def _close(got, want, tol, err_msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol, err_msg=err_msg)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jlm = ref_build_model(ref_get_config(ARCH).reduced())
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = build_model(get_config(ARCH).reduced(), device="cpu")
    return jlm, jparams, lm, params_from_jax(jax.tree.map(np.asarray, jparams))


def _batch(cfg, b, s, seed, prefix=None):
    """A training batch of S positions by the reference's rule: a prefix of
    ``min(n_prefix_embeds, max(S // 4, 1))`` random embeddings (or
    ``prefix``), then the tokens."""
    rng = np.random.default_rng(seed)
    p = min(cfg.n_prefix_embeds, max(s // 4, 1)) if prefix is None else prefix
    return {"tokens": rng.integers(2, cfg.vocab, size=(b, s - p)).astype(np.int32),
            "prefix_embeds": rng.normal(size=(b, p, cfg.d_model)).astype(np.float32)}


def test_params_from_jax_vlm_layout(models):
    """The layer stack becomes a list; ``vision_proj`` is converted as it
    is."""
    _, jparams, lm, params = models
    assert len(params["layers"]) == lm.cfg.n_layers
    np.testing.assert_array_equal(params["vision_proj"]["w"].numpy(),
                                  np.asarray(jparams["vision_proj"]["w"]))
    assert params["vision_proj"]["w"].shape == (lm.cfg.d_model, lm.cfg.d_model)


@pytest.mark.parametrize("s", [40, 13])
def test_loss_and_grads_match_reference(models, s):
    """S 40 takes the whole prefix of 8 (the reduced config's), S 13 a
    prefix of 3; the prefix positions are masked out of the loss."""
    jlm, jparams, lm, params = models
    batch = _batch(lm.cfg, 2, s, s)
    assert batch["prefix_embeds"].shape[1] == min(8, s // 4)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.loss(p, jax.tree.map(jnp.asarray, batch)), has_aux=True)(jparams)
    leaves = list(named_leaves(params))
    for _, t in leaves:
        t.requires_grad_(True)
    try:
        loss, m = lm.loss(params, batch)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
    finally:
        for _, t in leaves:
            t.requires_grad_(False)
    _close(loss, jloss, LOGITS)
    _close(m["total_loss"], jm["total_loss"], LOGITS)
    _close(m["tokens"], jm["tokens"], LOGITS)
    want = dict(named_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads))))
    assert set(want) == {path for path, _ in leaves}
    for (path, _), g in zip(leaves, grads):
        _close(g, want[path], LOGITS, err_msg=str(path))
    assert float(dict(zip([p for p, _ in leaves], grads))[("vision_proj", "w")].abs().max()) > 0


def test_prefill_and_decode_match_reference(models):
    """8 random prefix embeddings before 21 tokens: logits, the caches of
    29 positions, then 5 greedy decode steps."""
    jlm, jparams, lm, params = models
    cfg = lm.cfg
    b, max_len = 3, 48
    batch = _batch(cfg, b, 29, 7, prefix=8)
    jl, jc = jlm.prefill(jparams, jax.tree.map(jnp.asarray, batch), max_len)
    pl, pc = lm.prefill(params, batch, max_len)
    assert pl.shape == (b, 1, cfg.vocab)
    _close(pl, jl, LOGITS)

    def check_caches():
        for name in ("k", "v"):
            assert tuple(pc[name].shape) == tuple(np.shape(jc[name]))
            _close(pc[name], jc[name], CACHES, err_msg=name)
        assert pc["len"].dim() == 0 and int(pc["len"]) == int(np.asarray(jc["len"])[0])

    check_caches()
    assert int(pc["len"]) == 29
    for _ in range(5):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(pl[:, -1].argmax(-1).numpy(), nxt[:, 0])
        jl, jc = jlm.decode_step(jparams, jnp.asarray(nxt), jc)
        pl, pc = lm.decode_step(params, torch.from_numpy(nxt), pc)
        _close(pl, jl, LOGITS)
    check_caches()


@pytest.mark.parametrize("s,seed", [(24, 1), (11, 2)])
def test_prefill_decode_consistency(models, s, seed):
    """The reference's property (``test_models_smoke.py``: 8 prefix
    embeddings) on the port: the decode step after a prefill gives the
    logits of a prefill one token longer, at the reference's 1e-3."""
    _, _, lm, params = models
    batch = {k: torch.from_numpy(v) for k, v in _batch(lm.cfg, 2, s + 8, seed, prefix=8).items()}
    logits, caches = lm.prefill(params, batch, 48)
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    lg, _ = lm.decode_step(params, nxt, caches)
    ext = dict(batch, tokens=torch.cat([batch["tokens"], nxt], 1))
    want, _ = lm.prefill(params, ext, 48)
    np.testing.assert_allclose(lg[:, -1].numpy(), want[:, -1].numpy(), atol=1e-3, rtol=1e-3)


# ---- serving ----------------------------------------------------------------------


def _specs(vocab, seed=3):
    rng = np.random.default_rng(seed)
    lens_new = [(5, 6), (70, 9), (17, 7), (40, 8), (3, 5), (12, 7)]
    return [dict(tokens=rng.integers(2, vocab, size=n).astype(np.int32), max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate(lens_new)]


def test_static_engine_greedy_streams_equal_reference(models):
    """Two groups of 3 with buckets 56 (max_len 64 less the prefix of 8: a
    70-token prompt keeps its tail, one token of room) and 40, each
    prefilled after 8 zero prefix embeddings; the streams equal the
    reference's with one decode step, and again on a second
    ``generate()``."""
    jlm, jparams, lm, params = models
    specs = _specs(lm.cfg.vocab)
    kw = dict(batch_size=3, max_len=64)
    want = RefEngine(jlm, jparams, scheduler="static", **kw).generate(
        [RefRequest(**s) for s in specs])
    eng = ServeEngine(lm, params, device="cpu", **kw)
    assert eng._prefix == 8 and eng._cap == 56
    for _ in range(2):
        got = eng.generate([Request(**s) for s in specs])
        for a, b in zip(want, got):
            assert b.rid == a.rid and b.status == a.status == "ok" and b.steps == a.steps
            np.testing.assert_array_equal(b.tokens, a.tokens)
    assert got[1].steps == 1 and got[3].steps == 8
    assert eng.compiled_step_count() == 1
    batch = eng._prefill_batch(np.full((3, 5), 4, np.int32))
    assert batch["prefix_embeds"].shape == (3, 8, lm.cfg.d_model)
    assert not batch["prefix_embeds"].any()


def test_static_engine_refuses_a_cache_the_prefix_fills(models):
    """As the reference: ``max_len`` at or below the prefix leaves no room."""
    jlm, jparams, lm, params = models
    for eng_cls, args in ((RefEngine, (jlm, jparams)), (ServeEngine, (lm, params))):
        kw = {} if eng_cls is RefEngine else {"device": "cpu"}
        with pytest.raises(ValueError, match="the 8 VLM prefix embeddings leave no room"):
            eng_cls(*args, batch_size=2, max_len=8, **kw)


def test_decode_step_reads_no_host_value(models):
    """The static engine's decode step runs under the host-read guard of
    the captured steps."""
    _, _, lm, params = models
    eng = ServeEngine(lm, params, batch_size=3, max_len=64, device="cpu")
    eng.generate([Request(**s) for s in _specs(lm.cfg.vocab)[:3]])
    step = eng.step_graphs()["decode"]
    with NoHostRead():
        logits, greedy = step()
    assert torch.isfinite(logits).all() and greedy.dtype == torch.int32
