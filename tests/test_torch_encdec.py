"""The port's enc-dec family (seamless-m4t-medium, ``repro_torch.models.encdec``)
against the JAX package's, on the same weights.

The reference's params (``LM.init`` of the ``.reduced()`` config, float32)
are loaded into the port with ``params_from_jax``; inputs are drawn with
numpy from a seed: random source embeddings, so the encoder and every
cross-attention count (the serve engine's zero source makes both vanish).
Covered: the weight layout, ``encode``, ``decode_train``, ``LM.loss`` and
its gradients, ``LM.prefill`` logits and both caches then ``decode_step``,
the reference's prefill/decode consistency property on the port, greedy
static ``ServeEngine`` streams over two groups of different buckets (one
decode step, the cross K/V in buffers of ``max_len`` rows) and the decode
step under the host-read guard. Tolerances (float32), relative to the
output's scale as in ``test_torch_ssm.py``: 1e-5 for the encoder and
decoder outputs and the caches, 1e-4 for logits, the loss and its
gradients (the sums run in other orders); the consistency property at the
reference's own 1e-3; greedy streams equal token for token.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_ed
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import encdec as ED
from repro_torch.serve import Request, ServeEngine
from repro_torch.testing import params_from_jax
from repro_torch.train.optimizer import named_leaves
from test_torch_step_graph import NoHostRead

ARCH = "seamless-m4t-medium"
HIDDEN = 1e-5   # encoder and decoder outputs, caches
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


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(2, vocab, size=shape).astype(np.int32)


def _src(d, shape, seed):
    return np.random.default_rng(seed).normal(size=shape + (d,)).astype(np.float32)


def test_params_from_jax_encdec_layout(models):
    """The stacked encoder and decoder become lists of layer dicts; params
    with no layer stack, or a ``layers`` stack beside the enc-dec ones,
    still raise."""
    _, jparams, lm, params = models
    cfg = lm.cfg
    assert "layers" not in params
    assert len(params["encoder"]) == cfg.n_encoder_layers
    assert len(params["decoder"]) == cfg.n_layers
    for i, lp in enumerate(params["decoder"]):
        for name in ("self_attn", "cross_attn"):
            np.testing.assert_array_equal(
                lp[name]["wk"]["w"].numpy(), np.asarray(jparams["decoder"][name]["wk"]["w"])[i])
    np.testing.assert_array_equal(params["encoder"][1]["attn"]["wq"]["w"].numpy(),
                                  np.asarray(jparams["encoder"]["attn"]["wq"]["w"])[1])
    base = {"embed": {"table": np.zeros((4, 2), np.float32)}}
    stack = {"w": np.zeros((2, 3), np.float32)}
    for bad in (base, dict(base, encoder=stack), dict(base, layers=stack, encoder=stack,
                                                      decoder=stack)):
        with pytest.raises(ValueError, match="layer stack|'encoder' and 'decoder'"):
            params_from_jax(bad)


def test_encode_and_decode_train_match_reference(models):
    _, jparams, lm, params = models
    cfg = lm.cfg
    src = _src(cfg.d_model, (2, 37), 1)
    enc = ED.encode(params, cfg, torch.from_numpy(src))
    jenc = ref_ed.encode(jparams, ref_get_config(ARCH).reduced(), jnp.asarray(src))
    _close(enc, jenc, HIDDEN)
    tgt = _src(cfg.d_model, (2, 23), 2)
    got = ED.decode_train(params, cfg, torch.from_numpy(tgt), enc)
    want = ref_ed.decode_train(jparams, ref_get_config(ARCH).reduced(), jnp.asarray(tgt), jenc)
    _close(got, want, HIDDEN)


def test_loss_and_grads_match_reference(models):
    jlm, jparams, lm, params = models
    cfg = lm.cfg
    batch = {"src_embeds": _src(cfg.d_model, (2, 40), 3),
             "tgt_tokens": _tokens(cfg.vocab, (2, 40), 4)}
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
    want = dict(named_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads))))
    assert set(want) == {path for path, _ in leaves}
    for (path, _), g in zip(leaves, grads):
        _close(g, want[path], LOGITS, err_msg=str(path))
    # the encoder's weights get gradients through every cross-attention
    assert any(path[0] == "encoder" and float(g.abs().max()) > 0
               for (path, _), g in zip(leaves, grads))


def test_prefill_and_decode_match_reference(models):
    """A 29-position source against a 17-token target prefix: logits, the
    self caches (and their length) and the cross caches (the encoder's K/V
    as each layer projects them in the first S_src of ``max_len`` rows,
    ``kv_len`` = S_src), then 5 greedy decode steps."""
    jlm, jparams, lm, params = models
    cfg = lm.cfg
    b, s, s_src, max_len = 3, 17, 29, 40
    batch = {"src_embeds": _src(cfg.d_model, (b, s_src), 5),
             "tgt_tokens": _tokens(cfg.vocab, (b, s), 6)}
    jl, jc = jlm.prefill(jparams, jax.tree.map(jnp.asarray, batch), max_len)
    pl, pc = lm.prefill(params, batch, max_len)
    assert pl.shape == (b, 1, cfg.vocab)
    _close(pl, jl, LOGITS)

    def check_caches():
        for name in ("k", "v"):
            assert tuple(pc["self"][name].shape) == tuple(np.shape(jc["self"][name]))
            _close(pc["self"][name], jc["self"][name], HIDDEN, err_msg=f"self.{name}")
            # the port's cross K/V have max_len rows, zero past S_src
            got = pc["cross"][name]
            assert got.shape[2] == max_len
            assert tuple(got[:, :, :s_src].shape) == tuple(np.shape(jc["cross"][name]))
            _close(got[:, :, :s_src], jc["cross"][name], HIDDEN, err_msg=f"cross.{name}")
            assert not got[:, :, s_src:].any()
        assert pc["self"]["len"].dim() == 0 and pc["self"]["len"].dtype == torch.int32
        assert int(pc["self"]["len"]) == int(np.asarray(jc["self"]["len"])[0])
        assert pc["cross"]["kv_len"].dim() == 0 and int(pc["cross"]["kv_len"]) == s_src
        np.testing.assert_array_equal(np.asarray(jc["cross"]["kv_len"]), s_src)

    check_caches()
    for _ in range(5):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(pl[:, -1].argmax(-1).numpy(), nxt[:, 0])
        jl, jc = jlm.decode_step(jparams, jnp.asarray(nxt), jc)
        pl, pc = lm.decode_step(params, torch.from_numpy(nxt), pc)
        _close(pl, jl, LOGITS)
    check_caches()
    assert int(pc["self"]["len"]) == s + 5


@pytest.mark.parametrize("s,s_src,seed", [(24, 24, 1), (9, 31, 2)])
def test_prefill_decode_consistency(models, s, s_src, seed):
    """The reference's property (``test_models_smoke.py``) on the port: the
    decode step after a prefill gives the logits of a prefill one token
    longer, at the reference's 1e-3; also with a source longer than the
    target."""
    _, _, lm, params = models
    cfg = lm.cfg
    src = torch.from_numpy(_src(cfg.d_model, (2, s_src), seed))
    toks = torch.from_numpy(_tokens(cfg.vocab, (2, s), seed + 10))
    logits, caches = lm.prefill(params, {"src_embeds": src, "tgt_tokens": toks}, 48)
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    lg, _ = lm.decode_step(params, nxt, caches)
    ext = torch.cat([toks, nxt], 1)
    want, _ = lm.prefill(params, {"src_embeds": src, "tgt_tokens": ext}, 48)
    np.testing.assert_allclose(lg[:, -1].numpy(), want[:, -1].numpy(), atol=1e-3, rtol=1e-3)


# ---- serving ----------------------------------------------------------------------


def _specs(vocab, seed=3):
    rng = np.random.default_rng(seed)
    lens_new = [(5, 6), (70, 9), (17, 7), (40, 8), (3, 5), (12, 7)]
    return [dict(tokens=rng.integers(2, vocab, size=n).astype(np.int32), max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate(lens_new)]


def test_static_engine_greedy_streams_equal_reference(models):
    """Two groups of 3 with buckets 64 (a 70-token prompt over max_len 64
    keeps its tail) and 40: the second group's cross K/V fill 40 of the
    buffers' 64 rows, the rest zeroed. The streams equal the reference's, with one decode
    step for both groups, and a second ``generate()`` on the same engine
    gives them again."""
    jlm, jparams, lm, params = models
    specs = _specs(lm.cfg.vocab)
    kw = dict(batch_size=3, max_len=64)
    want = RefEngine(jlm, jparams, scheduler="static", **kw).generate(
        [RefRequest(**s) for s in specs])
    eng = ServeEngine(lm, params, device="cpu", **kw)
    for _ in range(2):
        got = eng.generate([Request(**s) for s in specs])
        for a, b in zip(want, got):
            assert b.rid == a.rid and b.status == a.status == "ok" and b.steps == a.steps
            np.testing.assert_array_equal(b.tokens, a.tokens)
    assert got[1].steps == 1 and got[3].steps == 8   # bucket 64: one token of room
    assert eng.compiled_step_count() == 1
    cross = eng._decode_caches["cross"]
    assert cross["k"].shape[2] == kw["max_len"] and int(cross["kv_len"]) == 40
    assert not cross["k"][:, :, 40:].any() and not cross["v"][:, :, 40:].any()


def test_static_engine_serves_the_zero_source_stub():
    """The engine feeds the reference's stub, zero ``src_embeds`` of the
    group's bucket: with it the encoder's output is exactly zero, so are
    the cross K/V, and the streams are those of a decoder with no
    cross-attention at all."""
    lm = build_model(get_config(ARCH).reduced(), device="cpu")
    params = lm.init(0)
    eng = ServeEngine(lm, params, batch_size=2, max_len=32, device="cpu")
    batch = eng._prefill_batch(np.full((2, 7), 5, np.int32))
    assert batch["src_embeds"].shape == (2, 7, lm.cfg.d_model) and not batch["src_embeds"].any()
    _, caches = lm.prefill(params, batch, 32)
    assert not caches["cross"]["k"].any() and not caches["cross"]["v"].any()
    specs = _specs(lm.cfg.vocab)[:4]
    got = eng.generate([Request(**s) for s in specs])
    for lp in params["decoder"]:
        lp["cross_attn"]["wo"]["w"].zero_()
    again = ServeEngine(lm, params, batch_size=2, max_len=32, device="cpu").generate(
        [Request(**s) for s in specs])
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_decode_step_reads_no_host_value(models):
    """The static engine's decode step (self and cross attention, the
    cross length a device tensor) runs under the host-read guard of the
    captured steps."""
    _, _, lm, params = models
    eng = ServeEngine(lm, params, batch_size=3, max_len=64, device="cpu")
    eng.generate([Request(**s) for s in _specs(lm.cfg.vocab)[:3]])
    step = eng.step_graphs()["decode"]
    with NoHostRead():
        logits, greedy = step()
    assert torch.isfinite(logits).all() and greedy.dtype == torch.int32
