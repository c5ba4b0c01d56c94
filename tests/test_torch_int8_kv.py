"""The port's int8 KV caches (``kv_cache_dtype="int8"``) against the JAX
package's.

* ``quantize_int8_vec``/``dequantize_int8_vec``: payloads and scales equal
  to the reference's exactly on the same float32 input (round half to
  even), the round trip within ``scale / 2``, and the one-pass dequantize
  equal to the bits of the float32 product rounded once.
* ``init_cache``, ``fill_cache`` (contiguous, ring buffer and paged) and
  the ragged paged write: payloads and scale planes equal to the
  reference's exactly, on the same K/V.
* Prefill and three decode steps of deepseek-7b ``.reduced()`` (f32, the
  reference's weights by ``params_from_jax``), contiguous and paged, and of
  zamba2-2.7b (its shared attention's caches): within the model tests'
  2e-4; int8 logits within 0.1 relative of the unquantized ones (the
  reference's ``test_kv_cache.py`` limit), the caches under 0.75 of bf16's
  bytes.
* Greedy streams of both engines with int8 caches equal to the
  reference's (olmoe-1b-7b's continuous ones too), and a copy-on-write fork
  that copies the scale planes.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as ref_get_config
from repro.dist import compression as ref_compression
from repro.models import build_model as ref_build_model
from repro.models import transformer as RT
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro.serve import kv_pool as ref_pool
from repro_torch.configs import get_config
from repro_torch.dist import dequantize_int8_vec, quantize_int8_vec
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.serve import PagedKVPool, Request, ServeEngine
from repro_torch.testing import params_from_jax

TOL = dict(atol=2e-4, rtol=2e-4)
INT8 = dict(kv_cache_dtype="int8")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _equal_caches(pc: dict, jc: dict, names):
    for name in names:
        got, want = _np(pc[name]), _np(jc[name])
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# ---- quantization -----------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((2, 16, 4, 64), 3.0), ((5, 3, 128), 1e-3),
                                         ((7, 16), 40.0)])
def test_quantize_equals_reference_exactly(shape, scale):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    rows[1] = 0.0                                     # an all-zero vector: scale 1
    rows[2, :5] = [127.0, 2.5, -2.5, 3.5, -0.5]       # scale 1: halves round to even
    q, s = quantize_int8_vec(torch.from_numpy(x))
    rq, rs = ref_compression.quantize_int8_vec(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert s.shape == shape[:-1] and float(s.reshape(-1)[1]) == 1.0
    assert q.reshape(-1, shape[-1])[2, :5].tolist() == [127, 2, -2, 4, 0]
    back = dequantize_int8_vec(q, s, torch.float32).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(ref_compression.dequantize_int8_vec(rq, rs, jnp.float32)))
    assert (np.abs(back - x) <= s.numpy()[..., None] * 0.5 + 1e-6).all()
    bf = dequantize_int8_vec(q, s, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf.view(torch.int16),
                       (q.float() * s[..., None]).to(torch.bfloat16).view(torch.int16))


# ---- caches ----------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(window=8), dict(kv_layout="paged", page_size=4)],
                         ids=["contiguous", "ring", "paged"])
def test_init_and_fill_cache_equal_reference(kw):
    jcfg = ref_get_config("deepseek-7b").reduced().with_(**INT8, **kw)
    cfg = get_config("deepseek-7b").reduced().with_(**INT8, **kw)
    jc = RT.init_cache(jcfg, 2, 20)
    pc = T.init_cache(cfg, 2, 20)
    names = [n for n in jc if n not in ("len", "block_table")]
    assert list(pc) == list(jc) and len(names) == 4
    _equal_caches(pc, jc, names)
    rng = np.random.default_rng(1)
    k = (rng.standard_normal((2, 13, cfg.n_kv_heads, cfg.hd)) * 2).astype(np.float32)
    v = rng.standard_normal((2, 13, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    jc = RT.fill_cache(jcfg, jc, jnp.asarray(k), jnp.asarray(v))
    pc = T.fill_cache(cfg, pc, torch.from_numpy(k), torch.from_numpy(v))
    _equal_caches(pc, jc, names)
    np.testing.assert_array_equal(_np(pc["len"]), _np(jc["len"]))


def test_ragged_paged_write_equals_reference():
    """A ragged chunk (a free row, a short row) through a shuffled block
    table: int8 pages and scales equal the reference's; the invalid rows'
    writes land in page 0, left out."""
    jcfg = ref_get_config("deepseek-7b").reduced().with_(**INT8, kv_layout="paged", page_size=4)
    cfg = get_config("deepseek-7b").reduced().with_(**INT8, kv_layout="paged", page_size=4)
    rng = np.random.default_rng(2)
    bt = rng.permutation(np.arange(1, 13))[:9].reshape(3, 3).astype(np.int32)
    pc = T.init_cache(cfg, 3, 12)
    jc = RT.init_cache(jcfg, 3, 12)
    k = (rng.standard_normal((3, 6, cfg.n_kv_heads, cfg.hd)) * 3).astype(np.float32)
    v = rng.standard_normal((3, 6, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    starts = np.array([0, 3, 5], np.int32)
    q_lens = np.array([6, 0, 4], np.int32)
    jc = dict(jc, block_table=jnp.asarray(bt))
    pc = dict(pc, block_table=torch.from_numpy(bt))
    jout = RT._paged_write(jcfg, jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(starts),
                           jnp.asarray(q_lens))
    pout = T._paged_write(cfg, pc, torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(starts), torch.from_numpy(q_lens))
    for name in ("k_pages", "k_pages_scale", "v_pages", "v_pages_scale"):
        np.testing.assert_array_equal(_np(pout[name])[1:], _np(jout[name])[1:], err_msg=name)


# ---- the model ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            jlm = ref_build_model(ref_get_config(arch).reduced())
            jparams = jlm.init(jax.random.PRNGKey(0))
            cache[arch] = (jparams, params_from_jax(jax.tree.map(np.asarray, jparams)))
        return cache[arch]

    return get


def _models(weights, arch="deepseek-7b", **kw):
    jparams, params = weights(arch)
    jlm = ref_build_model(ref_get_config(arch).reduced().with_(**kw))
    lm = build_model(get_config(arch).reduced().with_(**kw), device="cpu")
    return jlm, jparams, lm, params


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


@pytest.mark.parametrize("arch,kw", [
    ("deepseek-7b", dict()),
    ("deepseek-7b", dict(kv_layout="paged", page_size=8)),
    ("zamba2-2_7b", dict()),
], ids=["contiguous", "paged", "zamba2"])
def test_int8_prefill_and_decode_equal_reference(weights, arch, kw):
    jlm, jparams, lm, params = _models(weights, arch, **INT8, **kw)
    _, _, lm16, _ = _models(weights, arch, **kw)
    rng = np.random.default_rng(3)
    toks = rng.integers(2, lm.cfg.vocab, size=(2, 21)).astype(np.int32)
    jl, jc = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, 48)
    pl, pc = lm.prefill(params, {"tokens": torch.from_numpy(toks)}, 48)
    l16, c16 = lm16.prefill(params, {"tokens": torch.from_numpy(toks)}, 48)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    for t in range(3):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(pl[:, -1].argmax(-1).numpy(), nxt[:, 0])
        jl, jc = jlm.decode_step(jparams, jnp.asarray(nxt), jc)
        pl, pc = lm.decode_step(params, torch.from_numpy(nxt), pc)
        l16, c16 = lm16.decode_step(params, torch.from_numpy(nxt), c16)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        rel = float((pl - l16).abs().max() / (l16.abs().max() + 1e-9))
        assert 0 < rel < 0.1, rel
    bf16 = T.init_cache(lm.cfg.with_(kv_cache_dtype="bfloat16"), 2, 48)
    int8 = T.init_cache(lm.cfg, 2, 48)
    assert _nbytes({k: v for k, v in int8.items() if k not in ("len", "block_table")}) < \
        0.75 * _nbytes({k: v for k, v in bf16.items() if k not in ("len", "block_table")})


def _specs(vocab, n=6, new=6, seed=7):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(2, vocab, size=40).astype(np.int32)
    specs = []
    for i in range(n):
        if i == 3:
            toks = sysp[:30].copy()          # adopts a partial page, then forks
        else:
            toks = np.concatenate([sysp, rng.integers(2, vocab, size=3 + 5 * i).astype(np.int32)])
        specs.append(dict(tokens=toks, max_new_tokens=new, rid=i))
    return specs


@pytest.mark.parametrize("scheduler,arch", [("continuous", "deepseek-7b"),
                                            ("static", "deepseek-7b"),
                                            ("static", "zamba2-2_7b"),
                                            ("continuous", "olmoe-1b-7b")])
def test_int8_greedy_streams_equal_reference(weights, scheduler, arch):
    jlm, jparams, lm, params = _models(weights, arch, **INT8)
    kw = dict(batch_size=2, max_len=96, page_size=8, prefill_chunk=16, scheduler=scheduler)
    specs = _specs(lm.cfg.vocab)
    ref = RefEngine(jlm, jparams, **kw)
    eng = ServeEngine(lm, params, device="cpu", **kw)
    want = ref.generate([RefRequest(**s) for s in specs])
    got = eng.generate([Request(**s) for s in specs])
    for a, b in zip(want, got):
        assert b.status == a.status == "ok" and b.steps == a.steps
        np.testing.assert_array_equal(b.tokens, a.tokens)
    if scheduler == "continuous":
        pool = eng.last_pool
        assert sorted(pool.pages) == ["k_pages", "k_pages_scale", "v_pages", "v_pages_scale"]
        assert pool.pages["k_pages"].dtype == torch.int8
        for key in ("mixed_steps", "wide_steps", "pages_adopted", "cow_forks"):
            assert getattr(eng.last_stats, key) == getattr(ref.last_stats, key), key
        assert eng.last_stats.cow_forks > 0
        step = eng.step_graphs()["mixed/16"]
        assert len(step.state) == 4   # pages and scale planes, held by the graph
        pool.check_invariants()


def test_int8_cow_fork_copies_scale_planes():
    """Two pools in lock step write the same quantized K/V through their
    block tables; an adopter's first write forks the shared tail page, and
    the fork carries the payload and its scales."""
    jcfg = ref_get_config("deepseek-7b").reduced().with_(**INT8, kv_layout="paged", page_size=4)
    cfg = get_config("deepseek-7b").reduced().with_(**INT8, kv_layout="paged", page_size=4)
    ref = ref_pool.PagedKVPool(jcfg, jcfg.n_layers, 3, 32, n_pages=20)
    port = PagedKVPool(cfg, cfg.n_layers, 3, 32, device="cpu", n_pages=20)
    assert list(port.pages) == list(ref.pages)
    rng = np.random.default_rng(4)
    prompt = np.arange(2, 12, dtype=np.int32)
    for pool in (ref, port):
        pool.admit(0, prompt, 4)
        pool.ensure_writable(0, 10)
    # The donor's 10 positions, written into both pools' pages.
    k = (rng.standard_normal((cfg.n_layers, 1, 10, cfg.n_kv_heads, cfg.hd)) * 2).astype(np.float32)
    bt = port.block_tables[:1].copy()
    for layer in range(cfg.n_layers):
        pc = {"k_pages": port.pages["k_pages"][layer],
              "k_pages_scale": port.pages["k_pages_scale"][layer],
              "v_pages": port.pages["v_pages"][layer],
              "v_pages_scale": port.pages["v_pages_scale"][layer],
              "block_table": torch.from_numpy(bt)}
        T._paged_write(cfg, pc, torch.from_numpy(k[layer]), torch.from_numpy(-k[layer]),
                       torch.zeros(1, dtype=torch.int32), torch.full((1,), 10, dtype=torch.int32))
        jc = RT._paged_write(jcfg, {n: ref.pages[n][layer] for n in ref.pages} |
                             {"block_table": jnp.asarray(bt)}, jnp.asarray(k[layer]),
                             jnp.asarray(-k[layer]), jnp.zeros(1, jnp.int32),
                             jnp.full((1,), 10, jnp.int32))
        for n in ref.pages:
            ref.pages[n] = ref.pages[n].at[layer].set(jc[n])
    for pool in (ref, port):
        pool.advance(0, 10)
        pool.register_prompt(0, prompt)
        assert pool.admit(1, prompt[:7], 4) == 6
        pool.ensure_writable(1, 1)                # forks the shared tail page
    assert port.cow_forks == ref.cow_forks == 1
    np.testing.assert_array_equal(port.block_tables, ref.block_tables)
    fork, shared = port.block_tables[1, 1], port.block_tables[0, 1]
    for name in port.pages:
        np.testing.assert_array_equal(port.pages[name].numpy(), np.asarray(ref.pages[name]))
        assert torch.equal(port.pages[name][:, fork], port.pages[name][:, shared])
    assert (port.pages["k_pages_scale"][:, fork] != 1).any()
    bf16 = PagedKVPool(cfg.with_(kv_cache_dtype="bfloat16"), cfg.n_layers, 3, 32, device="cpu",
                       n_pages=20, dtype=torch.bfloat16)
    assert port.nbytes() < 0.75 * bf16.nbytes()
    port.check_invariants()
