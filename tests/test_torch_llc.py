"""The port's live modeled-LLC sampler (``repro_torch.obs.llc``) against
the JAX package's.

* The reference's cases of ``tests/test_obs.py`` (gauge parity with a
  direct ``fwd_llc_model`` call at the same footprint, gating, the
  shared-prefix gauges) run through both packages.
* History parity: the two packages' pools take the same operations
  (admission with prefix adoption, chunked writes, retirement), and after
  each one both samplers' history entries are equal, key for key; the same
  holds for the two continuous engines serving the same requests with
  ``llc_every=2``, whose gauges are equal too.
"""

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.traffic import fwd_llc_model as ref_fwd_llc_model
from repro.models import build_model as ref_build_model
from repro.obs import LLCSampler as RefSampler
from repro.obs import Registry as RefRegistry
from repro.serve import PagedKVPool as RefPool
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.kernels.traffic import fwd_llc_model
from repro_torch.models import build_model
from repro_torch.obs import DEFAULT_CAPACITY_BYTES, LLCSampler, Registry
from repro_torch.serve import PagedKVPool, Request, ServeEngine
from repro_torch.testing import params_from_jax


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


PKGS = {
    "reference": (RefSampler, RefRegistry, ref_fwd_llc_model),
    "port": (LLCSampler, Registry, fwd_llc_model),
}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


class FakePool:
    """The three pool attributes the sampler's footprint probe reads."""

    def __init__(self, lens, slot_pages, refs):
        self.lens = lens
        self._slot_pages = slot_pages
        self._ref = refs


def _sampler(cls, reg, **kw):
    kw.setdefault("page", 16)
    kw.setdefault("n_heads", 8)
    kw.setdefault("n_kv_heads", 2)
    kw.setdefault("head_dim", 32)
    kw.setdefault("elem_bytes", 2)
    kw.setdefault("current_order", "sawtooth")
    kw.setdefault("every", 1)
    return cls(reg, **kw)


def test_llc_gauge_parity_with_direct_model_call(pkg):
    cls, reg_cls, model = pkg
    reg = reg_cls()
    s = _sampler(cls, reg)
    pool = FakePool([70, 33, 0], [[1, 2, 3, 4, 5], [6, 7, 8], []], np.ones(16, np.int64))
    assert s.sample(pool)
    assert s.orders[0] == "sawtooth" and len(s.orders) >= 2
    spec = s.fwd_spec_for(70)
    assert spec.seq_kv == 80
    for order in s.orders:
        direct = model(spec, order, n_workers=s.n_workers, capacity_bytes=s.capacity_bytes)
        assert reg.value("llc.modeled_miss_bytes", order=order, model="fwd") == direct.misses
    assert reg.value("llc.footprint_bytes") == 2 * 8 * 16 * 2 * 32 * 2
    assert reg.value("llc.active_rows") == 2
    assert reg.value("llc.samples") == 1
    misses = [reg.value("llc.modeled_miss_bytes", order=o, model="fwd") for o in s.orders]
    assert misses[int(reg.value("llc.best_order_index"))] == min(misses)


def test_port_gauges_equal_a_direct_reference_call():
    """The port's gauges at a footprint equal the reference's model called
    directly on the spec the port derived."""
    reg = Registry()
    s = _sampler(LLCSampler, reg, orders=("cyclic", "sawtooth", "block_snake"), snake_group=2,
                 capacity_bytes=40_000)
    pool = FakePool([150, 97], [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [11, 12, 13, 14, 15, 16, 17]],
                    np.ones(20, np.int64))
    assert s.sample(pool, step_q=3)
    import repro.kernels.traffic as ref_tr

    spec = s.fwd_spec_for(150)
    rspec = ref_tr.FlashGridSpec(**{f: getattr(spec, f) for f in spec.__dataclass_fields__})
    for order in s.orders:
        want = ref_fwd_llc_model(rspec, order, snake_group=2 if order == "block_snake" else None,
                                 n_workers=s.n_workers, capacity_bytes=40_000)
        assert reg.value("llc.modeled_miss_bytes", order=order, model="fwd") == want.misses
    assert reg.value("llc.step_q_tokens") == 3
    assert set(s.history[-1]["verify_miss"]) == set(s.orders)


def test_llc_sampler_gating_and_empty_pool(pkg):
    cls, reg_cls, _ = pkg
    reg = reg_cls()
    s = _sampler(cls, reg, every=4)
    pool = FakePool([32], [[1, 2]], np.ones(4, np.int64))
    assert not s.maybe_sample(3, pool)
    assert s.maybe_sample(4, pool)
    assert not _sampler(cls, reg, every=0).maybe_sample(0, pool)
    assert not s.sample(FakePool([0], [[]], np.ones(1)))
    s2 = _sampler(cls, reg_cls(), current_order="cyclic")
    assert s2.orders[0] == "cyclic" and "sawtooth" in s2.orders
    assert s.last_fwd_miss == s.history[-1]["fwd_miss"]


def test_llc_shared_prefix_gauges_emitted_when_pages_shared(pkg):
    cls, reg_cls, _ = pkg
    reg = reg_cls()
    s = _sampler(cls, reg)
    refs = np.ones(16, np.int64)
    refs[1] = refs[2] = 3
    assert s.sample(FakePool([40, 40, 40], [[1, 2, 3], [1, 2, 4], [1, 2, 5]], refs))
    for order in s.orders:
        assert reg.find("llc.modeled_miss_bytes", order=order, model="shared_prefix") is not None
    assert reg.value("llc.shared_pages") == 2
    entry = s.history[-1]
    assert set(entry["shared_miss"]) == set(s.orders)
    assert entry["shared_frac"] == pytest.approx(2 / 5)


def test_default_capacity_is_the_reference_one():
    from repro.obs import DEFAULT_CAPACITY_BYTES as REF_DEFAULT

    assert DEFAULT_CAPACITY_BYTES == REF_DEFAULT == 3 * 2**20


# ---- history parity on the same pool operations --------------------------------------


def _history_sampler(cls, reg, cfg, capacity):
    return cls(reg, page=8, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
               elem_bytes=4, current_order="sawtooth",
               orders=("cyclic", "sawtooth", "block_snake"), snake_group=2, every=1,
               capacity_bytes=capacity)


@pytest.mark.parametrize("capacity", [3 * 2**20, 6_000.0])
def test_history_parity_on_the_same_pool_operations(capacity):
    cfg_r = ref_get_config("deepseek-7b").reduced().with_(kv_layout="paged", page_size=8)
    cfg_p = get_config("deepseek-7b").reduced().with_(kv_layout="paged", page_size=8)
    ref_pool = RefPool(cfg_r, 1, 4, 64)
    port_pool = PagedKVPool(cfg_p, 1, 4, 64, device="cpu")
    rs = _history_sampler(RefSampler, RefRegistry(), cfg_r, capacity)
    ps = _history_sampler(LLCSampler, Registry(), cfg_p, capacity)
    rng = np.random.default_rng(5)
    sysp = rng.integers(2, 200, size=20).astype(np.int32)
    prompts = [np.concatenate([sysp, rng.integers(2, 200, size=n).astype(np.int32)])
               for n in (3, 9, 14, 1)]

    def both(op, *args):
        a = getattr(ref_pool, op)(*args)
        b = getattr(port_pool, op)(*args)
        assert a == b, op
        assert rs.sample(ref_pool) == ps.sample(port_pool)
        assert rs.history == ps.history, op
        return b

    for slot, prompt in enumerate(prompts[:3]):
        shared = both("admit", slot, prompt, 6)
        rest = len(prompt) - shared
        both("ensure_writable", slot, rest)
        both("advance", slot, rest)
        both("register_prompt", slot, prompt)
    for _ in range(4):
        for slot in range(3):
            both("ensure_writable", slot, 1)
            both("advance", slot, 1)
    both("release", 1)
    shared = both("admit", 1, prompts[3], 6)
    assert shared > 0  # adopted the registered prefix: shared pages in the sample
    assert any(e["shared_miss"] for e in ps.history)
    assert len(ps.history) > 10


def test_engine_histories_and_gauges_equal_reference():
    jcfg = ref_get_config("deepseek-7b").reduced()
    jlm = ref_build_model(jcfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    lm = build_model(get_config("deepseek-7b").reduced(), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(7)
    sysp = rng.integers(2, jcfg.vocab, size=24).astype(np.int32)
    specs = [dict(tokens=np.concatenate([sysp, rng.integers(2, jcfg.vocab, size=3 + 6 * i)
                                         .astype(np.int32)]), max_new_tokens=5, rid=i)
             for i in range(4)]
    kw = dict(batch_size=2, max_len=96, page_size=8, prefill_chunk=16, llc_every=2,
              scheduler="continuous")
    ref = RefEngine(jlm, jparams, **kw)
    ref.generate([RefRequest(**s) for s in specs])
    eng = ServeEngine(lm, params, device="cpu", **kw)
    eng.generate([Request(**s) for s in specs])
    assert ref.llc.samples == eng.llc.samples > 3
    assert eng.llc.history == ref.llc.history
    for m in ref.obs.series():
        if m.name.startswith("llc."):
            assert eng.obs.value(m.name, **m.labels) == m.value, (m.name, m.labels)
