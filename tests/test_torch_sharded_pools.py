"""The continuous engine's paged pools split on the KV heads across a mesh.

* Specs on device-free meshes: ``dist.sharding.pool_specs`` puts a pool's
  KV heads (``k_pages``/``v_pages`` (L, n_pages, page, Hkv, hd) and the
  int8 scale planes (L, n_pages, page, Hkv)) on the tensor axis exactly
  where the reference's ``cache_shardings`` puts the heads of a cache of
  the same model on the same ``AbstractMesh``, for every arch the
  continuous engine serves, reduced and at full size (8 KV heads on a
  16-way tensor axis: whole), and nowhere else.
* One 4-rank gloo run (the harness of ``test_torch_dist.py``): reduced
  deepseek-7b (2 KV heads) on 2x2, where each rank holds half the pool as
  a DTensor at ``Shard`` on the head dim. After one mixed step on the same
  inputs each rank's local pages are the unsharded engine's head slice
  (f32, within 1e-5); the streams are the same on every rank and the
  unsharded port's at ``test_sharded_serve_engine``'s tolerance; an eager
  mixed step under ``analysis.trace.RankTrace`` runs no collective over
  the tensor axis on K/V rows (the parent's ``_paged_write`` all-gathered
  K and V there in every layer); each captured step under the host-read
  guard. On 1x4 (2 heads do not divide 4) the pools stay plain tensors
  and serve as before. An int8 pool splits its scale planes alike. A
  tiered pool on 2x2 brings every resumed slot's local pages back equal to
  a copy kept before its spill, and counts this rank's page-row bytes. The
  static engine's int8 caches serve on 2x2 too.
* ``ServeEngine(scheduler="continuous")`` refuses the families the
  reference refuses with the reference's ``ValueError``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import torch

from repro.configs import ParallelConfig as RefParallelConfig
from repro.configs import get_config as ref_get_config
from repro.dist import sharding as ref_shd
from repro.models import build_model as ref_build_model
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import ParallelConfig, get_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.dist.sharding import MeshShape, pool_specs
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine  # noqa: F401 (Request: _COMMON)
from repro_torch.serve.engine import supports_continuous
from test_torch_dist import _run_ranks

torch.set_num_threads(1)

PCFG = dict(fsdp_axes=("data",), data_axes=("data",))
CONTINUOUS = [a for a in ARCH_IDS if supports_continuous(get_config(a))]
REFUSED = [a for a in ARCH_IDS if not supports_continuous(get_config(a))]
MESHES = [(1, 1), (2, 2), (1, 4), (2, 8), (16, 16)]
# The engines and requests of the gloo run and of the unsharded side (the
# ranks' script runs this text too): one mixed step of two 8-token prompts
# (one chunk each, within the budget), then the four requests of
# test_torch_dist.py's sharded serving; the tiered geometry of
# test_torch_tiering.py, which spills.
_COMMON = '''
ENGINE = dict(batch_size=4, max_len=64, scheduler="continuous", page_size=8, prefill_chunk=16)
TIERED = dict(batch_size=2, max_len=64, scheduler="continuous", page_size=8, prefill_chunk=8,
              admission="optimistic", pool_pages=8, host_pages=24, prefetch_depth=4,
              max_preemptions=50)


def _one_step_reqs():
    return [Request(tokens=np.arange(2, 10, dtype=np.int32) + 3 * i, max_new_tokens=1, rid=i)
            for i in range(2)]


def _reqs():
    prompt = np.arange(2, 10, dtype=np.int32)
    return [Request(tokens=prompt + 3 * i, max_new_tokens=5, rid=i) for i in range(4)]


def _tier_reqs(vocab):
    rng = np.random.default_rng(5)
    return [Request(tokens=rng.integers(2, vocab, size=20).astype(np.int32), max_new_tokens=16,
                    rid=i) for i in range(4)]
'''
exec(_COMMON)


def _pool_leaves(cfg, n_pages=33, page=8):
    shape = (cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.hd)
    meta = lambda s: torch.empty(s, device="meta")  # noqa: E731
    return {"k_pages": meta(shape), "v_pages": meta(shape),
            "k_pages_scale": meta(shape[:-1]), "v_pages_scale": meta(shape[:-1])}


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", CONTINUOUS)
def test_pool_specs_put_heads_where_the_reference_caches_do(arch, reduced, mesh_shape):
    """The pool's head entry is the head entry of the reference's
    ``cache_shardings`` for a cache of the same model on the same mesh;
    every other dim of a pool leaf is replicated."""
    cfg = get_config(arch)
    rcfg = ref_get_config(arch)
    if reduced:
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    assert (cfg.n_kv_heads, cfg.hd) == (rcfg.n_kv_heads, rcfg.hd)
    mesh = MeshShape(mesh_shape, ("data", "model"))
    specs = pool_specs(_pool_leaves(cfg), ParallelConfig(**PCFG), mesh)
    cache = (cfg.n_layers, 8, 64, cfg.n_kv_heads, cfg.hd)
    sds = lambda s: jax.ShapeDtypeStruct(s, jnp.bfloat16)  # noqa: E731
    ref = ref_shd.cache_shardings(
        {"k": sds(cache), "v": sds(cache), "k_scale": sds(cache[:-1]), "v_scale": sds(cache[:-1])},
        RefParallelConfig(**PCFG), jax.sharding.AbstractMesh(mesh_shape, ("data", "model")))
    for name, ref_name in (("k_pages", "k"), ("v_pages", "v"), ("k_pages_scale", "k_scale"),
                           ("v_pages_scale", "v_scale")):
        spec, want = tuple(specs[name]), tuple(ref[ref_name].spec)
        assert spec[3] == want[3], (name, spec, want)
        assert all(e is None for i, e in enumerate(spec) if i != 3), (name, spec)
    if not reduced and cfg.n_kv_heads == 8 and mesh_shape[1] == 16:
        assert specs["k_pages"][3] is None  # 8 KV heads on 16 ranks: whole


_BODY = '''
import faulthandler
faulthandler.enable()  # a rank that aborts prints where
from test_torch_step_graph import NoHostRead

from repro_torch.analysis.trace import RankTrace
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine


class GroupTrace(RankTrace):
    """RankTrace, each collective's process group kept beside it (the last
    string argument of a functional collective)."""

    def __init__(self):
        super().__init__()
        self.groups = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        n = len(self.ops)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if len(self.ops) > n and self.ops[-1].collective:
            name = next(a for a in reversed(args) if isinstance(a, str))
            self.groups.append((self.ops[-1].collective, self.ops[-1].outputs, name))
        return out


def pools(eng):
    pool = eng.last_pool
    return {"leaves": {k: (type(t).__name__, tuple(getattr(t, "placements", ())),
                           tuple(t.shape), tuple(pool.local_pages()[k].shape))
                       for k, t in pool.pages.items()},
            "nbytes": pool.nbytes(), "rank_bytes": pool.rank_bytes(),
            "local": {k: t.clone() for k, t in pool.local_pages().items()}}


def guarded(eng):
    ok = {}
    for name, st in eng.step_graphs().items():
        with NoHostRead():
            logits, _ = st()
        ok[name] = bool(torch.isfinite(logits).all())
    return ok


def watch_tier(pool, seen):
    """Keeps a slot's local pages before its spill; counts the resumes whose
    pages differ from that copy."""
    kept = {}
    spill, resume = pool.spill_slot, pool.complete_resume

    def spill_rec(slot):
        idx = torch.as_tensor(pool._slot_pages[slot], dtype=torch.long)
        before = {k: t.index_select(1, idx) for k, t in pool.local_pages().items()}
        ok = spill(slot)
        if ok:
            kept[slot] = before
            seen["pages_spilled"] += len(idx)
        return ok

    def resume_rec(slot):
        ok = resume(slot)
        if ok:
            idx = torch.as_tensor(pool._slot_pages[slot], dtype=torch.long)
            before = kept.pop(slot)
            seen["resumes"] += 1
            seen["unequal"] += not all(torch.equal(t.index_select(1, idx), before[k])
                                       for k, t in pool.local_pages().items())
        return ok

    pool.spill_slot, pool.complete_resume = spill_rec, resume_rec


def body(rank, world, out):
    res = {}
    mesh = make_local_mesh(2, 2, device="cpu")
    res["model_coord"] = mesh.get_local_rank("model")
    cfg = get_config("deepseek-7b").reduced()
    params = build_model(cfg, device="cpu").init(0)
    for kv in ("bf16", "int8"):
        lm = build_model(cfg if kv == "bf16" else cfg.with_(kv_cache_dtype="int8"), device="cpu")
        eng = ServeEngine(lm, params, mesh=mesh, device="cpu", **ENGINE)
        eng.generate(_one_step_reqs())
        res[kv + " one step"] = dict(pools(eng), mixed_steps=eng.last_stats.mixed_steps)
        if kv == "bf16":
            tr = GroupTrace()
            with tr:
                eng.step_graphs()["mixed/16"].run_eager()
            tensor_group = mesh.get_group("model").group_name
            res["collectives"] = [(kind, outs, name == tensor_group)
                                  for kind, outs, name in tr.groups]
        res[kv + " streams"] = [r.tokens.tolist() for r in eng.generate(_reqs())]
        res[kv + " guard"] = guarded(eng)

    lm8 = build_model(cfg.with_(kv_cache_dtype="int8"), device="cpu")
    eng = ServeEngine(lm8, params, mesh=mesh, device="cpu", batch_size=4, max_len=64)
    res["int8 static streams"] = [r.tokens.tolist() for r in eng.generate(_reqs())]

    mesh14 = make_local_mesh(1, 4, device="cpu")
    lm = build_model(cfg, device="cpu")
    eng = ServeEngine(lm, params, mesh=mesh14, device="cpu", **ENGINE)
    res["1x4 streams"] = [r.tokens.tolist() for r in eng.generate(_reqs())]
    res["1x4 pools"] = pools(eng)["leaves"]

    eng = ServeEngine(lm, params, mesh=mesh, device="cpu", **TIERED)
    eng.generate(_tier_reqs(cfg.vocab)[:1])  # creates the pool
    seen = {"pages_spilled": 0, "resumes": 0, "unequal": 0}
    watch_tier(eng.last_pool, seen)
    spill_b = eng.obs.value("tier.spill_bytes")
    got = eng.generate(_tier_reqs(cfg.vocab))
    pool = eng.last_pool
    res["tiered"] = dict(
        seen, streams=[r.tokens.tolist() for r in got], statuses=[r.status for r in got],
        spills=eng.last_stats.spills, spill_bytes=eng.obs.value("tier.spill_bytes") - spill_b,
        row_bytes=sum(t[:, 0].numel() * t.element_size() for t in pool.local_pages().values()),
        placements={k: tuple(t.placements) for k, t in pool.pages.items()},
        guard=guarded(eng))
    return res
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _run_ranks(tmp_path_factory.mktemp("pools2x2"), _BODY + _COMMON, {}, timeout=300)


@pytest.fixture(scope="module")
def single():
    """The unsharded port: the pages after the one mixed step, and the
    streams, of the same engines."""
    cfg = get_config("deepseek-7b").reduced()
    params = build_model(cfg, device="cpu").init(0)
    out = {}
    for kv in ("bf16", "int8"):
        lm = build_model(cfg if kv == "bf16" else cfg.with_(kv_cache_dtype="int8"), device="cpu")
        eng = ServeEngine(lm, params, device="cpu", **ENGINE)
        eng.generate(_one_step_reqs())
        out[kv + " pages"] = {k: t.clone() for k, t in eng.last_pool.pages.items()}
        out[kv + " streams"] = [r.tokens.tolist() for r in eng.generate(_reqs())]
    eng = ServeEngine(lm, params, device="cpu", batch_size=4, max_len=64)
    out["int8 static streams"] = [r.tokens.tolist() for r in eng.generate(_reqs())]
    lm = build_model(cfg, device="cpu")
    eng = ServeEngine(lm, params, device="cpu", **TIERED)
    out["tiered streams"] = [r.tokens.tolist() for r in eng.generate(_tier_reqs(cfg.vocab))]
    out["tiered spills"] = eng.last_stats.spills
    return out


def _heads(coord: int, hkv: int = 2, t: int = 2) -> slice:
    return slice(coord * hkv // t, (coord + 1) * hkv // t)


def test_split_pools_hold_their_head_shard(ranks):
    """2x2: every pool leaf a DTensor at ``Shard`` on its head dim on
    "model", replicated on "data"; a rank holds half the whole pool's
    bytes."""
    from torch.distributed.tensor import Replicate, Shard

    for r in ranks:
        for kv in ("bf16", "int8"):
            rec = r[kv + " one step"]
            want = {"k_pages", "v_pages"} | (
                {"k_pages_scale", "v_pages_scale"} if kv == "int8" else set())
            assert set(rec["leaves"]) == want
            for name, (kind, pl, shape, local) in rec["leaves"].items():
                assert kind == "DTensor" and pl == (Replicate(), Shard(3)), (name, pl)
                assert local == shape[:3] + (shape[3] // 2,) + shape[4:], (name, local)
            assert rec["rank_bytes"] * 2 == rec["nbytes"]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_split_pages_equal_the_unsharded_head_slice(ranks, single, kv):
    """After one mixed step on the same inputs each rank's local pages are
    its head slice of the unsharded engine's pages: within 1e-5 (f32
    pages); int8 payloads within one code of the same step's scale and the
    scale planes within 1e-5 relative (the sharded sums round apart)."""
    want = single[kv + " pages"]
    for r in ranks:
        rec = r[kv + " one step"]
        assert rec["mixed_steps"] == 1
        h = _heads(r["model_coord"])
        got = rec["local"]
        if kv == "bf16":
            for name in ("k_pages", "v_pages"):
                torch.testing.assert_close(got[name], want[name][:, :, :, h], atol=1e-5, rtol=0)
            continue
        for name in ("k_pages", "v_pages"):
            s_got, s_want = got[name + "_scale"], want[name + "_scale"][:, :, :, h]
            torch.testing.assert_close(s_got, s_want, rtol=1e-5, atol=0)
            deq = lambda q, s: q.float() * s[..., None]  # noqa: E731
            diff = (deq(got[name], s_got) - deq(want[name][:, :, :, h], s_want)).abs()
            assert (diff <= s_want[..., None] * (1 + 1e-5)).all(), name


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_split_pools_serve_the_unsharded_streams(ranks, single, kv):
    """The same streams on every rank; the unsharded port's at the
    reference's tie tolerance (at least 3 of 4 equal), as
    ``test_sharded_serve_engine`` holds them."""
    first = ranks[0][kv + " streams"]
    for r in ranks:
        assert r[kv + " streams"] == first
    same = sum(x == y for x, y in zip(first, single[kv + " streams"]))
    assert same >= 3, (first, single[kv + " streams"])
    assert all(len(s) >= 1 for s in first)


def test_int8_static_engine_on_the_mesh(ranks, single):
    """The static engine's int8 caches on 2x2 (the K/V projections' partial
    sums over "data" reduced before they are quantized): the same streams
    on every rank, the unsharded int8 engine's at the tie tolerance."""
    first = ranks[0]["int8 static streams"]
    for r in ranks:
        assert r["int8 static streams"] == first
    assert sum(x == y for x, y in zip(first, single["int8 static streams"])) >= 3


def test_mixed_step_gathers_no_kv_rows_over_the_tensor_axis(ranks):
    """An eager mixed step under ``RankTrace``: no collective over the
    tensor axis's group returns K/V rows (a (., C, ., hd) tensor; B 4, C
    16, hd 16), where the parent's whole-pool write gathered K and V over
    it in each of the 2 layers. The collectives left on K/V rows are the
    data axis's: the FSDP projections' partial sums."""
    for r in ranks:
        kv_rows = [(kind, outs) for kind, outs, on_tp in r["collectives"]
                   if on_tp and any(len(s) == 4 and s[1] == 16 and s[3] == 16
                                    for s, _ in outs)]
        assert r["collectives"] and not kv_rows, kv_rows


def test_pools_stay_whole_where_the_heads_do_not_divide(ranks, single):
    """1x4: 2 KV heads on a 4-way tensor axis leave the pools plain tensors
    every rank holds whole, serving as before (the unsharded streams at the
    tie tolerance, the same on every rank)."""
    first = ranks[0]["1x4 streams"]
    for r in ranks:
        assert r["1x4 streams"] == first
        for name, (kind, pl, shape, local) in r["1x4 pools"].items():
            assert kind == "Tensor" and local == shape, (name, kind, local)
    assert sum(x == y for x, y in zip(first, single["bf16 streams"])) >= 3


def test_tiered_split_pool_resumes_its_shard(ranks, single):
    """A tiered pool on 2x2: spills happen, every resumed slot's local
    pages equal the copy kept before its spill, ``tier.spill_bytes`` is the
    pages spilled times this rank's page-row bytes (half a whole row), the
    streams equal on every rank and the unsharded tiered run's at the tie
    tolerance."""
    from torch.distributed.tensor import Replicate, Shard

    first = ranks[0]["tiered"]["streams"]
    for r in ranks:
        t = r["tiered"]
        assert t["statuses"] == ["ok"] * 4 and t["spills"] >= 1 and t["resumes"] >= 1, t
        assert t["unequal"] == 0
        assert t["spill_bytes"] == t["pages_spilled"] * t["row_bytes"] > 0
        assert t["row_bytes"] == 2 * 2 * 8 * 1 * 16 * 4  # K and V, L 2, page 8, 1 head, f32
        assert all(pl == (Replicate(), Shard(3)) for pl in t["placements"].values())
        assert t["streams"] == first
    assert single["tiered spills"] >= 1
    assert sum(x == y for x, y in zip(first, single["tiered streams"])) >= 3


def test_split_pool_steps_read_no_host_value(ranks):
    """The captured steps over split pools (bf16, int8, tiered) under the
    host-read guard of ``test_torch_step_graph.py``."""
    for r in ranks:
        for key in ("bf16 guard", "int8 guard"):
            assert set(r[key]) == {"mixed/1", "mixed/16"} and all(r[key].values()), key
        assert r["tiered"]["guard"] and all(r["tiered"]["guard"].values())


@pytest.mark.parametrize("arch", REFUSED)
def test_continuous_refuses_like_the_reference(arch):
    """A family the continuous engine does not serve: both packages raise
    ``ValueError`` naming the continuous scheduler (the reference's
    ``tests/test_serve.py::test_continuous_rejects_unsupported_family``)."""
    with pytest.raises(ValueError, match="continuous") as want:
        RefServeEngine(ref_build_model(ref_get_config(arch).reduced()), None, batch_size=2,
                       max_len=64, scheduler="continuous")
    with pytest.raises(ValueError, match="continuous") as got:
        ServeEngine(build_model(get_config(arch).reduced(), device="cpu"), None, batch_size=2,
                    max_len=64, scheduler="continuous", device="cpu")
    assert str(got.value) == str(want.value)

