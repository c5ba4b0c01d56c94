"""The paged decode step's attention prologue (``ops.rope_kv_write``): RoPE
on q and k and the K/V page write, fused over what ``decode_view`` computes
once a step.

On the CPU:

* ``decode_view``'s hoisted ``positions``, ``cos``, ``sin``, ``phys``,
  ``offset`` and ``next_len`` equal what the layers computed in each call
  before (the half-split ``rope`` and ``_paged_write``, written out below
  as they were), at the narrow and a chunk width, over ragged ``q_len``
  with zeros, lengths at the pool's capacity and shuffled block tables;
* the plain version of ``ops.rope_kv_write`` leaves q and every page but
  the dummy page 0 equal to those composed ops;
* a layer's paged decode takes the fused prologue on pools of plain
  tensors in the activations' dtype, the composed ops on int8 pools, and
  both give the same output and pages.

On the card (``@pytest.mark.gpu``; no JAX is imported here):

  python -m pytest -q --noconftest -m gpu tests/test_torch_rope_kv_write.py

the kernel equals the plain version to the bit (q, and every page but page
0, at 32 and 16 heads, every registered head dim, 64 x 1, 256 x 1 and 8 x
256 positions) and changes no page slot it was not given; a replay of a
captured launch equals an eager launch; each call counts one launch; and
deepseek-7b's reduced config served in bf16 through the continuous engine
(chunked prefill, decode, a preemption's re-prefill) gives the same greedy
streams with the kernel and with the plain version, at one launch a layer
a replay.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro_torch.configs import get_config
from repro_torch.configs.registry import all_configs
from repro_torch.kernels import cuda_lib, ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# Head dims the card tests run the kernel at: every registered attention
# config's (the dense and MoE ones' 128, and the other families' 64, 80, 96).
HEAD_DIMS = (64, 80, 96, 128)
PAGE, N_BLOCKS = 4, 4    # CPU pools: capacity 16 positions a row


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rope_as_composed(x, positions, theta):
    """``models.layers.rope`` as every layer ran it before the step's angles
    were hoisted into ``decode_view``."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:2 * half].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def _slots_as_composed(bt, page, starts, q_lens, c):
    """The positions and pool slots ``_paged_write`` computed in every
    layer before they were hoisted."""
    capacity = bt.shape[1] * page
    tq = torch.arange(c, dtype=torch.int32, device=bt.device)[None, :]
    pos = starts[:, None] + tq
    valid = tq < q_lens[:, None]
    wpos = torch.clamp(pos, max=capacity - 1)
    page_log = torch.div(wpos, page, rounding_mode="floor")
    offset = (wpos % page).long()
    phys = torch.gather(bt, 1, page_log.long())
    phys = torch.where(valid, phys, torch.zeros_like(phys)).long()
    return pos, phys, offset


# (chunk width, lengths before the step, q_len): capacity is 16 a row.
CASES = {
    "narrow": (1, [5, 0, 11, 3], [1, 1, 0, 1]),
    "narrow_at_capacity": (1, [15, 16, 0, 7], [1, 1, 1, 0]),
    "chunk": (6, [0, 4, 9, 2], [6, 2, 0, 5]),
    "chunk_at_capacity": (4, [14, 16, 12, 13], [4, 1, 4, 0]),
}


def _cfg(dtype="float32"):
    return get_config("deepseek-7b").reduced().with_(dtype=dtype, param_dtype=dtype)


def _step(case, shuffled, dtype="float32", seed=0):
    """A reduced config and one layer's paged caches for ``case``: pools of
    ``1 + B * N_BLOCKS`` random pages (page 0 the dummy), the block table
    the identity past page 0 or a shuffle of it."""
    cfg = _cfg(dtype)
    c, lens, q_lens = CASES[case]
    b = len(lens)
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randperm(b * N_BLOCKS, generator=gen) if shuffled else torch.arange(b * N_BLOCKS)
    shape = (1 + b * N_BLOCKS, PAGE, cfg.n_kv_heads, cfg.hd)
    caches = {
        "k_pages": torch.randn(shape, generator=gen).to(cfg.activation_dtype()),
        "v_pages": torch.randn(shape, generator=gen).to(cfg.activation_dtype()),
        "block_table": (1 + ids).to(torch.int32).reshape(b, N_BLOCKS),
        "len": torch.tensor(lens, dtype=torch.int32),
        "q_len": torch.tensor(q_lens, dtype=torch.int32),
    }
    return cfg, caches, b, c


def _qkv(cfg, b, c, seed=1):
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.activation_dtype()
    return (torch.randn((b, c, cfg.n_heads, cfg.hd), generator=gen).to(dt),
            torch.randn((b, c, cfg.n_kv_heads, cfg.hd), generator=gen).to(dt),
            torch.randn((b, c, cfg.n_kv_heads, cfg.hd), generator=gen).to(dt))


# ---- CPU ---------------------------------------------------------------------------


@pytest.mark.parametrize("shuffled", [False, True], ids=["identity", "shuffled"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_view_hoists_what_each_layer_computed(case, shuffled):
    cfg, caches, b, c = _step(case, shuffled)
    view = T.decode_view(cfg, caches, b, c)
    pos, phys, offset = _slots_as_composed(caches["block_table"], PAGE, caches["len"],
                                           caches["q_len"], c)
    assert view["positions"].dtype == torch.int32 and torch.equal(view["positions"], pos)
    assert view["phys"].dtype == torch.int64 and torch.equal(view["phys"], phys)
    assert view["offset"].dtype == torch.int64 and torch.equal(view["offset"], offset)
    assert torch.equal(view["next_len"], caches["len"] + caches["q_len"])
    half = cfg.hd // 2
    freqs = cfg.rope_theta ** (-torch.arange(0, half, dtype=torch.float32) / half)
    angles = pos[..., None].float() * freqs
    assert view["cos"].shape == (b, c, half) and view["cos"].dtype == torch.float32
    assert torch.equal(view["cos"], torch.cos(angles)) and torch.equal(view["sin"],
                                                                        torch.sin(angles))
    q, k, _ = _qkv(cfg, b, c)
    for x in (q, k):
        want = _rope_as_composed(x, pos, cfg.rope_theta)
        assert torch.equal(L.rope_rotate(x, view["cos"], view["sin"]), want)
        assert torch.equal(L.rope(x, pos, theta=cfg.rope_theta), want)
    # the slots the step writes: past the capacity clamped onto the last,
    # an invalid row on page 0
    tq = torch.arange(c)[None, :]
    assert bool((view["phys"][tq >= caches["q_len"][:, None]] == 0).all())
    assert int(view["phys"].max()) <= b * N_BLOCKS and int(view["offset"].max()) < PAGE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shuffled", [False, True], ids=["identity", "shuffled"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_rope_kv_write_equals_the_composed_ops(case, shuffled, dtype):
    cfg, caches, b, c = _step(case, shuffled, dtype)
    view = T.decode_view(cfg, caches, b, c)
    q, k, v = _qkv(cfg, b, c)
    want = dict(caches, k_pages=caches["k_pages"].clone(), v_pages=caches["v_pages"].clone())
    want_q = _rope_as_composed(q, view["positions"], cfg.rope_theta)
    T._paged_write(cfg, want, _rope_as_composed(k, view["positions"], cfg.rope_theta), v,
                   caches["len"], caches["q_len"])
    before = dict(cuda_lib.launch_counts)
    got_q = q.clone()
    out = ops.rope_kv_write(got_q, k, v, caches["k_pages"], caches["v_pages"], view["cos"],
                            view["sin"], view["phys"], view["offset"], caches["q_len"])
    assert cuda_lib.launch_counts == before   # no kernel launch on the CPU
    assert out is got_q and torch.equal(got_q, want_q)   # rotated in place
    for name in ("k_pages", "v_pages"):   # page 0: invalid rows, any order
        assert torch.equal(caches[name][1:], want[name][1:]), name


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_paged_decode_fuses_the_prologue_on_plain_pools_only(kv, monkeypatch):
    """One layer's paged decode (float32 activations): the fused prologue
    on pools in the activations' dtype (``kv_cache_dtype`` "bfloat16" keeps
    them so), the composed ops on int8 pools; the output, the new lengths
    and every page but page 0 as the composed ops leave them either way."""
    cfg = _cfg().with_(kv_cache_dtype=kv, kv_layout="paged")
    gen = torch.Generator().manual_seed(3)
    p = T.attn_init(gen, cfg)
    b, c = 3, 4
    shape = (1 + b * N_BLOCKS, PAGE, cfg.n_kv_heads, cfg.hd)
    caches = dict(T.kv_buffers(cfg, ("k_pages", "v_pages"), shape),
                  block_table=(1 + torch.arange(b * N_BLOCKS).flip(0)).to(torch.int32)
                  .reshape(b, N_BLOCKS),
                  len=torch.tensor([3, 0, 9], dtype=torch.int32),
                  q_len=torch.tensor([4, 2, 0], dtype=torch.int32))
    x = torch.randn((b, c, cfg.d_model), generator=gen)
    fused_prologue, rope_kv_write = T._fused_prologue, ops.rope_kv_write
    assert fused_prologue(cfg, caches, *_qkv(cfg, b, c)) == (kv == "bfloat16")
    calls = []
    monkeypatch.setattr(ops, "rope_kv_write",
                        lambda *a, **kw: calls.append(kw) or rope_kv_write(*a, **kw))

    def run(fuse: bool):
        monkeypatch.setattr(T, "_fused_prologue", lambda *a: fuse and fused_prologue(*a))
        step = {n: (t.clone() if torch.is_tensor(t) else t) for n, t in caches.items()}
        out, after = T.attn_decode(p, cfg, x, step)
        return out, step, after

    got, got_pages, after = run(True)
    assert calls == ([{"impl": cfg.attn_impl}] if kv == "bfloat16" else [])
    want, want_pages, _ = run(False)
    assert len(calls) == (1 if kv == "bfloat16" else 0)
    assert torch.equal(got, want)
    assert torch.equal(after["len"], caches["len"] + caches["q_len"])
    for name, t in got_pages.items():
        if name.startswith(("k_pages", "v_pages")):
            assert torch.equal(t[1:], want_pages[name][1:]), name


def test_kernel_head_dims_cover_the_registry():
    """The card tests run the kernel at every head dim a registered config
    with attention has (the kernel takes those that 16 divides)."""
    dims = {cfg.hd for cfg in all_configs().values() if cfg.family != "ssm"}
    assert dims == set(HEAD_DIMS) and all(d % 16 == 0 for d in HEAD_DIMS)
    assert _cfg().hd % 16 == 0


# ---- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU version")
    return torch.device("cuda")


def _card_case(dev, b, c, h, d, *, seed=0, page=64, max_len=1024):
    """Inputs of one layer's prologue at B rows of C positions, h heads
    (MHA) of d: a ragged q_len with zeros (a full chunk where C > 1),
    lengths up to ``max_len - C``, a shuffled block table over random
    pages, and the step's view from ``decode_view``."""
    rng = np.random.default_rng(seed)
    nb = max_len // page
    gen = torch.Generator(device=dev).manual_seed(seed)
    if c == 1:
        q_lens = rng.integers(0, 2, size=b)
        q_lens[0] = 0
    else:
        q_lens = rng.integers(0, c + 1, size=b)
        q_lens[0], q_lens[-1] = 0, c
    lens = rng.integers(0, max_len - c + 1, size=b)
    ids = torch.from_numpy(rng.permutation(b * nb)).to(dev)
    shape = (1 + b * nb, page, h, d)
    cfg = get_config("deepseek-7b").with_(n_heads=h, n_kv_heads=h, head_dim=d)
    caches = {
        "k_pages": torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16),
        "v_pages": torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16),
        "block_table": (1 + ids).to(torch.int32).reshape(b, nb),
        "len": torch.as_tensor(lens, dtype=torch.int32, device=dev),
        "q_len": torch.as_tensor(q_lens, dtype=torch.int32, device=dev),
    }
    view = T.decode_view(cfg, caches, b, c)
    qkv = [torch.randn((b, c, h, d), generator=gen, device=dev).mul_(4).to(torch.bfloat16)
           for _ in range(3)]
    return view, qkv


def _args(view, qkv, pools):
    q, k, v = qkv
    return (q, k, v, *pools, view["cos"], view["sin"], view["phys"], view["offset"],
            view["q_len"])


@pytest.mark.gpu
@pytest.mark.parametrize("bc", [(64, 1), (256, 1), (8, 256)], ids=["64x1", "256x1", "8x256"])
@pytest.mark.parametrize("h", [32, 16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_kernel_equals_the_plain_version_to_the_bit(cuda, bc, h, d):
    b, c = bc
    view, (q, k, v) = _card_case(cuda, b, c, h, d, seed=b + c + h + d)
    pools0 = (view["k_pages"].clone(), view["v_pages"].clone())
    plain_q, plain_pools = q.clone(), tuple(p.clone() for p in pools0)
    ops.rope_kv_write(*_args(view, (plain_q, k, v), plain_pools), impl="torch")
    got_q, got_pools = q.clone(), tuple(p.clone() for p in pools0)
    before = cuda_lib.launch_counts["rope_kv_write"]
    out = ops.rope_kv_write(*_args(view, (got_q, k, v), got_pools))
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["rope_kv_write"] == before + 1
    assert out is got_q and torch.equal(got_q, plain_q)
    assert not torch.equal(got_q, q)   # it did rotate
    written = torch.zeros(pools0[0].shape[:2], dtype=torch.bool, device=cuda)
    tq = torch.arange(c, device=cuda)[None, :]
    valid = tq < view["q_len"][:, None]
    written[view["phys"][valid], view["offset"][valid]] = True
    for got, plain, was in zip(got_pools, plain_pools, pools0):
        assert torch.equal(got[1:], plain[1:])            # page 0: the plain version's dummy
        assert torch.equal(got[~written], was[~written])  # no other slot moved
        assert int(valid.sum()) == 0 or not torch.equal(got[written], was[written])


@pytest.mark.gpu
@pytest.mark.parametrize("bc", [(64, 1), (8, 256)], ids=["64x1", "8x256"])
def test_kernel_replay_equals_an_eager_launch(cuda, bc):
    b, c = bc
    view, (q, k, v) = _card_case(cuda, b, c, 32, 128, seed=5)
    pools0 = (view["k_pages"].clone(), view["v_pages"].clone())
    eager_q, eager_pools = q.clone(), tuple(p.clone() for p in pools0)
    ops.rope_kv_write(*_args(view, (eager_q, k, v), eager_pools))   # loads the library too
    g_q, g_pools = q.clone(), tuple(p.clone() for p in pools0)
    graph = torch.cuda.CUDAGraph()
    with cuda_lib.recording() as issued:
        with torch.cuda.graph(graph):
            ops.rope_kv_write(*_args(view, (g_q, k, v), g_pools))
    assert issued.get("rope_kv_write") == 1
    g_q.copy_(q)
    for p, p0 in zip(g_pools, pools0):
        p.copy_(p0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_q, eager_q)
    assert all(torch.equal(a, e) for a, e in zip(g_pools, eager_pools))


# Small bf16 model whose attention B1 takes (head dim 64), served on an
# oversubscribed pool: 24-token prompts in 16-token chunks, 24 new tokens,
# 4 allocatable pages for 2 slots, so a preemption re-prefills a stream.
CARD_KW = dict(dtype="bfloat16", param_dtype="bfloat16", d_model=256, n_heads=4, n_kv_heads=2,
               head_dim=64, d_ff=512, vocab=1024)
ENGINE = dict(batch_size=2, max_len=64, scheduler="continuous", page_size=16, prefill_chunk=16,
              pool_pages=4, admission="optimistic", max_preemptions=10)


def _serve(lm, params, specs, dev):
    """Two ``generate()`` calls on one engine (the second replays only):
    the results of both, the launches and mixed-step replays of the second,
    and its stats."""
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(lm, params, device=dev, **ENGINE)
    first = eng.generate([Request(**s) for s in specs])
    before = {name: g.replays for name, g in eng.step_graphs().items()}
    cuda_lib.reset_launch_counts()
    again = eng.generate([Request(**s) for s in specs])
    replays = sum(g.replays - before[name] for name, g in eng.step_graphs().items())
    return first, again, dict(cuda_lib.launch_counts), replays, eng.last_stats


@pytest.mark.gpu
def test_served_streams_equal_the_plain_prologue(cuda, monkeypatch):
    from repro_torch.models import build_model

    cfg = get_config("deepseek-7b").reduced().with_(**CARD_KW)
    lm = build_model(cfg, device=cuda)
    params = lm.init(0)
    rng = np.random.default_rng(11)
    specs = [dict(tokens=rng.integers(2, cfg.vocab, size=24).astype(np.int32),
                  max_new_tokens=24, rid=i) for i in range(3)]
    first, again, launches, replays, stats = _serve(lm, params, specs, cuda)
    assert all(r.status == "ok" for r in first + again)
    assert stats.preemptions >= 1 and stats.wide_steps > 0
    assert replays > 0 and launches["rope_kv_write"] == cfg.n_layers * replays
    assert launches["rope_kv_write"] == launches["paged_decode"]
    fused = ops.rope_kv_write
    monkeypatch.setattr(ops, "rope_kv_write", lambda *a, impl: fused(*a, impl="torch"))
    p_first, p_again, p_launches, _, p_stats = _serve(lm, params, specs, cuda)
    assert p_launches["rope_kv_write"] == 0 and p_stats.preemptions == stats.preemptions
    for got, want in ((first, p_first), (again, p_again)):
        assert [r.tokens.tolist() for r in got] == [r.tokens.tolist() for r in want]
