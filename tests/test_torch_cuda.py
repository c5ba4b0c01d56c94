"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one. The machine with the
card has no JAX, so this file imports only torch and the port; run it there
without the repository's conftest (which imports JAX):

  python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py
"""

import pytest

pytest.importorskip("torch")

import torch

from repro_torch.core.attention import (
    attention_delta,
    decode_attention,
    flash_attention,
    flash_attention_bwd as plain_bwd,
    paged_decode_attention,
)
from repro_torch.core.schedule import Order, resolve_order_group
from repro_torch.kernels import cuda_lib, ops
from repro_torch.kernels.flash_attention import (
    BLOCK_M,
    BLOCK_N,
    FWD_BLOCK_M,
    FWD_BLOCK_N,
    MASK_VALUE,
    flash_attention_bwd,
    flash_attention_fwd,
    fwd_walks,
    fwd_workers,
    dkv_walks,
    kernel_traversal,
    launch_flash_bwd_delta,
)
from repro_torch.kernels.flash_decode import (
    contig_decode_splits,
    contig_decode_walks,
    decode_chunk,
    decode_kernel_attr,
    flash_decode_fwd,
    fold_schedule,
    launch_contig_decode,
    launch_paged_decode,
    paged_decode_splits,
    paged_decode_walks,
    paged_flash_decode_fwd,
)
from repro_torch.kernels.ssd import ssd_fwd, ssd_grid, ssd_kernel_attr, ssd_walks
from repro_torch.models.ssm import ssd_chunked


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _paged_case(gen, dev, *, page, g, c, hkv=2, d=128, b=4):
    """A pool with a spare page, a shuffled block table, rows of length
    max, about half, 0 and 5 (q_lens c, about half, 0 and 0)."""
    nb = max(6, -(-(c + 40) // page))
    n_pages = b * nb + 1
    bf = torch.bfloat16
    k = torch.randn((n_pages, page, hkv, d), generator=gen, device=dev).to(bf)
    v = torch.randn((n_pages, page, hkv, d), generator=gen, device=dev).to(bf)
    q = torch.randn((b, c, hkv * g, d), generator=gen, device=dev).to(bf)
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev)[: b * nb] + 1)
    bt = bt.reshape(b, nb).to(torch.int32)
    lens = torch.tensor([nb * page, nb * page // 2 + 3, 0, 5], dtype=torch.int32, device=dev)
    qls = torch.tensor([c, (c + 1) // 2, 0, 0], dtype=torch.int32, device=dev)
    return q, k, v, bt, lens, qls


@pytest.mark.gpu
@pytest.mark.parametrize("page", [8, 64])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("c", [1, 7, 15, 40, 64, 65, 256])
def test_cuda_kernel_matches_plain(cuda, page, g, c):
    """bf16 kernel vs the plain version in f32 on the same bf16 inputs:
    2e-2 abs (bf16 output rounding); zero rows exact. Chunks of 15 rows and
    more run on the tensor cores, 64 and 65 cross a row tile's edge; the
    walk each CTA records equals the host model at the kernel's own split
    count, which paged_decode_attr reports."""
    gen = torch.Generator(device=cuda).manual_seed(page * 1000 + g * 10 + c)
    q, k, v, bt, lens, qls = _paged_case(gen, cuda, page=page, g=g, c=c)
    b, nb, hkv = q.shape[0], bt.shape[1], k.shape[2]
    splits = paged_decode_splits(b, hkv, nb, _sms(cuda), c * g)
    attr = decode_kernel_attr("paged_decode", (b, c, q.shape[2], hkv, q.shape[3], nb, page),
                              cuda)
    assert attr["cluster_size"] == splits
    for order in Order:
        group = resolve_order_group(order, 2, nb)
        for window in (None, page + 3):
            n0 = cuda_lib.launch_counts["paged_decode"]
            out = paged_flash_decode_fwd(q, k, v, lens, bt, q_lens=qls, window=window,
                                         order_group=group)
            torch.cuda.synchronize()
            assert cuda_lib.launch_counts["paged_decode"] == n0 + 1
            ref = paged_decode_attention(q.float(), k.float(), v.float(), lens, bt,
                                         q_lens=qls, window=window, order_group=group)
            t = torch.arange(c, device=cuda)[None, :]
            zero = (t >= qls[:, None]) | (lens[:, None] == 0)
            o = out.float()
            assert torch.all(o[zero] == 0.0)
            assert (o - ref)[~zero].abs().max().item() <= 2e-2
            phys, logical = fold_schedule(lens, bt, order_group=group)
            want = paged_decode_walks(logical, lens, qls, c=c, g=g, hkv=hkv, page=page,
                                      window=window, splits=splits)
            visit = torch.full(tuple(want.shape), -7, dtype=torch.int32, device=cuda)
            again = launch_paged_decode(q, k, v, phys, logical, lens, qls, window=window,
                                        visit_out=visit)
            torch.cuda.synchronize()
            assert torch.equal(visit.cpu(), want)
            assert torch.equal(again, out)


def _stale(pool, bt, lens, fill):
    """``pool`` with every position at or past its row's length (the tail of
    a row's last page, its unused pages, the spare page) set to ``fill``."""
    n_pages, page = pool.shape[:2]
    live = torch.zeros((n_pages, page), dtype=torch.bool, device=pool.device)
    pos = torch.arange(bt.shape[1] * page, device=pool.device).reshape(bt.shape[1], page)
    for b in range(bt.shape[0]):
        live[bt[b].long()] = pos < lens[b]
    out = pool.clone()
    out[~live] = fill
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("c,g,page,d", [(1, 1, 64, 128), (1, 8, 64, 128), (7, 1, 8, 64),
                                        (15, 1, 64, 128), (65, 1, 64, 64), (256, 1, 64, 128)])
def test_paged_decode_split_walks_bits_and_stale_tails(cuda, splits, c, g, page, d):
    """At every cluster size: within 2e-2 of the plain version, the recorded
    walk equal to the host model, two launches equal to the bit, and a
    pool whose positions past each row's length hold NaN giving the same
    bits as one holding zeros there (the copies zero them; masking P alone
    would not keep 0 x NaN out of P V)."""
    gen = torch.Generator(device=cuda).manual_seed(splits * 100 + c + g + d)
    q, k, v, bt, lens, qls = _paged_case(gen, cuda, page=page, g=g, c=c, d=d)
    hkv, nb = k.shape[2], bt.shape[1]
    group = resolve_order_group("sawtooth", None, nb)
    phys, logical = fold_schedule(lens, bt, order_group=group)
    want = paged_decode_walks(logical, lens, qls, c=c, g=g, hkv=hkv, page=page, window=None,
                              splits=splits)
    visit = torch.full(tuple(want.shape), -7, dtype=torch.int32, device=cuda)
    kz, vz = _stale(k, bt, lens, 0.0), _stale(v, bt, lens, 0.0)
    kn, vn = _stale(k, bt, lens, float("nan")), _stale(v, bt, lens, float("nan"))
    out = launch_paged_decode(q, kz, vz, phys, logical, lens, qls, visit_out=visit,
                              splits=splits)
    again = launch_paged_decode(q, kz, vz, phys, logical, lens, qls, splits=splits)
    nan = launch_paged_decode(q, kn, vn, phys, logical, lens, qls, splits=splits)
    torch.cuda.synchronize()
    assert torch.equal(visit.cpu(), want)
    assert torch.equal(again, out) and torch.equal(nan, out)
    ref = paged_decode_attention(q.float(), kz.float(), vz.float(), lens, bt, q_lens=qls,
                                 order_group=group)
    zero = (torch.arange(c, device=cuda)[None, :] >= qls[:, None]) | (lens[:, None] == 0)
    assert torch.all(out.float()[zero] == 0)
    assert (out.float() - ref)[~zero].abs().max().item() <= 2e-2


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 1, 2, 128), dtype=torch.float32, device=cuda)
    k = torch.zeros((3, 8, 2, 128), dtype=torch.float32, device=cuda)
    bt = torch.ones((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        paged_flash_decode_fwd(q, k, k, 4, bt)
    qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        paged_flash_decode_fwd(qb[..., :112].contiguous(), kb[..., :112].contiguous(),
                               kb[..., :112].contiguous(), 4, bt)
    with pytest.raises(ValueError, match="multiple"):
        paged_flash_decode_fwd(torch.zeros((1, 1, 3, 128), dtype=torch.bfloat16, device=cuda),
                               kb, kb, 4, bt)
    lens = torch.tensor([4], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="splits"):
        launch_paged_decode(qb, kb, kb, bt, bt, lens, lens, splits=3)
    with pytest.raises(ValueError, match="visit_out"):
        launch_paged_decode(qb, kb, kb, bt, bt, lens, lens, splits=2,
                            visit_out=torch.zeros((2, 1, 1, 2), dtype=torch.int32, device=cuda))


def _visible(sq, skv, causal, window, dev):
    """(Sq,) rows with at least one visible key."""
    r = torch.arange(sq, device=dev)[:, None]
    c = torch.arange(skv, device=dev)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        ok &= c <= r
    if window is not None:
        ok &= c > r - window
    return ok.any(-1)


def _check_flash_fwd(dev, d, g, causal, window, sq, skv, seed):
    """B2 against the plain version in f32 on the same bf16 inputs, in every
    order: o within 2e-2 abs (bf16 output and P rounding), lse within 2e-3
    abs, on rows that see a key; rows that see none are exact zeros with
    lse = MASK_VALUE; one launch a call; the recorded walk equals the host
    model of the persistent schedule; a second launch gives equal bits."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, hkv = 2, 2
    q = _bf16(gen, (b, sq, hkv * g, d), dev)
    k = _bf16(gen, (b, skv, hkv, d), dev)
    v = _bf16(gen, (b, skv, hkv, d), dev)
    vis = _visible(sq, skv, causal, window, dev)
    for order in Order:
        tr = kernel_traversal(sq, skv, g, kernel="flash_fwd", order=order, causal=causal,
                              window=window, snake_group=2)
        visit = torch.empty((b * hkv, tr.grid_rows, tr.n_kv), dtype=torch.int32, device=dev)
        kw = dict(order=order, causal=causal, window=window, snake_group=2, return_lse=True)
        n0 = cuda_lib.launch_counts["flash_fwd"]
        o, lse = flash_attention_fwd(q, k, v, visit_out=visit, **kw)
        torch.cuda.synchronize()
        assert cuda_lib.launch_counts["flash_fwd"] == n0 + 1
        o2, lse2 = flash_attention_fwd(q, k, v, **kw)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        ro, rl = flash_attention(q.float(), k.float(), v.float(), order=order, causal=causal,
                                 window=window, q_block=FWD_BLOCK_M, kv_block=FWD_BLOCK_N,
                                 snake_group=2, return_lse=True)
        if vis.any():
            assert (o.float() - ro)[:, vis].abs().max().item() <= 2e-2
            assert (lse - rl)[:, vis].abs().max().item() <= 2e-3
        assert torch.all(o[:, ~vis] == 0)
        assert torch.all((lse[:, ~vis] / MASK_VALUE - 1).abs() < 1e-6)
        want = torch.tensor(fwd_walks(tr, b * hkv, fwd_workers(dev)), dtype=torch.int32)
        assert torch.equal(visit.cpu(), want), order


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal,window,sq,skv", [
    (True, None, 77, 77), (True, 50, 200, 200), (False, None, 130, 70), (False, 40, 200, 90),
])
def test_flash_fwd_kernel_matches_plain_and_walks_the_traversal(cuda, d, g, causal, window,
                                                               sq, skv):
    """B2 against its plain version and the host model of its walk
    (:func:`_check_flash_fwd`)."""
    _check_flash_fwd(cuda, d, g, causal, window, sq, skv, seed=sq * 7 + g + d)


# The forward matrix of chip_smoke.py: 17 shapes x D 64/80/96/128 x G 1/4,
# each in three orders (408 cases).
_FWD_MATRIX = [(s, s, causal, window) for s in (1, 77, 300, 700) for causal in (True, False)
               for window in (None, 100)] + [(300, 131, False, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("sq,skv,causal,window", _FWD_MATRIX)
def test_flash_fwd_kernel_matrix(cuda, d, g, sq, skv, causal, window):
    """B2 over the forward matrix (:func:`_check_flash_fwd`)."""
    _check_flash_fwd(cuda, d, g, causal, window, sq, skv, seed=sq * 11 + skv + g + d)


def _contig_walk_check(q, k, v, lens, *, order, window, chunk, snake_group, splits=None,
                       out=None):
    """The walk B3 records at ``splits`` (None: its own choice, which
    contig_decode_attr reports) equals the host model, and the launch gives
    ``out``'s bits."""
    b, _, hq, d = q.shape
    s_max, hkv = k.shape[1], k.shape[2]
    n = splits or contig_decode_splits(b, hkv, hq // hkv, s_max, _sms(q.device))
    if splits is None:
        attr = decode_kernel_attr("contig_decode",
                                  (b, s_max, hq, hkv, d, decode_chunk(chunk, s_max)), q.device)
        assert attr["cluster_size"] == n
    want = contig_decode_walks(lens, s_max=s_max, hkv=hkv, g=hq // hkv, chunk=chunk,
                               order=order, snake_group=snake_group, window=window, splits=n)
    visit = torch.full(tuple(want.shape), -7, dtype=torch.int32, device=q.device)
    got = launch_contig_decode(q, k, v, lens, order=order, window=window, chunk=chunk,
                               snake_group=snake_group, visit_out=visit, splits=splits)
    torch.cuda.synchronize()
    assert torch.equal(visit.cpu(), want)
    if out is not None:
        assert torch.equal(got, out)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("chunk", [128, 512])
def test_contig_decode_kernel_matches_plain(cuda, g, window, chunk):
    """bf16 kernel vs the plain version in f32: 2e-2 abs on rows of
    positive length; a row of length 0 is exact zeros. S_max 300 is not a
    multiple of the chunk. The recorded walk equals the host model."""
    gen = torch.Generator(device=cuda).manual_seed(g * 10 + (window or 0) + chunk)
    b, hkv, d, s_max = 4, 2, 128, 300
    q = _bf16(gen, (b, 1, hkv * g, d), cuda)
    k = _bf16(gen, (b, s_max, hkv, d), cuda)
    v = _bf16(gen, (b, s_max, hkv, d), cuda)
    lens = torch.tensor([300, 0, 129, 7], dtype=torch.int32, device=cuda)
    for order in Order:
        n0 = cuda_lib.launch_counts["contig_decode"]
        out = flash_decode_fwd(q, k, v, lens, order=order, window=window, chunk=chunk,
                               snake_group=2)
        torch.cuda.synchronize()
        assert cuda_lib.launch_counts["contig_decode"] == n0 + 1
        ref = decode_attention(q.float(), k.float(), v.float(), lens, window=window)
        ok = lens > 0
        assert (out.float() - ref)[ok].abs().max().item() <= 2e-2
        assert torch.all(out[~ok] == 0)
        _contig_walk_check(q, k, v, lens, order=order, window=window, chunk=chunk,
                           snake_group=2, out=out)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("d,g", [(128, 1), (80, 1), (96, 1), (64, 4), (128, 8)])
def test_contig_decode_split_walks_bits_and_stale_tails(cuda, splits, d, g):
    """At every cluster size: within 2e-2 of the plain version, the recorded
    walk equal to the host model, two launches equal to the bit, and caches
    holding NaN at and past each row's length giving the same bits as caches
    holding zeros there."""
    gen = torch.Generator(device=cuda).manual_seed(splits * 100 + d + g)
    b, hkv, s_max = 5, 2, 1024
    q = _bf16(gen, (b, 1, hkv * g, d), cuda)
    k, v = _bf16(gen, (b, s_max, hkv, d), cuda), _bf16(gen, (b, s_max, hkv, d), cuda)
    lens = torch.tensor([1024, 0, 715, 7, 300], dtype=torch.int32, device=cuda)
    tail = torch.arange(s_max, device=cuda)[None, :] >= lens[:, None]
    kz, vz, kn, vn = k.clone(), v.clone(), k.clone(), v.clone()
    kz[tail], vz[tail], kn[tail], vn[tail] = 0.0, 0.0, float("nan"), float("nan")
    ok = lens > 0
    for window in (None, 100):
        out = launch_contig_decode(q, kz, vz, lens, order="sawtooth", window=window,
                                   splits=splits)
        _contig_walk_check(q, kz, vz, lens, order="sawtooth", window=window, chunk=512,
                           snake_group=None, splits=splits, out=out)
        nan = launch_contig_decode(q, kn, vn, lens, order="sawtooth", window=window,
                                   splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(nan, out)
        ref = decode_attention(q.float(), kz.float(), vz.float(), lens, window=window)
        assert (out.float() - ref)[ok].abs().max().item() <= 2e-2
        assert torch.all(out[~ok] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [None, 1, 2, 8])
@pytest.mark.parametrize("d,g", [(128, 1), (80, 1), (64, 4), (128, 8)])
def test_contig_decode_lse_and_the_sequence_split(cuda, splits, d, g):
    """B3 with its lse output (the kLse instantiation): the output equal to
    the bit to the launch without it; the lse within 2e-3 of the plain
    version's (``MASK_VALUE`` for a row of length 0); the cache cut in
    halves and quarters, each run with its local lengths and merged by
    ``merge_decode_partials``, within 2e-2 (o) and 2e-3 (lse) of the whole;
    a wrong lse buffer refused."""
    from repro_torch.core.attention import merge_decode_partials

    gen = torch.Generator(device=cuda).manual_seed(7 * d + g + (splits or 0))
    b, hkv, s_max = 5, 2, 1024
    q = _bf16(gen, (b, 1, hkv * g, d), cuda)
    k, v = _bf16(gen, (b, s_max, hkv, d), cuda), _bf16(gen, (b, s_max, hkv, d), cuda)
    lens = torch.tensor([1024, 0, 715, 7, 300], dtype=torch.int32, device=cuda)
    ok = lens > 0
    lse = torch.empty((b, hkv * g), dtype=torch.float32, device=cuda)
    n0 = cuda_lib.launch_counts["contig_decode"]
    out = launch_contig_decode(q, k, v, lens, splits=splits, lse=lse)
    plain_out = launch_contig_decode(q, k, v, lens, splits=splits)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["contig_decode"] == n0 + 2
    assert torch.equal(out, plain_out)
    ref, ref_lse = decode_attention(q.float(), k.float(), v.float(), lens, return_lse=True)
    assert (lse - ref_lse)[ok].abs().max().item() <= 2e-3
    assert torch.all(lse[~ok] == MASK_VALUE) and torch.all(out[~ok] == 0)
    for n in (2, 4):
        w = s_max // n
        parts = [flash_decode_fwd(q, k[:, i * w:(i + 1) * w].contiguous(),
                                  v[:, i * w:(i + 1) * w].contiguous(),
                                  torch.clamp(lens - i * w, 0, w), return_lse=True)
                 for i in range(n)]
        mo, ml = merge_decode_partials(torch.stack([p[0] for p in parts]),
                                       torch.stack([p[1] for p in parts]))
        assert (mo.float() - ref)[ok].abs().max().item() <= 2e-2
        assert (ml - ref_lse)[ok].abs().max().item() <= 2e-3
        assert torch.all(mo[~ok] == 0)
    with pytest.raises(ValueError, match="lse"):
        launch_contig_decode(q, k, v, lens, lse=lse.double())
    with pytest.raises(ValueError, match="lse"):
        launch_contig_decode(q, k, v, lens, lse=lse[:, :1])


@pytest.mark.gpu
def test_new_wrappers_reject_what_their_kernels_do_not_take(cuda):
    bf = torch.bfloat16
    q = torch.zeros((1, 8, 2, 128), dtype=bf, device=cuda)
    kv = torch.zeros((1, 8, 2, 128), dtype=bf, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention_fwd(q.float(), kv.float(), kv.float())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q[..., :112].contiguous(), kv[..., :112].contiguous(),
                            kv[..., :112].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="is on"):
        flash_attention_fwd(q, kv.cpu(), kv)
    odd = torch.zeros(q.numel() + 1, dtype=bf, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_fwd(odd, kv, kv)
    with pytest.raises(ValueError, match="visit_out"):
        flash_attention_fwd(q, kv, kv, visit_out=torch.zeros(3, dtype=torch.int32, device=cuda))
    q1 = q[:, :1].contiguous()
    lens = torch.tensor([4], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_decode_fwd(q1.float(), kv.float(), kv.float(), lens)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode_fwd(q1[..., :112].contiguous(), kv[..., :112].contiguous(),
                         kv[..., :112].contiguous(), lens)
    with pytest.raises(ValueError, match="one query position"):
        flash_decode_fwd(q, kv, kv, lens)
    with pytest.raises(ValueError, match="multiple"):
        flash_decode_fwd(torch.zeros((1, 1, 3, 128), dtype=bf, device=cuda), kv, kv, lens)
    with pytest.raises(ValueError, match="aligned"):
        flash_decode_fwd(odd[:, :1], kv, kv, lens)
    with pytest.raises(ValueError, match="splits"):
        launch_contig_decode(q1, kv, kv, lens, splits=16)
    with pytest.raises(ValueError, match="visit_out"):
        launch_contig_decode(q1, kv, kv, lens, splits=1,
                             visit_out=torch.zeros((2, 1, 1, 3), dtype=torch.int32, device=cuda))


def _rel(got, want) -> float:
    return (got.float() - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal,window,sq,skv", [
    (True, None, 200, 200), (True, 50, 130, 130), (False, None, 130, 70), (True, None, 70, 200),
    (False, 40, 200, 90),
])
def test_flash_bwd_kernels_match_plain_and_walk_the_traversal(cuda, d, g, causal, window,
                                                              sq, skv):
    """B4-B6 vs the plain backward in f32 on the same bf16 inputs (o, lse
    from B2): delta within 1e-4 and dq, dk, dv within 2e-2 of max |plain|
    (P and dS rounded to bf16 before their products, bf16 outputs);
    gradients of what nothing sees exact zeros; the recorded dQ and dK/dV
    walks equal the host models of the persistent schedules at each
    kernel's tiles (``fwd_walks``, ``dkv_walks``); a second run gives equal bits; one
    launch each."""
    gen = torch.Generator(device=cuda).manual_seed(sq * 5 + skv + g + d)
    b, hkv = 2, 2
    q, do = _bf16(gen, (b, sq, hkv * g, d), cuda), _bf16(gen, (b, sq, hkv * g, d), cuda)
    k, v = _bf16(gen, (b, skv, hkv, d), cuda), _bf16(gen, (b, skv, hkv, d), cuda)
    r = torch.arange(sq, device=cuda)[:, None]
    c = torch.arange(skv, device=cuda)[None, :]
    seen = torch.ones((sq, skv), dtype=torch.bool, device=cuda)
    if causal:
        seen &= c <= r
    if window is not None:
        seen &= c > r - window
    workers = fwd_workers(cuda)
    for order in Order:
        kw = dict(order=order, causal=causal, window=window, snake_group=2)
        o, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
        tq = kernel_traversal(sq, skv, g, kernel="flash_bwd_dq", **kw)
        tkv = kernel_traversal(sq, skv, g, kernel="flash_bwd_dkv", **kw)
        vq = torch.empty((b * hkv, tq.grid_rows, tq.n_kv), dtype=torch.int32, device=cuda)
        vkv = torch.empty((b * hkv, tkv.n_kv, tkv.grid_rows), dtype=torch.int32, device=cuda)
        n0 = {n: cuda_lib.launch_counts[n] for n in ("flash_bwd_delta", "flash_bwd_dq",
                                                      "flash_bwd_dkv")}
        got = flash_attention_bwd(q, k, v, o, lse, do, visit_dq_out=vq, visit_dkv_out=vkv, **kw)
        torch.cuda.synchronize()
        assert all(cuda_lib.launch_counts[n] == n0[n] + 1 for n in n0)
        again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        want = plain_bwd(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                         q_block=BLOCK_M, kv_block=BLOCK_N, **kw)
        for x, y in zip(got, want):
            assert _rel(x, y) <= 2e-2
        delta = torch.empty_like(lse)
        launch_flash_bwd_delta(o, do, delta)
        assert _rel(delta, attention_delta(o, do)) <= 1e-4
        dq, dk, dv = got
        assert torch.all(dq[:, ~seen.any(1)] == 0)
        assert torch.all(dk[:, ~seen.any(0)] == 0) and torch.all(dv[:, ~seen.any(0)] == 0)
        assert torch.equal(vq.cpu(), torch.tensor(fwd_walks(tq, b * hkv, workers),
                                                  dtype=torch.int32))
        assert torch.equal(vkv.cpu(), torch.tensor(dkv_walks(tkv, b * hkv, workers),
                                                   dtype=torch.int32))


@pytest.mark.gpu
def test_flash_bwd_wrapper_rejects_what_its_kernels_do_not_take(cuda):
    bf = torch.bfloat16
    q = torch.zeros((1, 8, 2, 128), dtype=bf, device=cuda)
    kv = torch.zeros((1, 8, 2, 128), dtype=bf, device=cuda)
    lse = torch.zeros((1, 8, 2), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention_bwd(q, kv, kv, q.float(), lse, q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd(q, kv, kv, q, lse, q.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="does not match"):
        flash_attention_bwd(q, kv, kv, q, lse, q[:, :4].contiguous())
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, kv, kv, q, lse.to(bf), q)
    with pytest.raises(ValueError, match="head dim"):
        sub = q[..., :112].contiguous()
        flash_attention_bwd(sub, kv[..., :112].contiguous(), kv[..., :112].contiguous(), sub, lse,
                            sub)
    with pytest.raises(ValueError, match="visit_dkv_out"):
        flash_attention_bwd(q, kv, kv, q, lse, q,
                            visit_dkv_out=torch.zeros(3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="visit_dkv_out"):  # (1*2, n_kv 1, G*n_q 1) at 64 x 128
        flash_attention_bwd(q, kv, kv, q, lse, q,
                            visit_dkv_out=torch.zeros((2, 2, 1), dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 60])
def test_ops_attention_cuda_grads_match_torch(cuda, window):
    """Gradients through ops.attention with the kernels (B2 forward with
    lse, B4-B6 backward) against the plain impl on the same bf16 inputs,
    within 2e-2 of max |plain|."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    b, s, hq, hkv, d = 2, 190, 8, 2, 128
    base = [_bf16(gen, shape, cuda) for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))]
    w = _bf16(gen, (b, s, hq, d), cuda)
    grads = {}
    for impl in ("cuda", "torch"):
        leaves = [t.clone().requires_grad_(True) for t in base]
        out = ops.attention(*leaves, order="sawtooth", causal=True, window=window, q_block=64,
                            kv_block=64, impl=impl)
        (out.float() * w.float()).sum().backward()
        grads[impl] = [t.grad for t in leaves]
    for x, y in zip(grads["cuda"], grads["torch"]):
        assert _rel(x, y.float()) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("causal,window,sq,skv", [
    (True, None, 77, 77), (True, 50, 200, 200), (False, None, 130, 70),
])
def test_flash_fwd_kernel_head_dim_80(cuda, causal, window, sq, skv, d):
    """B2 at zamba2's head dim 80 and phi-3-vision's 96 (the 128 layout
    with zero-filled columns; no GQA, and GQA 4:2) against the plain
    version, with the tolerances of the D 64 and 128 test."""
    gen = torch.Generator(device=cuda).manual_seed(sq + d)
    for hq, hkv in ((4, 4), (4, 2)):
        q = _bf16(gen, (2, sq, hq, d), cuda)
        k, v = _bf16(gen, (2, skv, hkv, d), cuda), _bf16(gen, (2, skv, hkv, d), cuda)
        vis = _visible(sq, skv, causal, window, cuda)
        for order in Order:
            o, lse = flash_attention_fwd(q, k, v, order=order, causal=causal, window=window,
                                         snake_group=2, return_lse=True)
            ro, rl = flash_attention(q.float(), k.float(), v.float(), order=order, causal=causal,
                                     window=window, q_block=FWD_BLOCK_M,
                                     kv_block=FWD_BLOCK_N, snake_group=2, return_lse=True)
            torch.cuda.synchronize()
            assert (o.float() - ro)[:, vis].abs().max().item() <= 2e-2
            assert (lse - rl)[:, vis].abs().max().item() <= 2e-3
            assert torch.all(o[:, ~vis] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("window", [None, 100])
def test_contig_decode_kernel_head_dim_80(cuda, g, window, d):
    """B3 at head dims 80 and 96 (a lane pair splits the dims in halves for
    the scores; for P V lanes 0-7 (D 80) or 0-15 (D 96) own two bf16 pairs,
    the rest one) against the plain version: 2e-2 abs on rows of positive
    length, exact zeros on a row of length 0; the recorded walk equals the
    host model."""
    gen = torch.Generator(device=cuda).manual_seed(g * 10 + (window or 0) + d)
    b, hkv, s_max = 4, 2, 300
    q = _bf16(gen, (b, 1, hkv * g, d), cuda)
    k, v = _bf16(gen, (b, s_max, hkv, d), cuda), _bf16(gen, (b, s_max, hkv, d), cuda)
    lens = torch.tensor([300, 0, 129, 7], dtype=torch.int32, device=cuda)
    ref = decode_attention(q.float(), k.float(), v.float(), lens, window=window)
    for order in Order:
        out = flash_decode_fwd(q, k, v, lens, order=order, window=window, snake_group=2)
        torch.cuda.synchronize()
        ok = lens > 0
        assert (out.float() - ref)[ok].abs().max().item() <= 2e-2
        assert torch.all(out[~ok] == 0)
        _contig_walk_check(q, k, v, lens, order=order, window=window, chunk=512,
                           snake_group=2, out=out)


def _ssd_inputs(gen, bsz, s, h, n, dev, state):
    x = _bf16(gen, (bsz, s, h, 64), dev)
    dt = torch.nn.functional.softplus(torch.randn((bsz, s, h), generator=gen, device=dev) - 1.0)
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    b, c = _bf16(gen, (bsz, s, n), dev), _bf16(gen, (bsz, s, n), dev)
    init = torch.randn((bsz, h, 64, n), generator=gen, device=dev) if state else None
    return x, dt, a, b, c, init


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("s", [1, 77, 128, 129, 700])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("bsz", [2, 24], ids=["B2", "B24"])
def test_ssd_kernel_matches_plain(cuda, n, s, state, bsz):
    """B7 against ssd_chunked in float32 on the same bf16 inputs: y within
    1e-2 of max |plain| (y is written in bf16), the float32 final state
    within 1e-3 of max |plain|; one launch; a second run gives equal bits.
    S 129 ends one position past a chunk; B 24 x 6 heads is 144 work items,
    more than the first round of a 132-SM card's persistent grid. (The B 2
    cases keep their seed n + s + state; B 24 adds 24.)"""
    gen = torch.Generator(device=cuda).manual_seed(n + s + state + (0 if bsz == 2 else bsz))
    x, dt, a, b, c, init = _ssd_inputs(gen, bsz, s, 6, n, cuda, state)
    n0 = cuda_lib.launch_counts["ssd"]
    y, fin = ssd_fwd(x, dt, a, b, c, init_state=init)
    y2, fin2 = ssd_fwd(x, dt, a, b, c, init_state=init)
    ry, rfin = ssd_chunked(x.float(), dt, a, b.float(), c.float(), chunk=128, init_state=init)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["ssd"] == n0 + 2
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(fin).all()
    assert _rel(y, ry) <= 1e-2
    assert _rel(fin, rfin) <= 1e-3
    assert torch.equal(y, y2) and torch.equal(fin, fin2)


@pytest.mark.gpu
def test_ssd_kernel_records_its_walk(cuda):
    """Each CTA of B7's persistent grid records the items it took: equal to
    the host model ``ssd_walks`` at the kernel's own grid (``ssd_grid``),
    which takes more than one round here; the outputs equal the unrecorded
    launch's bits."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    bsz, h = 3, 50  # 150 items: more than one round of 132 SMs
    x, dt, a, b, c, init = _ssd_inputs(gen, bsz, 300, h, 64, cuda, True)
    grid = ssd_grid(bsz, h, torch.cuda.get_device_properties(cuda).multi_processor_count)
    want = ssd_walks(bsz, h, grid)
    visit = torch.full(tuple(want.shape), -7, dtype=torch.int32, device=cuda)
    y, fin = ssd_fwd(x, dt, a, b, c, init_state=init, visit_out=visit)
    y0, fin0 = ssd_fwd(x, dt, a, b, c, init_state=init)
    torch.cuda.synchronize()
    assert torch.equal(visit.cpu(), want)
    assert torch.equal(y, y0) and torch.equal(fin, fin0)


@pytest.mark.gpu
def test_ssd_kernel_attr(cuda):
    """B7's launch attributes: one CTA an SM at most, no spill, the shared
    memory of its ring."""
    for n, smem in ((128, 218144), (64, 136224)):
        attr = ssd_kernel_attr(8, 24, n, cuda)
        assert attr["local_bytes"] == 0 and attr["cluster_size"] == 1
        assert attr["dynamic_smem_bytes"] == smem and attr["threads"] == 512
        assert attr["ctas"] == min(192, torch.cuda.get_device_properties(cuda).multi_processor_count)


@pytest.mark.gpu
def test_ssd_kernel_chains_through_the_state(cuda):
    """Two calls chained through the final state equal one call."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, dt, a, b, c, _ = _ssd_inputs(gen, 2, 300, 4, 128, cuda, False)
    y, fin = ssd_fwd(x, dt, a, b, c)
    y1, s1 = ssd_fwd(*(t[:, :200].contiguous() for t in (x, dt)), a,
                     *(t[:, :200].contiguous() for t in (b, c)))
    y2, s2 = ssd_fwd(*(t[:, 200:].contiguous() for t in (x, dt)), a,
                     *(t[:, 200:].contiguous() for t in (b, c)), init_state=s1)
    torch.cuda.synchronize()
    assert _rel(torch.cat([y1, y2], 1), y.float()) <= 1e-2
    assert _rel(s2, fin) <= 1e-3


@pytest.mark.gpu
def test_ssd_wrapper_rejects_what_its_kernel_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    x, dt, a, b, c, _ = _ssd_inputs(gen, 1, 16, 2, 64, cuda, False)
    with pytest.raises(TypeError, match="bfloat16"):
        ssd_fwd(x.float(), dt, a, b, c)
    with pytest.raises(TypeError, match="float32"):
        ssd_fwd(x, dt.to(torch.bfloat16), a, b, c)
    with pytest.raises(ValueError, match="state dim"):
        ssd_fwd(x, dt, a, b[..., :32].contiguous(), c[..., :32].contiguous())
    with pytest.raises(ValueError, match="head dim"):
        ssd_fwd(x[..., :32].contiguous(), dt, a, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_fwd(x, dt, a, b, torch.cat([c, c], -1)[..., ::2])
    with pytest.raises(ValueError, match="chunk"):
        ssd_fwd(x, dt, a, b, c, chunk=64)
    with pytest.raises(ValueError, match="does not fit"):
        ssd_fwd(x, dt, a, b, c, init_state=torch.zeros((1, 2, 64, 32), device=cuda))


@pytest.mark.gpu
def test_ops_ssd_cuda_matches_torch(cuda):
    """ops.ssd with the kernel on the strided slices a Mamba block gives it
    (x, b, c cut from one projection), and its recompute backward, against
    the plain impl."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    bsz, s, h, n = 2, 150, 4, 64
    xbc = _bf16(gen, (bsz, s, h * 64 + 2 * n), cuda)
    x = xbc[..., : h * 64].reshape(bsz, s, h, 64)
    b, c = xbc[..., h * 64 : h * 64 + n], xbc[..., h * 64 + n :]
    dt = torch.nn.functional.softplus(torch.randn((bsz, s, h), generator=gen, device=cuda))
    a = -torch.linspace(1.0, 16.0, h, device=cuda)
    out = {}
    for impl in ("cuda", "torch"):
        leaf = x.detach().clone().requires_grad_(True)
        y, fin = ops.ssd(leaf, dt, a, b, c, impl=impl)
        (y.float().square().sum() + fin.square().sum()).backward()
        out[impl] = (y, fin, leaf.grad)
    assert _rel(out["cuda"][0], out["torch"][0].float()) <= 1e-2
    assert _rel(out["cuda"][1], out["torch"][1]) <= 1e-3
    assert _rel(out["cuda"][2], out["torch"][2].float()) <= 2e-2


# ---- ragged_dot: the MoE's grouped product (a library call, not a kernel of ours) -------


@pytest.mark.gpu
@pytest.mark.parametrize("short", [False, True], ids=["full", "short"])
@pytest.mark.parametrize("e,k,n,m", [(64, 2048, 1024, 64), (64, 1024, 2048, 512),
                                     (8, 4096, 14336, 16), (4, 64, 32, 7)])
def test_ragged_dot_grouped_mm_matches_plain(cuda, e, k, n, m, short):
    """``impl="cuda"`` (``grouped_mm``, offsets on the card) against the
    plain masked products on the same bf16 inputs, with empty groups;
    counted once a call in ``library_counts``, never in ``launch_counts``.
    ``short``: the sizes sum to less than M, and the rows past the last
    group are exact zeros in both, as ``jax.lax.ragged_dot`` gives them."""
    g = torch.Generator(device=cuda).manual_seed(e + m)
    x = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    w = (torch.randn(e, k, n, device=cuda, generator=g) / k ** 0.5).bfloat16()
    used = m - max(1, m // 4) if short else m
    ids = torch.randint(0, max(1, e // 2), (used,), device=cuda, generator=g)
    sizes = torch.zeros(e, dtype=torch.int64, device=cuda).scatter_add_(
        0, ids, torch.ones_like(ids)).to(torch.int32)
    assert int((sizes == 0).sum()) > 0 and int(sizes.sum()) == used
    cuda_lib.reset_launch_counts()
    got = ops.ragged_dot(x, w, sizes, impl="cuda")
    want = ops.ragged_dot(x, w, sizes, impl="torch")
    assert cuda_lib.library_counts["ragged_dot"] == 1 and not any(cuda_lib.launch_counts.values())
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert err < 1e-2, err
    assert not got[used:].any() and not want[used:].any()
    assert torch.equal(ops.ragged_dot(x, w, sizes), got)   # auto picks cuda on the card


@pytest.mark.gpu
def test_ragged_dot_cuda_refuses_what_it_does_not_take(cuda):
    x, w = torch.zeros(8, 64, device=cuda), torch.zeros(2, 64, 32, device=cuda)
    sizes = torch.tensor([4, 4], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.ragged_dot(x, w, sizes, impl="cuda")
    with pytest.raises(ValueError, match="on the card"):
        ops.ragged_dot(x.bfloat16(), w.bfloat16(), sizes.cpu(), impl="cuda")
