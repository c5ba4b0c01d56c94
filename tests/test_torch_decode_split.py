"""The decode kernels' split walks (B1 ``csrc/paged_decode.cu``, B3
``csrc/contig_decode.cu``) and their split-then-merge arithmetic, on the
CPU.

* The host walk models (``paged_decode_walks``, ``contig_decode_walks``)
  against the visit orders of both packages: the segments over the splits,
  concatenated, equal the row's visit order (``page_visit_order``,
  ``kv_index_host``, the port's and the JAX reference's on the same numpy
  inputs) trimmed to the pages or tiles some row of the work item sees,
  that set found here by brute force over the columns.
* ``decode_splits``: the cluster sizes it picks, and that every S the kernels
  take is reachable.
* A plain float32 model of the kernels' arithmetic (each split's online
  softmax over its segment, then the log-sum-exp merge of the S partial
  states in split order, a split that saw nothing contributing m = the mask
  value and l = 0) against ``paged_decode_attention`` and
  ``decode_attention``: within 1e-6 (float32 sums taken in another order),
  exact zeros where nothing is seen.

No GPU: the kernels' recorded walks are held to the same models on the card
by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import torch

from repro.core import schedule as ref_sched
from repro_torch.core.attention import decode_attention, paged_decode_attention
from repro_torch.core.schedule import kv_index_host, page_visit_order
from repro_torch.kernels.flash_decode import (
    DECODE_ROW_TILE,
    DECODE_TILE,
    contig_decode_rows,
    contig_decode_splits,
    contig_decode_walks,
    decode_chunk,
    decode_splits,
    paged_decode_splits,
    paged_decode_walks,
)
from repro_torch.kernels.flash_attention import MASK_VALUE

TOL = 1e-6
SPLITS = [1, 2, 4, 8]
ORDERS = ["cyclic", "sawtooth", "block_snake"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---- B1: the paged walk --------------------------------------------------------


def _paged_problem(seed, *, c, g, hkv=2, d=16, page=16, window=None, lens=None, q_lens=None):
    rng = np.random.default_rng(seed)
    b = 5
    if lens is None:
        lens = [c + 90, c + 3, 0, 40, c // 2 + 20]
        q_lens = [c, max(c - 4, 1), 0, min(c, 2), c // 2 + 1]
    n_blocks = -(-max(lens) // page) + 1
    n_pages = b * n_blocks + 1
    q = rng.standard_normal((b, c, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, page, hkv, d)).astype(np.float32)
    bt = (rng.permutation(n_pages - 1)[: b * n_blocks] + 1).reshape(b, n_blocks).astype(np.int32)
    return (q, k, v, bt, np.array(lens, np.int32), np.array(q_lens, np.int32), n_blocks)


def _seen_pages(visit, ln, ql, *, c, g, page, window, row0):
    """Pages of ``visit`` that hold a column some valid row of the row tile
    from ``row0`` sees, by brute force over the columns."""
    rows = [r for r in range(row0, min(row0 + DECODE_ROW_TILE, c * g)) if r // g < min(ql, c)]
    if ln <= 0 or not rows:
        return []
    cols = set()
    for r in rows:
        qp = ln - ql + r // g
        cols |= {col for col in range(ln) if col <= qp and (window is None or col > qp - window)}
    return [p for p in visit if any(p * page + o in cols for o in range(page))]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("c,g", [(1, 1), (1, 8), (15, 1), (65, 1), (40, 4)])
@pytest.mark.parametrize("window", [None, 37])
def test_paged_walks_cut_the_trimmed_visit_order(order, splits, c, g, window):
    """Concatenated over the splits, each row tile's recorded pages are the
    row's visit order (the port's and the reference's page_visit_order)
    trimmed to the pages its valid rows see; every kv head walks alike."""
    *_, bt, lens, q_lens, n_blocks = _paged_problem(0, c=c, g=g)
    page, hkv = 16, 2
    visit = page_visit_order(order, torch.from_numpy(lens), n_blocks, snake_group=2)
    ref_visit = np.asarray(ref_sched.page_visit_order(order, jnp.asarray(lens), n_blocks,
                                                      snake_group=2))
    np.testing.assert_array_equal(visit.numpy(), ref_visit)
    walks = paged_decode_walks(visit, lens, q_lens, c=c, g=g, hkv=hkv, page=page,
                               window=window, splits=splits)
    n_rt = -(-c * g // DECODE_ROW_TILE)
    assert tuple(walks.shape) == (len(lens) * hkv, n_rt, splits, n_blocks)
    for b in range(len(lens)):
        for rt in range(n_rt):
            want = _seen_pages(ref_visit[b].tolist(), int(lens[b]), int(q_lens[b]), c=c, g=g,
                               page=page, window=window, row0=rt * DECODE_ROW_TILE)
            segs = walks[b * hkv, rt].tolist()
            got = [p for seg in segs for p in seg if p >= 0]
            assert got == want
            for seg in segs:  # each segment a prefix, -1 after
                n = sum(p >= 0 for p in seg)
                assert all(p == -1 for p in seg[n:])
            sizes = [sum(p >= 0 for p in seg) for seg in segs]
            assert max(sizes) - min(sizes) <= 1  # balanced segments
            for h in range(1, hkv):
                assert torch.equal(walks[b * hkv + h], walks[b * hkv])


# ---- B3: the contiguous walk ---------------------------------------------------


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("chunk", [128, 512, 100])
@pytest.mark.parametrize("window", [None, 100])
def test_contig_walks_cut_the_trimmed_chunk_order(order, splits, chunk, window):
    """Concatenated over the splits, an item's recorded tiles are its chunks
    in kv_index_host(order, b * Hkv + h, j, n_chunks) order (the port's and
    the reference's), each in 64-position tiles, trimmed to the tiles that
    hold a visible position."""
    s_max, hkv, g = 300, 2, 4
    lens = [300, 0, 129, 7, 255]
    walks = contig_decode_walks(torch.tensor(lens), s_max=s_max, hkv=hkv, g=g, chunk=chunk,
                                order=order, snake_group=2, window=window, splits=splits)
    ch = decode_chunk(chunk, s_max)
    n_chunks = -(-s_max // ch)
    width = n_chunks * -(-ch // DECODE_TILE)
    assert tuple(walks.shape) == (len(lens) * hkv, 1, splits, width)
    for b, ln in enumerate(lens):
        first = max(0, ln - window) if window is not None else 0
        for h in range(hkv):
            bh = b * hkv + h
            want = []
            for j in range(n_chunks):
                jc = kv_index_host(order, bh, j, n_chunks, snake_group=2)
                assert jc == ref_sched.kv_index_host(order, bh, j, n_chunks, snake_group=2)
                for t0 in range(jc * ch, min(jc * ch + ch, s_max), DECODE_TILE):
                    t1 = min(t0 + DECODE_TILE, jc * ch + ch)
                    if any(first <= pos < ln for pos in range(t0, t1)):
                        want.append(t0)
            got = [t for seg in walks[bh, 0].tolist() for t in seg if t >= 0]
            assert got == want


def test_decode_splits_fill_one_wave_and_reach_every_size():
    sms = 132
    assert decode_splits(256, 16, sms) == 1      # B 8 x 32 kv heads: the card is full
    assert decode_splits(64, 16, sms) == 4       # B 8 x 8 kv heads
    assert decode_splits(32, 16, sms) == 8       # one sequence, 32 kv heads
    assert decode_splits(32, 5, sms) == 4        # no more splits than units
    assert decode_splits(32, 3, sms) == 2
    assert decode_splits(1000, 64, sms) == 1
    assert decode_splits(1, 1, sms) == 1
    assert decode_splits(64, 16, sms, per_sm=2) == 4
    assert decode_splits(100, 16, sms, per_sm=2) == 2
    assert {decode_splits(n, 64, sms) for n in (10, 60, 120, 300)} == set(SPLITS)
    for n in range(1, 600, 7):
        for per_sm in (2, 3):
            s = decode_splits(n, 64, sms, per_sm)
            assert s in SPLITS
            assert s == 1 or n * s <= per_sm * sms  # one wave
            assert s == 8 or n * 2 * s > per_sm * sms  # the largest that fits
        assert decode_splits(n, 3, sms) <= 3
    assert paged_decode_splits(8, 32, 16, sms) == 1
    assert paged_decode_splits(1, 32, 16, sms, rows=256) == 8
    assert paged_decode_splits(2, 32, 16, sms, rows=256) == 4
    assert paged_decode_splits(2, 32, 16, sms, rows=8) == 4
    assert contig_decode_splits(8, 8, 4, 1024, sms) == 4
    assert [contig_decode_rows(g) for g in (1, 2, 3, 4, 5, 8)] == [1, 2, 4, 4, 8, 8]


# ---- split-then-merge -------------------------------------------------------------


def _partial(qf, kc, vc, ok):
    """One split's online-softmax state over its columns: qf (..., R, D)
    pre-scaled, kc/vc (..., N, D), ok (..., R, N). m is the mask value and
    l 0 where nothing is seen."""
    s = torch.where(ok, torch.einsum("...rd,...nd->...rn", qf, kc), MASK_VALUE)
    m = torch.full(s.shape[:-1], MASK_VALUE) if s.shape[-1] == 0 else s.amax(-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(-1), torch.einsum("...rn,...nd->...rd", p, vc)


def _merge(parts):
    """Log-sum-exp merge of (m, l, acc) partial states in split order."""
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    lt = torch.zeros_like(mx)
    at = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.exp(m - mx)
        lt = lt + l * f
        at = at + acc * f[..., None]
    return at / torch.where(lt == 0.0, 1.0, lt)[..., None]


def _paged_split_model(q, k, v, visit, bt, lens, q_lens, *, window, splits):
    b, c, hq, d = q.shape
    _, page, hkv, _ = k.shape
    g = hq // hkv
    walks = paged_decode_walks(visit, lens, q_lens, c=c, g=g, hkv=hkv, page=page,
                               window=window, splits=splits)
    qf = q.reshape(b, c, hkv, g, d).permute(0, 2, 1, 3, 4).reshape(b, hkv, c * g, d) * d ** -0.5
    out = torch.zeros((b, hkv, c * g, d))
    for bi in range(b):
        ln, ql = int(lens[bi]), int(q_lens[bi])
        for rt in range(walks.shape[1]):
            row0 = rt * DECODE_ROW_TILE
            rows = torch.arange(row0, min(row0 + DECODE_ROW_TILE, c * g))
            t = rows // g
            valid = (t < min(ql, c)) & (ln > 0)
            qpos = ln - ql + t
            parts = []
            for s in range(splits):
                pages = [p for p in walks[bi * hkv, rt, s].tolist() if p >= 0]
                pids = [int(bt[bi, p]) for p in pages]
                cols = torch.tensor([p * page + o for p in pages for o in range(page)],
                                    dtype=torch.long)
                kc = k[pids].reshape(-1, hkv, d).permute(1, 0, 2)  # (Hkv, N, D)
                vc = v[pids].reshape(-1, hkv, d).permute(1, 0, 2)
                ok = (cols[None, :] <= qpos[:, None]) & (cols[None, :] < ln) & valid[:, None]
                if window is not None:
                    ok &= cols[None, :] > qpos[:, None] - window
                parts.append(_partial(qf[bi][:, rows], kc, vc, ok.expand(hkv, -1, -1)))
            o = _merge(parts)
            out[bi][:, rows] = torch.where(valid[None, :, None], o, 0.0)
    return out.reshape(b, hkv, c, g, d).permute(0, 2, 1, 3, 4).reshape(b, c, hq, d)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("c", [1, 15, 64, 65, 256])
def test_paged_split_then_merge_equals_the_plain_attention(splits, g, c):
    """Rows of length 0 and with no valid chunk row, ragged q_lens, a window,
    the sawtooth order; with S 8 several splits see nothing."""
    if c * g > 512:
        c = max(1, 512 // g)  # the same cases at a CPU-sized row count
    for window in (None, 37):
        q, k, v, bt, lens, q_lens, n_blocks = _paged_problem(c * 10 + g, c=c, g=g,
                                                              window=window)
        q, k, v = (torch.from_numpy(x) for x in (q, k, v))
        bt_t, lens_t, ql_t = (torch.from_numpy(x) for x in (bt, lens, q_lens))
        visit = page_visit_order("sawtooth", lens_t, n_blocks)
        got = _paged_split_model(q, k, v, visit, bt, lens, q_lens, window=window, splits=splits)
        want = paged_decode_attention(q, k, v, lens_t, bt_t, q_lens=ql_t, window=window,
                                      order="sawtooth")
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
        zero = (torch.arange(c)[None, :] >= ql_t[:, None]) | (lens_t[:, None] == 0)
        assert torch.all(got[zero] == 0)


def _contig_split_model(q, k, v, lens, *, window, chunk, order, splits):
    b, _, hq, d = q.shape
    _, s_max, hkv, _ = k.shape
    g = hq // hkv
    walks = contig_decode_walks(lens, s_max=s_max, hkv=hkv, g=g, chunk=chunk, order=order,
                                snake_group=2, window=window, splits=splits)
    qf = q.reshape(b, hkv, g, d) * d ** -0.5
    out = torch.zeros((b, hkv, g, d))
    for bi in range(b):
        ln = int(lens[bi])
        first = max(0, ln - window) if window is not None else 0
        for h in range(hkv):
            parts = []
            for s in range(splits):
                t0s = [t for t in walks[bi * hkv + h, 0, s].tolist() if t >= 0]
                pos = torch.tensor([t + o for t in t0s for o in range(DECODE_TILE)
                                    if t + o < s_max], dtype=torch.long)
                ok = ((pos >= first) & (pos < ln))[None, :].expand(g, -1)
                parts.append(_partial(qf[bi, h], k[bi, pos, h], v[bi, pos, h], ok))
            out[bi, h] = _merge(parts)
    return out.reshape(b, 1, hq, d)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("order", ORDERS)
def test_contig_split_then_merge_equals_the_plain_decode(splits, g, order):
    """Ragged lengths with a 0, S_max (300) not a multiple of the chunk,
    with and without a window, chunks of 128 and 512."""
    rng = np.random.default_rng(splits * 100 + g)
    b, s_max, hkv, d = 5, 300, 2, 16
    q = torch.from_numpy(rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s_max, hkv, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s_max, hkv, d)).astype(np.float32))
    lens = torch.tensor([300, 0, 129, 7, 255], dtype=torch.int32)
    ok = lens > 0
    for window in (None, 100):
        for chunk in (128, 512):
            got = _contig_split_model(q, k, v, lens, window=window, chunk=chunk, order=order,
                                      splits=splits)
            want = decode_attention(q, k, v, lens, window=window)
            torch.testing.assert_close(got[ok], want[ok], atol=TOL, rtol=TOL)
            assert torch.all(got[~ok] == 0)
