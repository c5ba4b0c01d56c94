"""B7's arithmetic and work items (``csrc/ssd.cu``), modelled on the CPU.

The kernel runs every product of the SSD on the tensor cores in bf16, and
keeps float32 accuracy by splitting each float32 operand (W, the state S,
the scaled x) into hi = bf16(v) and lo = bf16(v - hi), two products where
there was one; the bf16 inputs x, b, c enter exactly. ``_kernel_model``
repeats that arithmetic in plain float32 torch: the persistent grid's work
items in the order the CTAs take them (``ssd_grid``, ``ssd_walks``; item
u is batch row u // H, head u % H), each item's chunks of 128 positions in order (the ragged
last one padded with dt = 0), cum in the log2 domain, C B^T, W on j <= i,
y = exp(cum_i) (C S^T) + W X, the state update, y rounded to bf16.

* With hi and lo, the model falls within ``SSD_Y_TOL`` and
  ``SSD_STATE_TOL`` (``chip_smoke.py``'s limits for the kernel, relative to
  max |expected|) of the JAX reference's Pallas ``ssd_fwd`` in interpret
  mode and of the port's ``ssd_chunked``, at the model's scales (a down to
  -16, dt = softplus(noise - 3)), with S past a chunk boundary and a random
  initial state.
* With hi alone (plain bf16 products of the float32 operands), it exceeds
  the state limit: the test tells the two apart.
* The grid rule's items cover every (b, h, p) once, and the heads of one
  batch row are adjacent in the order.

No GPU: the kernel's recorded walks are held to ``ssd_walks`` on the card
by ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import torch

from repro.kernels.ssd import ssd_fwd as ref_ssd_fwd
from repro_torch.kernels.ssd import CHUNK, HEAD_DIM, ssd_grid, ssd_walks
from repro_torch.models.ssm import ssd_chunked

# chip_smoke.py's limits for B7, each relative to max |expected|: y (written
# in bf16), the final state (float32).
SSD_Y_TOL = 1e-2
SSD_STATE_TOL = 1e-4
LOG2E = 1.4426950408889634
SMS = 132  # an H100's SMs: the grid the kernel takes there


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _bf16(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(v).to(torch.bfloat16).float().numpy()


def _inputs(seed, bsz, s, h, n, state):
    """B7's inputs at the model's scales (chip_smoke._ssd_case), from numpy:
    x, b, c unit normals rounded to bf16 (held as float32); dt =
    softplus(noise - 3); a = -linspace(1, 16, H); a random float32 initial
    state or None."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=(bsz, s, h, HEAD_DIM)).astype(np.float32))
    dt = np.log1p(np.exp(rng.normal(size=(bsz, s, h)) - 3.0)).astype(np.float32)
    a = (-np.linspace(1.0, 16.0, h)).astype(np.float32)
    b = _bf16(rng.normal(size=(bsz, s, n)).astype(np.float32))
    c = _bf16(rng.normal(size=(bsz, s, n)).astype(np.float32))
    init = rng.normal(size=(bsz, h, HEAD_DIM, n)).astype(np.float32) if state else None
    return x, dt, a, b, c, init


def _parts(v: torch.Tensor, split: bool) -> list:
    """v as the bf16 parts the kernel multiplies: [hi, lo], or [hi] alone."""
    hi = v.to(torch.bfloat16).float()
    return [hi, (v - hi).to(torch.bfloat16).float()] if split else [hi]


def _kernel_model(x, dt, a, b, c, init, *, split=True):
    """B7's arithmetic in float32 torch: returns (y as bf16 values in
    float32, final state, the items in the order the CTAs took them)."""
    x, dt, a, b, c = (torch.from_numpy(v) for v in (x, dt, a, b, c))
    bsz, s, h, _ = x.shape
    n = b.shape[-1]
    grid = ssd_grid(bsz, h, SMS)
    y = torch.zeros_like(x)
    fin = torch.zeros((bsz, h, HEAD_DIM, n))
    taken = []
    causal = torch.ones((CHUNK, CHUNK)).tril().bool()
    for walk in ssd_walks(bsz, h, grid).tolist():
        for u in walk:
            if u < 0:
                continue
            taken.append(u)
            bi, hh = divmod(u, h)
            st = (torch.from_numpy(init[bi, hh]).clone() if init is not None
                  else torch.zeros((HEAD_DIM, n)))
            for s0 in range(0, s, CHUNK):
                valid = min(CHUNK, s - s0)

                def chunk(t):  # the chunk's rows, zeros past S (TMA's fill)
                    out = torch.zeros((CHUNK,) + t.shape[1:])
                    out[:valid] = t[s0:s0 + valid]
                    return out

                xc = chunk(x[bi, :, hh])
                dtc = chunk(dt[bi, :, hh])
                bc, cc = chunk(b[bi]), chunk(c[bi])
                cum = torch.cumsum(dtc * (a[hh] * LOG2E), 0)
                last = cum[-1]
                gram = cc @ bc.T
                decay = torch.exp2(torch.where(causal, cum[:, None] - cum[None, :], 0.0))
                w = torch.where(causal, gram * decay * dtc[None, :], 0.0)
                yc = sum(cc @ part.T for part in _parts(st, split)) * torch.exp2(cum)[:, None]
                yc = yc + sum(part @ xc for part in _parts(w, split))
                y[bi, s0:s0 + valid, hh] = yc[:valid]
                xs = xc * (dtc * torch.exp2(last - cum))[:, None]
                st = st * torch.exp2(last) + sum(part.T @ bc for part in _parts(xs, split))
            fin[bi, hh] = st
    return y.to(torch.bfloat16).float(), fin, taken


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# (B, S, H, N): S past a chunk boundary (129, 300) and inside one (77).
CASES = [(1, 129, 2, 64), (2, 300, 3, 128), (1, 77, 2, 128), (2, 300, 2, 64)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("state", [False, True], ids=["zero", "init"])
def test_split_model_within_limits_of_the_pallas_kernel(case, state):
    """The model with hi and lo against the reference's Pallas kernel in
    interpret mode and against the port's plain chunked scan."""
    bsz, s, h, n = case
    x, dt, a, b, c, init = _inputs(sum(case) + state, bsz, s, h, n, state)
    y, fin, _ = _kernel_model(x, dt, a, b, c, init)
    jy, jfin = ref_ssd_fwd(*(jnp.asarray(v) for v in (x, dt, a, b, c)), chunk=CHUNK,
                           init_state=None if init is None else jnp.asarray(init),
                           interpret=True)
    assert _rel(y, jy) <= SSD_Y_TOL
    assert _rel(fin, jfin) <= SSD_STATE_TOL
    py, pfin = ssd_chunked(*(torch.from_numpy(v) for v in (x, dt, a, b, c)), chunk=CHUNK,
                           init_state=None if init is None else torch.from_numpy(init))
    assert _rel(y, py) <= SSD_Y_TOL
    assert _rel(fin, pfin) <= SSD_STATE_TOL


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "init"])
def test_hi_only_fails_the_state_limit(n, state):
    """Plain bf16 products of W, S and the scaled x (hi alone) miss the
    state limit that hi + lo meets, on the same inputs."""
    x, dt, a, b, c, init = _inputs(n + state, 2, 300, 3, n, state)
    py, pfin = ssd_chunked(*(torch.from_numpy(v) for v in (x, dt, a, b, c)), chunk=CHUNK,
                           init_state=None if init is None else torch.from_numpy(init))
    _, fin, _ = _kernel_model(x, dt, a, b, c, init)
    _, fin_hi, _ = _kernel_model(x, dt, a, b, c, init, split=False)
    assert _rel(fin, pfin) <= SSD_STATE_TOL
    assert _rel(fin_hi, pfin) > SSD_STATE_TOL


@pytest.mark.parametrize("bsz,heads", [(8, 24), (8, 80), (1, 24), (3, 50), (1, 1)])
@pytest.mark.parametrize("sms", [132, 7])
def test_grid_rule_covers_every_row_head_and_column_once(bsz, heads, sms):
    """ssd_grid/ssd_walks: every item taken by exactly one CTA, CTA w taking
    w, w + grid, ...; item u is (u // H, u % H) with all P columns, so every
    (b, h, p) is covered once and the heads of one batch row are adjacent;
    the grid is one CTA an SM, at most one an item."""
    grid = ssd_grid(bsz, heads, sms)
    assert grid == min(sms, bsz * heads)
    walks = ssd_walks(bsz, heads, grid)
    assert walks.dtype == torch.int32 and walks.shape == (grid, -(-bsz * heads // grid))
    seen = np.zeros((bsz, heads, HEAD_DIM), np.int64)
    for w, walk in enumerate(walks.tolist()):
        taken = [u for u in walk if u >= 0]
        assert walk == taken + [-1] * (len(walk) - len(taken))
        assert taken == list(range(w, bsz * heads, grid))
        for u in taken:
            seen[u // heads, u % heads, :] += 1
    assert (seen == 1).all()
    order = sorted(u for walk in walks.tolist() for u in walk if u >= 0)
    assert [(u // heads, u % heads) for u in order] == [
        (bi, hh) for bi in range(bsz) for hh in range(heads)]

