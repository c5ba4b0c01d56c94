"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one. The machine with the
card has no JAX, so this file imports only torch and the port; run it there
without the repository's conftest (which imports JAX):

  python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py
"""

import pytest

pytest.importorskip("torch")

import torch

from repro_torch.core.attention import paged_decode_attention
from repro_torch.core.schedule import Order, resolve_order_group
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_decode import paged_flash_decode_fwd


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paged_decode kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("page", [8, 64])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("c", [1, 7, 40])
def test_cuda_kernel_matches_plain(cuda, page, g, c):
    """bf16 kernel vs the plain version in f32 on the same bf16 inputs:
    2e-2 abs (bf16 output rounding); zero rows exact."""
    gen = torch.Generator(device=cuda).manual_seed(page * 100 + g * 10 + c)
    b, hkv, d, nb = 4, 2, 128, 6
    n_pages = b * nb + 1
    bf = torch.bfloat16
    k = torch.randn((n_pages, page, hkv, d), generator=gen, device=cuda).to(bf)
    v = torch.randn((n_pages, page, hkv, d), generator=gen, device=cuda).to(bf)
    q = torch.randn((b, c, hkv * g, d), generator=gen, device=cuda).to(bf)
    bt = (torch.randperm(n_pages - 1, generator=gen, device=cuda)[: b * nb] + 1)
    bt = bt.reshape(b, nb).to(torch.int32)
    lens = torch.tensor([nb * page, nb * page // 2 + 3, 0, 5], dtype=torch.int32, device=cuda)
    qls = torch.tensor([c, (c + 1) // 2, 0, 0], dtype=torch.int32, device=cuda)
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


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 1, 2, 128), dtype=torch.float32, device=cuda)
    k = torch.zeros((3, 8, 2, 128), dtype=torch.float32, device=cuda)
    bt = torch.ones((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        paged_flash_decode_fwd(q, k, k, 4, bt)
    qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        paged_flash_decode_fwd(qb[..., :96].contiguous(), kb[..., :96].contiguous(),
                               kb[..., :96].contiguous(), 4, bt)
    with pytest.raises(ValueError, match="multiple"):
        paged_flash_decode_fwd(torch.zeros((1, 1, 3, 128), dtype=torch.bfloat16, device=cuda),
                               kb, kb, 4, bt)
