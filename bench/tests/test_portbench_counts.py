"""The FLOP and byte counts behind ``mfu``, ``b1_roofline`` and
``b2_roofline``, held to values worked by hand for one small request set:
a dense model of 2 layers, d 8, 2 query heads of 4 sharing 1 KV head, d_ff
16, vocab 10, and a MoE sibling with 4 experts of width 6, top 2.
Requests: (prompt 3, 2 out) and (prompt 1, 1 out)."""

import pytest

import portbench_cells  # noqa: F401  (puts the repo on sys.path)
from bench import counts
from bench.constants import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

DENSE = counts.Shapes(layers=2, d=8, heads=2, kv_heads=1, head_dim=4, d_ff=16, vocab=10)
MOE = counts.Shapes(layers=2, d=8, heads=2, kv_heads=1, head_dim=4, d_ff=16, vocab=10,
                    experts=4, top_k=2, d_ff_expert=6)
REQS = [(3, 2), (1, 1)]


def test_layer_params_dense_and_moe():
    # attention 8*8 (q) + 2*8*4 (k, v) + 8*8 (o) = 192; SwiGLU 3*8*16 = 384
    assert counts.layer_matmul_params(DENSE) == 576
    # the router 8*4 and the 2 active experts' SwiGLUs 2*3*8*6, not all 4
    assert counts.layer_matmul_params(MOE) == 192 + 32 + 288


def test_served_flops_by_hand():
    # (3, 2): 4 processed tokens; pairs 6 causal + 4 (one decode step over
    # 4 positions); a layer 2*576*4 + 32*10 = 4928; head 2*8*10*2 = 320.
    # (1, 1): 1 token, 1 pair: 2*576 + 32 = 1184 a layer; head 160.
    assert counts.served_flops(DENSE, REQS) == 2 * 4928 + 320 + 2 * 1184 + 160
    assert counts.served_flops(DENSE, [(5, 0)]) == 0


def test_moe_counts_only_active_experts():
    dense_part = counts.served_flops(DENSE, REQS) - 2 * (576 * 2 * 4 + 576 * 2 * 1)
    assert counts.served_flops(MOE, REQS) == dense_part + 2 * (512 * 2 * 4 + 512 * 2 * 1)


def test_prefill_flops_no_pads():
    # prompt 3: a layer 2*576*3 + 32*6, head 160; a prompt padded to 5 in
    # its bucket still counts its own 3 positions
    assert counts.prefill_flops(DENSE, [3]) == 2 * (3456 + 192) + 160


def test_b1_need_by_hand():
    # K/V row 2*1*4*2 = 16 B, q + o row 2*2*4*2 = 32 B.
    # (3, 2): prompt K/V read once (3) + one decode step over 4 positions,
    # 4 processed tokens' q/o rows: 7*16 + 4*32 = 240 B, 32*(6+4) FLOPs;
    # (1, 1): 16 + 32 = 48 B, 32 FLOPs. Two layers.
    flops, nbytes = counts.b1_need(DENSE, REQS)
    assert (flops, nbytes) == (2 * (320 + 32), 2 * (240 + 48))


def test_b2_need_by_hand_and_causal():
    # causal pairs 6 + 1; q, k, v, o rows (2*2 + 2*1)*4*2 = 48 B a position
    flops, nbytes = counts.b2_need(DENSE, [3, 1])
    assert (flops, nbytes) == (2 * 32 * 7, 2 * 4 * 48)
    # causal: a prompt twice as long needs a bit over 4x the pairs
    assert counts.b2_need(DENSE, [200])[0] / counts.b2_need(DENSE, [100])[0] == pytest.approx(
        200 * 201 / (100 * 101))


def test_roofline_takes_the_larger_bound():
    assert counts.roofline_seconds(PEAK_BF16_FLOPS, 0) == 1.0
    assert counts.roofline_seconds(0, 2 * PEAK_HBM_BYTES) == 2.0
    assert counts.roofline_seconds(PEAK_BF16_FLOPS, 2 * PEAK_HBM_BYTES) == 2.0


@pytest.mark.parametrize("name", ["deepseek-7b", "moe"])
def test_shapes_of_the_configuration_files(name):
    s = counts.Shapes.from_config(portbench_cells.config_of(name))
    total = s.layers * counts.layer_matmul_params(s) + 2 * s.d * s.vocab
    if name == "deepseek-7b":
        assert (s.layers, s.d, s.heads, s.head_dim, s.d_ff, s.vocab) == (30, 4096, 32, 128,
                                                                          11008, 102400)
        assert 6.9e9 < total < 6.95e9
    else:
        assert (s.experts, s.top_k, s.d_ff_expert, s.vocab) == (64, 8, 1024, 102400)
        assert s.layers * counts.layer_matmul_params(s) == 30 * (4 * 4096 * 4096 + 4096 * 64
                                                                 + 8 * 3 * 4096 * 1024)
