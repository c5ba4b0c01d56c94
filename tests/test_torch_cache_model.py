"""The port's analytic L2 model (``repro_torch.core.cache_model``) against
the JAX package's: the reference's cases of ``tests/test_cache_model.py``
run through both packages, every figure equal to the reference's in float64
(the model computes in Python floats), and the port's H100 config and the
one read from the card's properties."""

import dataclasses

import pytest

pytest.importorskip("torch")

import torch

from repro.core import cache_model as ref_cm
from repro_torch.core import cache_model as port_cm

PAPER_TABLE1 = {32 * 1024: 107_729_467, 128 * 1024: 1_723_556_561}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(params=["reference", "port"])
def cm(request):
    return ref_cm if request.param == "reference" else port_cm


@pytest.mark.parametrize("seq,measured", sorted(PAPER_TABLE1.items()))
def test_model_matches_paper_table1(cm, seq, measured):
    w = cm.AttentionWorkload(seq_len=seq, tile=80)
    predicted = cm.l2_sector_accesses(w, cm.GB10)
    assert abs(predicted - measured) / measured < 0.006, (seq, predicted, measured)


def test_simple_form_matches_paper_closed_form(cm):
    for s in (8192, 32768, 131072):
        w = cm.AttentionWorkload(seq_len=s, tile=80)
        assert cm.l2_sector_accesses_simple(w, cm.GB10) == pytest.approx(8 * s * (1 + s / 80))


def test_causal_roughly_half_noncausal(cm):
    w_nc = cm.AttentionWorkload(seq_len=65536, tile=64, causal=False)
    w_c = cm.AttentionWorkload(seq_len=65536, tile=64, causal=True)
    ratio = cm.l2_sector_accesses(w_c, cm.GB10) / cm.l2_sector_accesses(w_nc, cm.GB10)
    assert 0.45 < ratio < 0.55


def test_cold_miss_is_16s(cm):
    w = cm.AttentionWorkload(seq_len=32768, tile=80)
    assert cm.cold_miss_sectors(w, cm.GB10) == 16 * 32768


def test_divergence_near_80k(cm):
    w = cm.AttentionWorkload(seq_len=1, tile=80)
    assert 80_000 <= cm.divergence_seq_len(cm.GB10, w) <= 120_000


def test_batch_heads_scale_linearly(cm):
    w1 = cm.AttentionWorkload(seq_len=16384, tile=64)
    w8 = cm.AttentionWorkload(seq_len=16384, tile=64, batch=4, heads=2)
    assert cm.l2_sector_accesses(w8, cm.GB10) == 8 * cm.l2_sector_accesses(w1, cm.GB10)


def test_throughput_model_monotone_in_misses(cm):
    w = cm.AttentionWorkload(seq_len=131072, tile=64, batch=8)
    svc = cm.calibrate_miss_service(w, cm.GB10, observed_flops=61e12, miss_sectors=370e6)
    hi = cm.gb10_throughput_model(w, cm.GB10, miss_sectors=370e6, miss_service_s=svc)
    lo = cm.gb10_throughput_model(w, cm.GB10, miss_sectors=120e6, miss_service_s=svc)
    assert lo > hi
    assert hi == pytest.approx(61e12, rel=1e-6)
    assert cm.attention_flops(w) > 0
    assert cm.kv_bytes(w) == 8 * 2 * 131072 * 64 * 2


def test_throughput_model_reproduces_cutile_regime(cm):
    w = cm.AttentionWorkload(seq_len=131072, tile=64, head_dim=64, batch=8)
    svc = cm.calibrate_miss_service(w, cm.GB10, observed_flops=61e12, miss_sectors=370e6,
                                    kernel_peak=74e12)
    predicted = cm.gb10_throughput_model(w, cm.GB10, miss_sectors=120e6, miss_service_s=svc,
                                         kernel_peak=74e12)
    assert 66e12 < predicted < 72e12, predicted / 1e12


# ---- the port equals the reference, figure for figure ----------------------------


WORKLOADS = [
    dict(seq_len=4096, tile=64),
    dict(seq_len=32768, tile=80, causal=True),
    dict(seq_len=1000, head_dim=128, tile=128, batch=3, heads=5),
    dict(seq_len=77, head_dim=80, elem_bytes=4, tile=16, causal=True),
]


@pytest.mark.parametrize("kw", WORKLOADS)
def test_every_function_equals_reference(kw):
    rw, pw = ref_cm.AttentionWorkload(**kw), port_cm.AttentionWorkload(**kw)
    assert (pw.n_tiles, pw.scale()) == (rw.n_tiles, rw.scale())
    assert dataclasses.asdict(port_cm.GB10) == dataclasses.asdict(ref_cm.GB10)
    rh, ph = ref_cm.GB10, port_cm.GB10
    for name in ("sectors_per_tile", "l2_sector_accesses", "l2_sector_accesses_simple",
                 "cold_miss_sectors"):
        assert getattr(port_cm, name)(pw, ph) == getattr(ref_cm, name)(rw, rh), name
    assert port_cm.kv_bytes(pw) == ref_cm.kv_bytes(rw)
    assert port_cm.attention_flops(pw) == ref_cm.attention_flops(rw)
    assert port_cm.divergence_seq_len(ph, pw) == ref_cm.divergence_seq_len(rh, rw)
    for n in (1, 48, 132):
        assert port_cm.l2_hit_rate_wavefront(n) == ref_cm.l2_hit_rate_wavefront(n)
    for peak in (None, 74e12):
        svc_r = ref_cm.calibrate_miss_service(rw, rh, observed_flops=3e12, miss_sectors=5e6,
                                              kernel_peak=peak)
        svc_p = port_cm.calibrate_miss_service(pw, ph, observed_flops=3e12, miss_sectors=5e6,
                                               kernel_peak=peak)
        assert svc_p == svc_r
        assert port_cm.gb10_throughput_model(pw, ph, 2e6, miss_service_s=svc_p,
                                             kernel_peak=peak) == \
            ref_cm.gb10_throughput_model(rw, rh, 2e6, miss_service_s=svc_r, kernel_peak=peak)
    with pytest.raises(ValueError):
        port_cm.l2_hit_rate_wavefront(0)


def test_h100_config_and_the_card_reading(monkeypatch):
    """The data-sheet H100 (132 SMs, 50 MiB L2, 32-byte sectors, 3.35 TB/s,
    989 TFLOP/s bf16) and ``device_hw_config``, which takes the SM count
    and L2 size from ``torch.cuda.get_device_properties``."""
    h = port_cm.H100
    assert (h.n_workers, h.cache_bytes, h.sector_bytes) == (132, 52_428_800, 32)
    assert (h.mem_bandwidth, h.peak_flops) == (3.35e12, 989e12)
    assert not hasattr(port_cm, "TPU_V5E_DMA")

    class Props:
        name = "NVIDIA H100 80GB HBM3"
        multi_processor_count = 114
        L2_cache_size = 50 * 2**20

    seen = []
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: seen.append(d) or Props)
    hw = port_cm.device_hw_config(3)
    assert seen == [3]
    assert (hw.name, hw.n_workers, hw.cache_bytes) == (Props.name, 114, 50 * 2**20)
    assert (hw.sector_bytes, hw.mem_bandwidth, hw.peak_flops) == (32, 3.35e12, 989e12)
    # A divergence point at the card's L2: deepseek's 32 kv heads of 128.
    w = port_cm.AttentionWorkload(seq_len=1, head_dim=128, heads=32)
    assert port_cm.divergence_seq_len(h, w) == 52_428_800 // (32 * 2 * 128 * 2)
