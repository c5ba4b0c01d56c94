"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit). Every roofline share and MFU of the benchmark is taken
against these."""

PEAK_BF16_FLOPS = 989e12     # FLOP/s, bf16 on the tensor cores
PEAK_HBM_BYTES = 3.35e12     # B/s, HBM3
BF16_BYTES = 2
