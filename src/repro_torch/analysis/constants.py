"""Target-hardware constants (one NVIDIA H100 SXM) for the roofline
analysis, in place of the reference's TPU v5e numbers.

Every value is the data sheet's, not a measurement: the dense bf16 rate
and the HBM bandwidth are ``core.cache_model.H100``'s (the same numbers
PERF.md's kernel bounds use), read from there so the two cannot drift;
NVLink 4 carries 900 GB/s a card in both directions together, 450 GB/s each
way; the card holds 80 GB of HBM3 and 228 KiB of shared memory an SM.
``chip_smoke.py`` holds the memory sizes to what
``torch.cuda.get_device_properties`` reports. No cross-chip collective has
been measured: the collective term divides bytes by the data-sheet link
rate.
"""

from repro_torch.core.cache_model import H100

PEAK_FLOPS_BF16 = H100.peak_flops      # 989e12 FLOP/s a card, dense bf16
HBM_BW = H100.mem_bandwidth            # 3.35e12 bytes/s a card
NVLINK_BW = 450e9                      # bytes/s a card, one direction (NVLink 4)
CHIP_HBM_BYTES = 80 * 2**30            # "80 GB" of HBM3
SMEM_PER_SM_BYTES = 228 * 2**10        # shared memory an SM (227 KiB to one block)
