"""``repro_torch.dist`` — the distribution subsystem's port. So far only
the per-vector int8 quantization of the KV caches
(``compression.quantize_int8_vec``); the blockwise wire format, the
compressed all-reduce, sharding and the activation rules come with the
sharded paths (ROADMAP §A14)."""

from repro_torch.dist.compression import dequantize_int8_vec, quantize_int8_vec

__all__ = ["quantize_int8_vec", "dequantize_int8_vec"]
