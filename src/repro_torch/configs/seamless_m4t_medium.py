"""SeamlessM4T-medium [arXiv:2308.11596; hf]: enc-dec, 12L enc + 12L dec,
d1024 16H (kv=16) d_ff=4096, vocab 256206. Modality frontend is a stub:
input_specs() provides precomputed frame embeddings (assignment rule)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    param_dtype="bfloat16",
)
