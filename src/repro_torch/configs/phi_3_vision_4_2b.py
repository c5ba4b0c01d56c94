"""Phi-3-vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct]: phi3-mini
backbone 32L d3072 32H (kv=32) d_ff=8192, vocab 32064 + CLIP frontend.
Frontend is a stub: input_specs() provides precomputed patch embeddings."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4_2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    n_prefix_embeds=1024,   # ~1 image of CLIP-L/14 patches at 576px
    rope_theta=10000.0,
    param_dtype="bfloat16",
)
