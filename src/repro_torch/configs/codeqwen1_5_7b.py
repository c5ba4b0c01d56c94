"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: 32L d4096 32H (kv=32) d_ff=13440,
vocab 92416, qwen1.5-arch (QKV bias)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1_5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    rope_theta=1000000.0,
    param_dtype="bfloat16",
)
