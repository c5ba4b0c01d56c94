"""DeepSeek-7B [arXiv:2401.02954; hf]: 30L d4096 32H (kv=32, i.e. MHA)
d_ff=11008, vocab 102400, llama-arch."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    rope_theta=10000.0,
    param_dtype="bfloat16",
)
