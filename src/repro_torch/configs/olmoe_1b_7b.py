"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L d2048 16H (GQA kv=16) MoE 64e top-8,
d_ff_expert=1024, vocab 50304.

``CONFIG`` is the reference's (``repro.configs.olmoe_1b_7b``): Mixtral's
routing, no q/k norm. ``PUBLISHED`` is the model as allenai/OLMoE-1B-7B-0924
publishes it (config.json: ``norm_topk_prob`` false, q/k RMSNorm over the
whole projections, ``rms_norm_eps`` 1e-5, ``eos_token_id`` 50279), served
under the port-only id ``olmoe-1b-7b-0924``."""

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    rope_theta=10000.0,
    param_dtype="bfloat16",
)

PUBLISHED = CONFIG.with_(
    name="olmoe-1b-7b-0924",
    moe=dataclasses.replace(CONFIG.moe, norm_topk_prob=False),
    qk_norm=True,
    norm_eps=1e-5,
    eos_id=50279,
)
