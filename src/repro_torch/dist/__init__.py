"""``repro_torch.dist`` — the distribution subsystem, a port of
``repro.dist``. Three orthogonal pieces:

  * :mod:`repro_torch.dist.sharding` — partition specs for parameters,
    batches, KV caches and paged pools (path-pattern rules + divisibility
    tightening, on a ``DeviceMesh`` or a device-free ``MeshShape``), and
    their DTensor placements;
  * :mod:`repro_torch.dist.context` — context-local activation-sharding
    rules; model code calls ``constrain(x, role)``, a no-op unless a rules
    context is installed;
  * :mod:`repro_torch.dist.compression` — blockwise int8 quantization, the
    error-feedback compressed gradient all-reduce, and the per-vector int8
    of the KV caches.
"""

from repro_torch.dist import compression, context, sharding
from repro_torch.dist.compression import (
    dequantize_int8,
    dequantize_int8_vec,
    init_residuals,
    quantize_int8,
    quantize_int8_vec,
    reduce_grads_compressed,
)
from repro_torch.dist.context import activation_rules, constrain
from repro_torch.dist.sharding import (
    MeshShape,
    P,
    batch_shardings,
    batch_spec,
    cache_shardings,
    param_shardings,
    param_specs,
    pool_shardings,
    spec_for,
    tighten,
)

__all__ = [
    "sharding",
    "context",
    "compression",
    "P",
    "MeshShape",
    "tighten",
    "spec_for",
    "param_specs",
    "param_shardings",
    "batch_spec",
    "batch_shardings",
    "cache_shardings",
    "pool_shardings",
    "activation_rules",
    "constrain",
    "quantize_int8",
    "dequantize_int8",
    "quantize_int8_vec",
    "dequantize_int8_vec",
    "init_residuals",
    "reduce_grads_compressed",
]
