"""``repro_torch.obs`` — metrics registry, span traces, the JSONL sink the
serve engine records into, the autotune-cache reader and the live
modeled-LLC sampler (copies of ``repro.obs`` modules)."""

from repro_torch.obs.autotune import (
    canonicalize_key,
    load_autotune_cache,
    lookup_order_winner,
    normalize_autotune_key,
)
from repro_torch.obs.export import (
    SCHEMA_VERSION,
    append_jsonl,
    load_jsonl,
    metric_records,
    write_metrics_jsonl,
)
from repro_torch.obs.llc import DEFAULT_CAPACITY_BYTES, LLCSampler
from repro_torch.obs.metrics import LATENCY_BUCKETS_S, Counter, Gauge, Histogram, Registry
from repro_torch.obs.trace import SpanEvent, Tracer

__all__ = [
    "SCHEMA_VERSION",
    "append_jsonl",
    "load_jsonl",
    "metric_records",
    "write_metrics_jsonl",
    "canonicalize_key",
    "load_autotune_cache",
    "lookup_order_winner",
    "normalize_autotune_key",
    "DEFAULT_CAPACITY_BYTES",
    "LLCSampler",
    "LATENCY_BUCKETS_S",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "SpanEvent",
    "Tracer",
]
