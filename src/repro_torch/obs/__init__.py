"""``repro_torch.obs`` — metrics registry, span traces and the JSONL sink
the serve engine records into (copies of ``repro.obs`` modules)."""

from repro_torch.obs.export import SCHEMA_VERSION, metric_records, write_metrics_jsonl
from repro_torch.obs.metrics import LATENCY_BUCKETS_S, Counter, Gauge, Histogram, Registry
from repro_torch.obs.trace import SpanEvent, Tracer

__all__ = [
    "SCHEMA_VERSION",
    "metric_records",
    "write_metrics_jsonl",
    "LATENCY_BUCKETS_S",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "SpanEvent",
    "Tracer",
]
