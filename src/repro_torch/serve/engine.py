"""Batched serving engine: the static fixed-group path and continuous
batching over a shared paged KV pool.

A port of ``repro.serve.engine.ServeEngine``'s two schedulers.

``scheduler="static"`` (the default, as in the reference): requests are
taken ``batch_size`` at a time, left-padded with ``eos_id`` into one shared
prompt bucket (at most ``max_len``; a longer prompt keeps its tail), run
through ``LM.prefill`` into contiguous KV caches (SWA configs: ring
buffers), then decoded one token a step for the whole group until every
row has hit its EOS or its token limit (``max_len - bucket + 1`` at most).
As in the reference, SWA configs and the SSM family (whose decode state
does not grow) are not bounded by ``max_len``: any prompt, any limit.
As in the reference, every row's positions are ``0..bucket-1`` and the
pads are attended; decode writes at one shared position. The frontends are
the reference's stubs: an enc-dec group gets zero source embeddings of its
bucket, a VLM group 8 zero prefix embeddings before its tokens (``max_len``
less those 8 bounds the bucket and the limits). TTFT is measured
from engine start, so queueing behind earlier groups counts. The
``serve.prefill`` and ``serve.decode_step`` spans close once the sampled
tokens are on the host, so they bracket the device time of the step.

``scheduler="continuous"``: each iteration plans one ragged **mixed step**
(``serve.scheduler``): every
decoding slot contributes a q_len=1 row and the rest of the token budget
goes to prompts as prefill chunks. The step runs ``LM.decode_step`` over
the pool (``serve.kv_pool``), whose pages are written in place and walked
in the paper's traversal order. The order belongs to an
``OrderAdaptController`` (``serve.adapt``), which starts from
``cfg.attn_order``/``cfg.snake_group`` (or the autotune cache's winner) and,
with ``adapt_order=True``, re-picks it every ``adapt_epoch`` mixed steps
from the modeled-LLC readings of an ``LLCSampler`` (``obs.llc``) on the
live pool; every step stages the order's reversal group, resolved then.
A step has one of two widths: 1 when every row decodes, ``prefill_chunk``
otherwise. A wide step runs only its wide rows (``q_len > 1``: prompt
chunks, re-prefills, verification chunks) at the chunk width, in groups of
``R = clamp(ceil(WIDE_POSITIONS / prefill_chunk), 1, n_slots)`` rows, one
replay of the (R, chunk) compact step a group (one-token rows fill the
last group's spare rows), then the one-token rows left in one replay of the
narrow step (none when none is left: with n_slots <= R a wide step is one
replay, of the full-width step); the replays go back to back, and the host
waits once, for the step's tokens. Identical prompt prefixes share pages
(adoption + copy-on-write).

Steps as captured graphs (``serve.step_graph``), the counterpart of the
reference's jitted steps: on the card the continuous mixed step is one
CUDA graph per width (two at most, sharing one memory pool: the narrow
(n_slots, 1) step and the compact (R, chunk) step) and the static decode
step one graph per engine, each captured at its first use and replayed
for every step after; tokens, block table, lengths, q_lens and the
reversal group reach it through static buffers (a wide step's groups in
one copy, each moved into the compact step's buffers on the device before
its replay), and greedy argmax runs inside it. Each replay's tokens, and
the draws of its sampling rows, are copied into one buffer of the engine
before the next replay, and that buffer reaches the host in one copy. The
engine owns what a graph's pointers bake in: the pool's pages (its host
state is reset at each ``generate()``) and the static decode caches of
``max_len``, into which each group's prefill result is copied. The static prefill stays eager: its shape changes with each
group's bucket. On the CPU the same step functions run eagerly over the
same buffers. A failed capture or replay raises; nothing falls back to
eager.

Sampling is per row in both paths: greedy at temperature 0 (argmax in the
logits' dtype, first maximum on ties, as the reference), otherwise a
Gumbel-max draw from ``softmax(logits / T)`` with noise from a generator
seeded by a counter-based hash of (engine seed, request seed, sample
index); the request seed defaults to the submission index. The draws
cannot match ``jax.random``; a request's sampled stream depends only on
those three numbers, not on its slot or its neighbours.

Resilience, continuous path, as in the reference: ``admission=
"optimistic"`` reserves only prompts, so decode growth can oversubscribe
the pool; a ``PoolExhausted`` while a step is made writable preempts a
victim (``select_victim``), restored by a chunked re-prefill through the
same two mixed-step widths or failed past its preemption bound. A failed
step dispatch is retried once, then the step's rows fail. The pool is
written in place, so the retry relies on a step being idempotent: it
writes positions ``len..len+q_len`` that only it reads, and ``len``
advances on the host after success only. On the card a replay that fails
raises (a CUDA error is sticky; no retry could succeed). ``faults`` (a
``serve.faults.FaultPlan``) injects faults at planned steps.

Tiered KV memory, continuous path, as in the reference: ``host_pages``
puts a ``serve.tiering.TieredPagePool`` host tier under the device pool
(whose module describes it). At ``spill_watermark`` occupancy, and before
a preemption, the coldest slot is spilled and suspended; the slot the
pool lets resume (``TieredPagePool.next_resume``) gets its pages back
``prefetch_depth`` a boundary, beside the step in flight.

Speculative decoding, continuous path, as in the reference: ``drafter`` (a
``serve.spec.Drafter``, whose module describes it) proposes up to
``draft_len`` tokens a decode row once a step boundary, verified in one
``q_len = K+1`` chunk of the same two captured widths.

Sharded serving, as in the reference: with ``mesh`` (a
``torch.distributed`` ``DeviceMesh`` named ("data", "model")) the params
are placed on their ``dist.sharding`` specs as DTensors (default
``ParallelConfig(fsdp_axes=("data",), data_axes=("data",))``), and every
step runs on the mesh: the tokens are plain tensors each rank holds whole,
replicated implicitly; the continuous engine's pools are placed by
``dist.sharding.pool_shardings``, each rank holding, writing and reading
its own KV-head shard (the whole pool where the heads do not divide the
tensor axis; block tables, lengths and the scheduler's plans are the same
host state on every rank); the static engine's caches (the prefill's, and
those its captured decode step holds) are placed by
``dist.sharding.cache_shardings``, each rank holding its shard (batch on
the data axes, KV heads or else the sequence on the tensor axis); the
kernels run on each rank's local blocks (``kernels.ops``), and the logits
come back whole to every rank, which samples the same tokens. Every rank
of the mesh runs ``generate`` with the same requests. The steps stay
captured graphs on the card: DTensor dispatch runs on the host at
capture, and nothing in it reads a device value
(``tests/test_torch_dist.py`` and ``tests/test_torch_sharded_pools.py``
hold each sharded step to the host-read guard of
``tests/test_torch_step_graph.py``). The speculative drafter runs
unsharded, on its own params and pool.

Tracing (``obs.trace``; every run records it, nothing leaves the process
until the caller writes it out). Each step span (``serve.device_step``,
``serve.decode_step``, ``serve.prefill``) holds ``serve.stage`` (inputs
into staging, the copy enqueued), ``serve.replay`` (the graphs' launches;
the eager prefill's forward is ``serve.forward``) and ``serve.sync`` (the
host's wait for the tokens); ``serve.step`` also holds
``serve.admission`` and ``serve.commit`` (advance, record, finish, the
gauges). On the card a step span carries ``device_ns``, its window
between CUDA events (``step_graph.DeviceClock``), and ``gap_ns``, the
card's wait since the previous step's window (since ``generate()``'s
entry for the first): the events are read once done, after the next
step's launch and at the end of ``generate()``, so no wait is added.
``positions`` on ``serve.device_step`` (R x chunk a compact replay, plus
n_slots where the narrow step runs) and ``serve.prefill`` (rows x
bucket) count what the step computes beside its ``tokens``; a wide
``serve.device_step`` also carries ``replays`` (compact replays, plus 1
where the narrow step runs), which the counter ``serve.wide_replays``
sums. Each request leaves two instants: ``serve.request.admit``
(``rid``, ``slot``, ``wait_ns``: from when it became admissible, at its
arrival step's boundary or its preemption, to its admission; the static
path's group waits until its prefill starts) and
``serve.request.finish`` (``rid``, ``status``, ``token_ns``: each token's
arrival on the host in ns from ``generate()``'s entry, one clock reading
a step), which ``GenerationResult.queue_s`` and ``token_s`` repeat.

A MoE model served dropless (the grouped products) also runs every step
and prefill under an ``obs.moe.MoETally``: each MoE layer adds its group
sizes into the engine's device buffers (L, E) inside the step, the
captured graphs included (a capture's warm-up adds are taken back out).
They are zeroed at ``generate()``'s entry and read once at its end, after
its last sync, into the instant ``serve.moe`` (``layers``, ``launches``:
grouped products of one expert product, ``rows``: the sorted choices they
ran, pad positions counted, ``groups``: the non-empty expert groups,
``rows_max``: the largest (layer, expert) total) and the counters
``serve.moe.rows`` and ``serve.moe.groups``. A model without experts has
none of this.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.cache_sim import slot_reuse_stats
from repro_torch.core.schedule import future_visit_window
from repro_torch.device import resolve_device
from repro_torch.dist.context import gathered_on, local, on_mesh, whole
from repro_torch.models.model import LM, build_model
from repro_torch.obs.llc import DEFAULT_CAPACITY_BYTES, LLCSampler
from repro_torch.obs.metrics import Registry
from repro_torch.obs.moe import MoETally
from repro_torch.obs.trace import Tracer
from repro_torch.serve.adapt import OrderAdaptController
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.kv_pool import (
    AdmissionError,
    PagedKVPool,
    PoolExhausted,
    assemble_cache_view,
)
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.step_graph import DeviceClock, StepCaptureError, StepGraph
from repro_torch.serve.tiering import TieredPagePool, select_spill_victim

__all__ = [
    "Request",
    "GenerationResult",
    "StepStats",
    "ServeEngine",
    "CONTINUOUS_FAMILIES",
    "REQUEST_STATUSES",
    "supports_continuous",
    "select_victim",
    "sample_seed",
    "sample_token",
]

CONTINUOUS_FAMILIES = ("dense", "moe")
REQUEST_STATUSES = ("ok", "deadline", "cancelled", "shed", "failed")
# Positions one replay of the compact wide step computes, at most: it takes
# ceil(WIDE_POSITIONS / prefill_chunk) rows, so at a chunk of 256 its
# products run 2,048 rows, well above the card's ridge.
WIDE_POSITIONS = 2048


def supports_continuous(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` can serve under the continuous scheduler, the
    reference's predicate: a token-only full-attention family (the paged
    pool has no ring-buffer or recurrent-state layout)."""
    return cfg.family in CONTINUOUS_FAMILIES and cfg.window is None


@dataclasses.dataclass
class Request:
    tokens: np.ndarray            # prompt (1D int32)
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 = greedy
    rid: int = 0
    seed: Optional[int] = None    # sampling stream id; defaults to the
                                  # request's submission index
    eos_id: Optional[int] = None  # overrides ModelConfig.eos_id
    arrival: int = 0              # step arrival time
    deadline_s: Optional[float] = None
                                  # wall-clock budget from engine start,
                                  # checked at step boundaries
    priority: int = 0             # preemption shield: lower is preempted
                                  # first (admission stays FIFO)
    max_preemptions: Optional[int] = None
                                  # overrides the engine's bound before
                                  # status="failed"


@dataclasses.dataclass
class GenerationResult:
    rid: int
    tokens: np.ndarray            # generated tokens (without prompt)
    steps: int
    ttft_s: float = 0.0           # wall time, engine start -> first token
                                  # (token_s[0] where there is one)
    tpot_s: float = 0.0           # mean time per token after the first
                                  # (NaN when <= 1 token was generated)
    status: str = "ok"            # one of REQUEST_STATUSES
    n_preemptions: int = 0        # times preempted and restored
    queue_s: float = 0.0          # time admissible and waiting for a slot,
                                  # summed over its admissions
    token_s: tuple = ()           # each token's arrival on the host, from
                                  # engine start (one reading a step)


@dataclasses.dataclass
class StepStats:
    """Deterministic per-stream work counters of the continuous path (the
    fields the port can produce, named as the reference's)."""

    mixed_steps: int = 0          # ragged mixed steps dispatched
    wide_steps: int = 0           # steps at chunk width (any prefill row)
    pages_adopted: int = 0        # prefix pages adopted instead of computed
    prompt_tokens_adopted: int = 0
    cow_forks: int = 0
    preemptions: int = 0          # victim slots evicted under pool pressure
    restore_tokens: int = 0       # tokens re-prefilled by restores
    shed: int = 0
    deadline_miss: int = 0
    cancelled: int = 0
    failed: int = 0               # past the preemption bound, or a failed step
    spills: int = 0               # slots spilled to the host tier
    tier_fetches: int = 0         # host pages staged back on the device
    prefetch_hits: int = 0        # fetched pages the resumed row attended
    prefetch_wasted: int = 0      # fetched pages released before use
    draft_tokens: int = 0         # draft tokens verified
    accepted_tokens: int = 0      # drafts accepted (committed)
    rollback_tokens: int = 0      # drafts rejected and rolled back;
                                  # accepted + rollback == draft

    @property
    def acceptance_rate(self) -> float:
        """Accepted over verified draft tokens (NaN with no drafts)."""
        return self.accepted_tokens / self.draft_tokens if self.draft_tokens else math.nan

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def select_victim(candidates) -> int:
    """The preemption victim among ``candidates``, tuples ``(slot,
    priority, n_generated, shared_donor)``: the lowest priority, then a
    non-donor (releasing a prefix donor frees fewer pages than it holds),
    then the fewest generated tokens (the cheapest re-prefill), then the
    lowest slot."""
    return min(candidates, key=lambda c: (c[1], bool(c[3]), c[2], c[0]))[0]


def _tpot(elapsed_after_first: float, n_tok: int) -> float:
    return (elapsed_after_first / (n_tok - 1)) if n_tok > 1 else math.nan


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def sample_seed(engine_seed: int, seed: int, index: int) -> int:
    """Counter-based 63-bit seed of one draw: a hash of (engine seed,
    request seed, sample index), independent of slot and step."""
    h = _splitmix64(int(engine_seed) & _MASK64)
    h = _splitmix64(h ^ (int(seed) & _MASK64))
    h = _splitmix64(h ^ (int(index) & _MASK64))
    return h >> 1


def sample_token(logits: torch.Tensor, temperature: float, seed: int) -> torch.Tensor:
    """One draw from ``softmax(logits / T)`` (logits (V,)) by Gumbel-max,
    with noise from a generator on the logits' device seeded by ``seed``."""
    gen = torch.Generator(device=logits.device).manual_seed(int(seed))
    u = torch.rand(logits.shape, generator=gen, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20, max=1.0 - 1e-7)))
    return torch.argmax(logits.float() / max(float(temperature), 1e-6) + gumbel)


class ServeEngine:
    def __init__(
        self,
        lm: LM,
        params,
        *,
        batch_size: int = 8,
        max_len: int = 1024,
        seed: int = 0,
        scheduler: str = "static",
        page_size: Optional[int] = None,
        token_budget: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        prefix_sharing: bool = True,
        registry: Optional[Registry] = None,
        tracer: Optional[Tracer] = None,
        log_every_steps: int = 0,
        admission: str = "reserve",
        max_queue: Optional[int] = None,
        admit_watermark: Optional[float] = None,
        max_preemptions: int = 2,
        pool_pages: Optional[int] = None,
        faults: Optional[FaultPlan] = None,
        llc_every: int = 0,
        llc_capacity_bytes: Optional[float] = None,
        adapt_order: bool = False,
        adapt_epoch: int = 8,
        adapt_hysteresis: float = 0.05,
        adapt_confirm: int = 2,
        adapt_shared_threshold: float = 0.25,
        autotune_cache: Optional[str] = None,
        host_pages: Optional[int] = None,
        spill_watermark: Optional[float] = None,
        prefetch_depth: int = 2,
        drafter=None,
        draft_len: int = 4,
        device="cuda",
        mesh=None,
        pcfg: Optional[ParallelConfig] = None,
    ):
        """Serve ``lm`` with ``params`` on ``device`` (default ``"cuda"``;
        raises when no GPU is present unless ``device="cpu"`` is given).

        ``scheduler="static"`` serves fixed groups of ``batch_size`` through
        ``lm.prefill`` and ``lm.decode_step`` with caches of ``max_len``
        positions; the paged-pool options below do not apply to it.

        ``scheduler="continuous"`` rebuilds the model with the paged KV
        layout (``page_size`` pages, default ``kv_block``, capped at
        ``max_len``); ``token_budget`` tokens per step (default: one per
        slot plus one prefill chunk) are split across decode rows and
        ``prefill_chunk``-token prompt chunks (default: 4 pages).
        ``prefix_sharing=False`` disables page dedup. ``max_queue`` sheds the
        newest arrived requests beyond it; ``admit_watermark`` pauses
        admission at that pool occupancy (default 0.9 under optimistic
        admission, 1.0, never, under reserve). Metrics go to ``registry``
        and spans to ``tracer`` (fresh per engine by default).

        Continuous only: ``admission="optimistic"`` reserves only prompts,
        and pool pressure preempts a slot, which is restored by re-prefill
        at most ``max_preemptions`` times (``Request.max_preemptions``
        overrides it) before it fails; ``pool_pages`` sets the pool's
        allocatable pages below every slot's worst case, the knob that
        makes real pressure reachable. ``faults`` attaches a ``FaultPlan``
        (the engine's attribute; a plan set after a warm-up serves the
        next ``generate()``).

        Continuous only: ``llc_every > 0`` samples the modeled-LLC gauges
        (``llc.*``) every that many mixed steps, at a modeled capacity of
        ``llc_capacity_bytes`` (default ``obs.llc.DEFAULT_CAPACITY_BYTES``).
        ``adapt_order=True`` lets the ``OrderAdaptController`` re-pick the
        traversal order every ``adapt_epoch`` mixed steps: a switch needs at
        least ``adapt_hysteresis`` fractional modeled-byte improvement on
        ``adapt_confirm`` consecutive samples, the shared-prefix model is
        blended in above a shared-page fraction of
        ``adapt_shared_threshold``, and ``autotune_cache`` (an
        ``autotune_cache.jsonl`` path) seeds the first order.

        Continuous only: ``host_pages > 0`` backs the pool with a host tier
        of that many pages (``serve.tiering``); at ``spill_watermark``
        occupancy (default ``min(0.85, admit_watermark)``) the coldest slot
        is spilled, and a resuming slot's pages come back
        ``prefetch_depth`` a boundary. ``drafter`` (a ``serve.spec.Drafter``)
        turns on speculative decoding with up to ``draft_len`` drafts a
        row.

        ``mesh`` (a ``DeviceMesh``) serves sharded: ``params`` (whole, the
        same on every rank) are placed on their specs under ``pcfg``
        (default ``ParallelConfig(fsdp_axes=("data",),
        data_axes=("data",))``, the reference's), and the continuous pools
        on their KV heads (``dist.sharding.pool_shardings``)."""
        if scheduler not in ("static", "continuous"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if drafter is not None and scheduler != "continuous":
            raise ValueError("speculative decoding requires scheduler='continuous'")
        if draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {draft_len}")
        if admission not in ("reserve", "optimistic"):
            raise AdmissionError(f"unknown admission discipline {admission!r}")
        self.device = resolve_device(device)
        if lm.device != self.device:
            raise ValueError(f"model built on {lm.device}, engine asked for {self.device}")
        cfg = lm.cfg
        if scheduler == "continuous" and not supports_continuous(cfg):
            raise ValueError(
                "continuous scheduling needs a token-only full-attention "
                f"family {CONTINUOUS_FAMILIES} (got family={cfg.family!r}, "
                f"window={cfg.window}); use scheduler='static'"
            )
        # The cache capacity model, as in the reference: prefill writes the
        # bucket and the VLM's prefix embeddings, which go before it. Only
        # full-attention caches are max_len-bounded: sliding-window configs
        # decode into a ring buffer and an SSM's decode state is O(1). (The
        # hybrid has full-attention caches.)
        self._prefix = min(cfg.n_prefix_embeds, 8) if cfg.family == "vlm" else 0
        bounded = scheduler == "continuous" or (cfg.window is None and cfg.family != "ssm")
        if bounded and max_len <= self._prefix:
            detail = (f"the {self._prefix} VLM prefix embeddings leave no room" if self._prefix
                      else "it must be positive")
            raise ValueError(
                f"max_len={max_len} gives a zero-capacity KV cache ({detail}); "
                f"use max_len > {self._prefix}"
            )
        if scheduler == "continuous":
            page = min(page_size or cfg.page_size or cfg.kv_block, max_len)
            self.lm = build_model(cfg.with_(kv_layout="paged", page_size=page), device=self.device)
            self._page = page
            self._chunk = max(1, min(prefill_chunk or 4 * page, max_len))
            # The compact wide step's rows, and the groups a step can need.
            self._rows = max(1, min(-(-WIDE_POSITIONS // self._chunk), batch_size))
            self._groups = -(-batch_size // self._rows)
        else:
            self.lm = lm
        self._budget = token_budget
        self.scheduler = scheduler
        self.mesh = mesh
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            from repro_torch.dist import sharding as shd

            if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names is None:
                raise TypeError(f"mesh must be a torch.distributed DeviceMesh with named dims "
                                f"(mesh_dim_names), got {type(mesh).__name__}")
            pcfg = pcfg or ParallelConfig(fsdp_axes=("data",), data_axes=("data",))
            params = shd.distribute(params, shd.param_specs(params, pcfg, mesh), mesh)
            # a batch the data axes do not divide runs whole on each of them
            params = gathered_on(params, shd.batch_replica_axes(batch_size, pcfg, mesh))
        self.pcfg = pcfg
        self.params = params
        self.eos = cfg.eos_id
        self.prefix_sharing = prefix_sharing
        self.admission = admission
        self.max_queue = max_queue
        self.max_preemptions = max_preemptions
        self.pool_pages = pool_pages
        self.faults = faults
        if admit_watermark is None:
            admit_watermark = 0.9 if admission == "optimistic" else 1.0
        self._watermark = admit_watermark
        if spill_watermark is not None and not 0.0 < spill_watermark <= 1.0:
            raise ValueError(f"spill_watermark must be in (0, 1], got {spill_watermark}")
        self.host_pages = host_pages
        self.prefetch_depth = max(1, int(prefetch_depth))
        self._spill_wm = (spill_watermark if spill_watermark is not None
                          else min(0.85, self._watermark))
        self.drafter = drafter
        self.draft_len = int(draft_len)
        self._cap = max_len - self._prefix if bounded else None
        self._cancelled: set[int] = set()
        self.batch_size = batch_size
        self.max_len = max_len
        self.seed = int(seed)
        # What outlives a generate() call, as the reference's jit cache
        # does: the captured steps and the buffers their pointers bake in.
        self._mixed: dict[int, StepGraph] = {}     # continuous, by width
        self._decode: Optional[StepGraph] = None   # static decode step
        self._decode_caches: Optional[dict] = None
        self._graph_pool = None
        # Each mixed step's tokens, one copy to the host: the narrow step's
        # (n_slots,) then each compact group's (R, chunk).
        if scheduler == "continuous":
            self._mixed_out = torch.zeros(batch_size + self._groups * self._rows * self._chunk,
                                          dtype=torch.int32, device=self.device)
            self._narrow_out = self._mixed_out[:batch_size].view(batch_size, 1)
            self._slot_ids = np.arange(batch_size)
        self.last_pool: Optional[PagedKVPool] = None
        # Every step's window on the card (the step spans' device_ns and
        # gap_ns), one clock across the engine's graphs and its prefill.
        self._clock = DeviceClock(self.device)

        # ---- telemetry (same series names as the reference engine) ----
        self.obs = registry if registry is not None else Registry()
        self.tracer = tracer if tracer is not None else Tracer()
        self._log_every = log_every_steps
        self.last_stats: Optional[StepStats] = None
        r = self.obs
        self._m_tok_decode = r.counter("serve.step.tokens", kind="decode")
        self._m_tok_prefill = r.counter("serve.step.tokens", kind="prefill")
        self._m_generated = r.counter("serve.tokens.generated")
        self._m_steps_wide = r.counter("serve.steps", width="wide")
        self._m_steps_narrow = r.counter("serve.steps", width="narrow")
        self._m_wide_replays = r.counter("serve.wide_replays")
        self._m_req_admitted = r.counter("serve.requests", event="admitted")
        self._m_req_finished = r.counter("serve.requests", event="finished")
        self._m_req_requeued = r.counter("serve.requests", event="requeued")
        self._m_compiles = r.counter("serve.compiles")
        self._m_ttft = r.histogram("serve.ttft_s")
        self._m_tpot = r.histogram("serve.tpot_s")
        self._m_step_time = r.histogram("serve.step_time_s")
        self._m_queue = r.gauge("serve.queue_depth")
        self._m_active = r.gauge("serve.active_slots")
        self._m_budget = r.gauge("serve.budget_utilization")
        self._m_preempt = r.counter("serve.preemptions")
        self._m_restore_tok = r.counter("serve.restore_tokens")
        self._m_retries = r.counter("serve.step_retries")
        self._m_status = {status: r.counter(name) for status, name in (  # but "ok"
            ("shed", "serve.shed"), ("deadline", "serve.deadline_miss"),
            ("cancelled", "serve.cancelled"), ("failed", "serve.failed"))}
        self._m_admit_paused = r.gauge("serve.admission_paused")
        # The speculative and tier series exist on every engine, at zero
        # where nothing drafts or spills (the tiered pool increments the
        # tier.* counters).
        self._m_draft_tok = r.counter("serve.spec.draft_tokens")
        self._m_accept_tok = r.counter("serve.spec.accepted_tokens")
        self._m_rollback_tok = r.counter("serve.spec.rollback_tokens")
        for name in ("tier.spills", "tier.fetches", "tier.prefetch_hits", "tier.prefetch_wasted",
                     "tier.fetch_failures", "tier.spill_bytes", "tier.fetch_bytes"):
            r.counter(name)
        for name in ("tier.host_pages", "tier.device_pages", "tier.suspended_slots",
                     "tier.overlap_frac"):
            r.gauge(name)
        # The expert layer's counters: a dropless MoE only.
        self._moe: Optional[MoETally] = None
        if cfg.moe is not None and cfg.moe_serve_dropless:
            self._moe = MoETally(cfg.n_layers, cfg.moe.num_experts, device=self.device)
            self._m_moe_rows = r.counter("serve.moe.rows")
            self._m_moe_groups = r.counter("serve.moe.groups")
        self.llc: Optional[LLCSampler] = None
        self.order_ctl: Optional[OrderAdaptController] = None
        if scheduler == "continuous":
            elem_bytes = (1 if cfg.kv_cache_dtype == "int8"
                          else torch.empty((), dtype=cfg.activation_dtype()).element_size())
            capacity = llc_capacity_bytes or DEFAULT_CAPACITY_BYTES
            # The controller owns the live (order, snake_group) pair also
            # when adaptation is off, so serve.current_order and
            # serve.order_switches exist on every continuous engine and the
            # staged reversal group has one source.
            self.order_ctl = OrderAdaptController(
                self.obs, order=cfg.attn_order, snake_group=cfg.snake_group,
                epoch=adapt_epoch, hysteresis=adapt_hysteresis, confirm=adapt_confirm,
                shared_threshold=adapt_shared_threshold, enabled=adapt_order,
            )
            if adapt_order and autotune_cache:
                self.order_ctl.seed_from_cache(
                    autotune_cache, arch=cfg.name, seq_bucket=max_len,
                    capacity_mib=capacity / 2**20,
                    backend="gpu" if self.device.type == "cuda" else "cpu",
                )
            self.llc = LLCSampler(
                self.obs, page=self._page, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.hd, elem_bytes=elem_bytes,
                current_order=self.order_ctl.order.value,
                snake_group=self.order_ctl.snake_group, every=llc_every,
                capacity_bytes=capacity,
                **({"orders": self.order_ctl.candidate_orders} if adapt_order else {}),
            )

    def cancel(self, rid: int) -> None:
        """Retire request ``rid`` at the next step boundary with
        ``status="cancelled"`` (unknown rids are remembered)."""
        self._cancelled.add(int(rid))

    def _eos_for(self, r: Request) -> int:
        return self.eos if r.eos_id is None else r.eos_id

    def generate(self, requests: Sequence[Request]) -> list[GenerationResult]:
        self._clock.start()  # the first step's gap_ns counts from here
        if self._moe is not None:
            self._moe.zero()
        if self.scheduler == "continuous":
            results = self._generate_continuous(requests)
        else:
            results = []
            t0 = time.perf_counter_ns()  # TTFT includes queueing behind earlier groups
            for i in range(0, len(requests), self.batch_size):
                group = list(requests[i : i + self.batch_size])
                results.extend(self._generate_batch(group, base_idx=i, t0=t0))
        self._clock.read()  # the last steps' windows: their tokens are on the host
        if self._moe is not None:
            got = self._moe.read()
            self.tracer.instant("serve.moe", **got)
            self._m_moe_rows.inc(got["rows"])
            self._m_moe_groups.inc(got["groups"])
        return results

    def compiled_step_count(self) -> int:
        """Step graphs the engine holds, over its whole life: continuous, one
        per mixed-step width used (at most two: 1 and the chunk width, the
        latter the compact step of R rows);
        static, the decode step (at most one). The counterpart of the
        reference's compiled variants. On the CPU they are the same steps'
        buffers, run eagerly."""
        return len(self._mixed) + (self._decode is not None)

    def step_graphs(self) -> dict:
        """The engine's steps by name: ``"mixed/<width>"`` and ``"decode"``."""
        out = {f"mixed/{w}": g for w, g in sorted(self._mixed.items())}
        if self._decode is not None:
            out["decode"] = self._decode
        return out

    def _tally(self):
        """The block a step or prefill runs its model in: the expert
        counters' recording (a dropless MoE), else nothing."""
        return self._moe.recording() if self._moe is not None else contextlib.nullcontext()

    def _capture(self, step: StepGraph) -> None:
        """Capture ``step``; the counts its warm-up run added are taken
        back out (the capture itself runs nothing)."""
        saved = self._moe.snapshot() if self._moe is not None else None
        step.capture()
        if saved is not None:
            self._moe.restore(saved)

    def _new_step(self, name: str, fn, inputs: dict, state, groups: int = 0) -> StepGraph:
        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        step = StepGraph(name, fn, inputs, device=self.device, state=state,
                         pool=self._graph_pool, clock=self._clock, groups=groups)
        self._m_compiles.inc()
        self.tracer.instant("serve.compile", step=name, variants=self.compiled_step_count() + 1)
        return step

    def _record_result(self, res: GenerationResult) -> None:
        self._m_req_finished.inc()
        self._m_generated.inc(res.steps)
        if res.status == "ok":
            self._m_ttft.observe(res.ttft_s)
            self._m_tpot.observe(res.tpot_s)
        else:
            self._m_status[res.status].inc()

    # ---- static path ---------------------------------------------------------

    def _pad_batch(self, prompts: Sequence[np.ndarray], max_bucket: Optional[int]) -> np.ndarray:
        """(batch_size, bucket) prompts left-padded with EOS into one shared
        bucket: the longest prompt, capped at ``max_bucket`` (an overlong
        prompt keeps its most recent tokens); all-empty -> one pad."""
        length = max(1, max(len(p) for p in prompts))
        if max_bucket is not None:
            length = min(length, max_bucket)
        out = np.full((self.batch_size, length), self.eos, np.int32)
        for i, p in enumerate(prompts):
            p = np.asarray(p, np.int32)[-length:]
            out[i, length - len(p) :] = p
        return out

    def _sample(self, logits: torch.Tensor, greedy: torch.Tensor, temps: np.ndarray,
                seeds: np.ndarray, count: int) -> np.ndarray:
        """One token per row of logits (B, V), as a host array: ``greedy``
        (their int32 argmax) where the temperature is 0, else a draw with
        sample index ``count``."""
        rows = np.flatnonzero(temps > 0.0)
        if len(rows):
            greedy = greedy.clone()
            for b in rows:
                greedy[b] = sample_token(logits[b], float(temps[b]),
                                         sample_seed(self.seed, seeds[b], count))
        return greedy.cpu().numpy()

    def _prefill_batch(self, tokens: np.ndarray) -> dict:
        """``LM.prefill``'s batch for the padded prompts (B, bucket), with the
        reference's stubs for the frontends: enc-dec gets zero
        ``src_embeds`` (B, bucket, d) as its source, the VLM zero
        ``prefix_embeds`` (B, prefix, d) before its tokens."""
        cfg = self.lm.cfg
        t = torch.as_tensor(tokens, device=self.device)
        kw = dict(dtype=cfg.activation_dtype(), device=self.device)
        if cfg.family == "encdec":
            return {"src_embeds": torch.zeros(t.shape + (cfg.d_model,), **kw), "tgt_tokens": t}
        if cfg.family == "vlm":
            pe = torch.zeros((t.shape[0], self._prefix, cfg.d_model), **kw)
            return {"tokens": t, "prefix_embeds": pe}
        return {"tokens": t}

    def _decode_step(self, caches: dict) -> StepGraph:
        """The static decode step over the engine's own caches, holding
        ``caches`` (a group's prefill result) from now on. The first call
        allocates the caches in their shapes and captures the step before
        the copy, so its warm-up writes land in buffers the copy
        overwrites."""
        if self._decode is None:
            self._decode_caches = _tree_map(torch.zeros_like, caches)
            # the step's state as the graph writes it: each rank's own shard
            # of a placed cache (its local tensor, the same memory)
            state = [local(t) for t in _tree_leaves(self._decode_caches)]
            step = self._new_step("static decode step", self._decode_fn(self._decode_caches),
                                  {"tokens": (self.batch_size, 1)}, state)
            self._capture(step)
            self._decode = step
        # Copying the group's caches in is the first decode step's staging:
        # its device window opens here (the step's own staging keeps it).
        self._clock.begin()
        _copy_tree(self._decode_caches, caches)
        return self._decode

    def _decode_fn(self, caches: dict):
        def step(tokens):
            with on_mesh(self.mesh, pcfg=self.pcfg), self._tally():
                logits, new = self.lm.decode_step(self.params, tokens, caches)
                _copy_tree(caches, new)  # the advanced lengths, for the next replay
            last = whole(logits)[:, -1]
            return last, _argmax(last)
        return step

    @torch.no_grad()
    def _generate_batch(self, group: Sequence[Request], base_idx: int, t0: int):
        # A request whose limit exceeds what the shared bucket leaves of the
        # cache is clamped (visible via .steps), not failed. ``t0``:
        # generate()'s entry (perf_counter_ns), when every request arrived.
        cap = self._cap
        tokens = self._pad_batch([r.tokens for r in group], max_bucket=cap)
        bucket = tokens.shape[1]
        new_limits = [
            r.max_new_tokens if cap is None else max(0, min(r.max_new_tokens, cap - bucket + 1))
            for r in group
        ]
        max_new = max(new_limits)
        n = len(group)
        # Sampling parameters for every prefill row, padding rows included.
        temps = np.zeros((self.batch_size,), np.float32)
        seeds = np.zeros((self.batch_size,), np.int64)
        for j, r in enumerate(group):
            temps[j] = r.temperature
            seeds[j] = base_idx + j if r.seed is None else r.seed

        tr = self.tracer
        clock = self._clock
        # The group waited until its prefill starts.
        wait = time.perf_counter_ns() - t0
        for j, r in enumerate(group):
            tr.instant("serve.request.admit", rid=r.rid, slot=j, wait_ns=wait)
        # positions: what the prefill computes (pad rows and pads included);
        # tokens: the group's own prompt tokens in the bucket
        with tr.span("serve.prefill", rows=n, bucket=bucket, positions=tokens.size,
                     tokens=sum(min(len(r.tokens), bucket) for r in group)) as args:
            clock.into(args)
            clock.begin()
            with tr.span("serve.stage"):
                batch = self._prefill_batch(tokens)
            with tr.span("serve.forward"):
                with on_mesh(self.mesh, pcfg=self.pcfg), self._tally():
                    logits, caches = self.lm.prefill(self.params, batch, self.max_len)
                last = whole(logits)[:, -1]
                greedy = _argmax(last)
            clock.end()
            clock.read()  # the windows before, while the card runs this one
            with tr.span("serve.sync"):
                cur = self._sample(last, greedy, temps, seeds, 0)
            landed = prefilled = time.perf_counter_ns() - t0
            step = self._decode_step(caches)
            del logits, caches, batch
        self._m_tok_prefill.inc(n * bucket)
        generated = np.zeros((n, max_new), np.int32)
        token_ns: list[list[int]] = [[] for _ in range(n)]
        done = np.asarray([lim == 0 for lim in new_limits])  # 0-limit rows emit nothing
        steps = np.zeros(n, np.int32)
        status = ["ok"] * n
        eos_for = [self._eos_for(r) for r in group]
        for t in range(max_new):
            # Boundary checks before recording: a request cancelled or past
            # its deadline keeps only what it already has.
            now_s = (time.perf_counter_ns() - t0) / 1e9
            for j, r in enumerate(group):
                if done[j]:
                    continue
                if r.rid in self._cancelled:
                    done[j] = True
                    status[j] = "cancelled"
                    self._cancelled.discard(r.rid)
                elif r.deadline_s is not None and now_s > r.deadline_s:
                    done[j] = True
                    status[j] = "deadline"
            for j in range(n):
                if not done[j]:
                    generated[j, t] = cur[j]
                    token_ns[j].append(landed)
                    steps[j] = t + 1
                    if cur[j] == eos_for[j] or t + 1 >= new_limits[j]:
                        done[j] = True
            if done.all():
                break
            with tr.span("serve.decode_step", t=t) as args:
                clock.into(args)
                with tr.span("serve.stage"):
                    step.stage(tokens=cur[:, None])
                with tr.span("serve.replay"):
                    last, greedy = step()
                clock.read()
                with tr.span("serve.sync"):
                    cur = self._sample(last, greedy, temps, seeds, t + 1)
                landed = time.perf_counter_ns() - t0
            self._m_tok_decode.inc(int((~done).sum()))
        clock.end()  # the window _decode_step opened, where no decode step ran
        total = (time.perf_counter_ns() - t0) / 1e9

        results = []
        for j, r in enumerate(group):
            times = tuple(token_ns[j])
            ttft = (times[0] if times else prefilled) / 1e9
            results.append(GenerationResult(
                rid=r.rid,
                tokens=generated[j, : steps[j]].copy(),
                steps=int(steps[j]),
                ttft_s=ttft,
                tpot_s=_tpot(total - ttft, int(steps[j])),
                status=status[j],
                queue_s=wait / 1e9,
                token_s=tuple(x / 1e9 for x in times),
            ))
            tr.instant("serve.request.finish", rid=r.rid, status=status[j], token_ns=times)
        for res in results:
            self._record_result(res)
        return results

    # ---- the mixed step ------------------------------------------------------

    def _mixed_step(self, width: int, pool: PagedKVPool) -> StepGraph:
        """The mixed step of ``width`` over the engine's pool, created and
        captured at its first use: every input zeroed, so its warm-up
        writes only the dummy page 0. Width 1 runs every slot; the chunk
        width is the compact step, R rows, its inputs staged a group at a
        time."""
        step = self._mixed.get(width)
        if step is None:
            n = self.batch_size if width == 1 else self._rows
            step = self._new_step(
                f"mixed step (width {width})", self._mixed_fn(pool.pages),
                {"tokens": (n, width), "block_table": (n, pool.blocks_per_seq), "lens": (n,),
                 "q_lens": (n,), "order_group": ()},
                # This rank's pages but the dummy page 0: the invalid rows'
                # writes land there in no fixed order, and nothing reads them.
                [t[:, 1:] for t in pool.local_pages().values()],
                groups=0 if width == 1 else self._groups,
            )
            self._capture(step)
            self._mixed[width] = step
        return step

    def _mixed_fn(self, pages: dict):
        def step(tokens, block_table, lens, q_lens, order_group):
            caches = assemble_cache_view(pages, block_table, lens, q_lens, order_group)
            with on_mesh(self.mesh), self._tally():
                logits, _ = self.lm.decode_step(self.params, tokens, caches)
            logits = whole(logits)
            return logits, _argmax(logits)
        return step

    def _layout(self, width: int, qlens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Which replay runs each row of a step: ``(sel, narrow)``. ``sel``
        (groups, R): the slot row j of compact replay g serves (-1: none),
        the wide rows (``q_len > 1``) in slot order, then one-token rows in
        the last group's spare rows (computed there anyway); ``narrow``:
        the slots whose rows run the narrow step, the other one-token rows
        (every row at width 1)."""
        r = self._rows
        if width == 1:
            return np.zeros((0, r), np.int64), qlens > 0
        wide, ones = np.flatnonzero(qlens > 1), np.flatnonzero(qlens == 1)
        spare = -len(wide) % r
        packed = np.concatenate([wide, ones[:spare]])
        sel = np.full((-(-len(packed) // r) * r,), -1, np.int64)
        sel[:len(packed)] = packed
        narrow = np.zeros(len(qlens), bool)
        narrow[ones[spare:]] = True
        return sel.reshape(-1, r), narrow

    @torch.no_grad()
    def _run_mixed(self, width: int, tokens, pool, qlens, order_group, temps, seeds, counts,
                   lens, ladder, overlap=None) -> np.ndarray:
        """One ragged step: (n_slots, width) tokens over ``pool``'s block
        table and the staged lengths ``lens`` -> the sampled token at every
        chunk position, as a host array. At width 1 the narrow step runs
        every slot. Wider, the rows run as :meth:`_layout` lays them out:
        R at a time through the compact step, then the one-token rows left
        through the narrow step (not at all when none is left), every other
        row at ``q_len`` 0 there; a row at ``q_len`` 0 in a replay stages
        length 0, so it reads nothing. Greedy everywhere; a sampling row
        draws at its last valid position with sample index ``counts[row]``,
        a verification row (``ladder[row]``) at every position p with index
        ``counts[row] + p``. ``overlap`` is host work issued once the
        replays are launched, before the host waits for the tokens."""
        tr = self.tracer
        n = self.batch_size
        out = self._mixed_out
        sampling = (qlens, temps, seeds, counts, ladder)
        sel, narrow_rows = self._layout(width, qlens)
        n_groups, r = sel.shape
        on, src = sel >= 0, np.maximum(sel, 0)
        narrow = self._mixed_step(1, pool) if narrow_rows.any() else None
        with tr.span("serve.stage"):   # the step's device window opens here
            if n_groups:
                compact = self._mixed_step(width, pool)
                compact.stage_groups(
                    n_groups, tokens=np.where(on[..., None], tokens[src], self.eos),
                    block_table=np.where(on[..., None], pool.block_tables[src], 0),
                    lens=np.where(on, lens[src], 0), q_lens=np.where(on, qlens[src], 0),
                    order_group=order_group)
            if narrow is not None:
                narrow.stage(tokens=tokens[:, :1], block_table=pool.block_tables,
                             lens=np.where(narrow_rows, lens, 0),
                             q_lens=np.where(narrow_rows, qlens, 0), order_group=order_group)
        with tr.span("serve.replay"):
            for g in range(n_groups):
                compact.load(g)
                at = n + g * r * width
                self._replay(compact, sel[g], out[at:at + r * width].view(r, width), sampling)
            if narrow is not None:
                self._replay(narrow, np.where(narrow_rows, self._slot_ids, -1),
                             self._narrow_out, sampling)
            self._clock.end()
        self._clock.read()  # the windows before, while the card runs this one
        if overlap is not None:
            overlap()
        with tr.span("serve.sync"):
            host = out[:n + n_groups * r * width].cpu().numpy()
        if width == 1:
            return host.reshape(n, 1)
        toks = np.full((n, width), self.eos, np.int32)
        toks[:, 0] = host[:n]
        toks[sel[on]] = host[n:].reshape(-1, width)[on.ravel()]
        return toks

    def _replay(self, step: StepGraph, slots: np.ndarray, out: torch.Tensor,
                sampling) -> torch.Tensor:
        """One replay of ``step``, whose row j serves slot ``slots[j]`` (-1:
        none): its greedy tokens into ``out`` (the step's rows x width),
        each sampling row's draws in place of its greedy tokens, all
        ordered before the next replay overwrites the step's outputs.
        ``sampling``: (q_lens, temperatures, seeds, sample counts, ladder)
        by slot. Returns the step's logits."""
        qlens, temps, seeds, counts, ladder = sampling
        logits, greedy = step.replay()
        out.copy_(greedy)
        if not temps.any():
            return logits
        for j in np.flatnonzero((slots >= 0) & (temps[np.maximum(slots, 0)] > 0.0)):
            b = slots[j]
            q = int(qlens[b])
            for p in (range(q) if ladder[b] else (q - 1,)):
                idx = int(counts[b]) + (p if ladder[b] else 0)
                out[j, p] = sample_token(logits[j, p], float(temps[b]),
                                         sample_seed(self.seed, seeds[b], idx))
        return logits

    # ---- continuous path -----------------------------------------------------

    def _generate_continuous(self, requests: Sequence[Request]) -> list[GenerationResult]:
        """One :class:`_ContinuousRun` over the engine's pool, made once (a
        captured step bakes its tensors) and reset at every later call."""
        pool = self.last_pool
        if pool is None:
            cfg = self.lm.cfg
            kw = dict(device=self.device, prefix_sharing=self.prefix_sharing,
                      registry=self.obs, admission=self.admission, n_pages=self.pool_pages,
                      faults=self.faults, mesh=self.mesh, pcfg=self.pcfg)
            if self.host_pages is not None and self.host_pages > 0:
                pool = TieredPagePool(cfg, cfg.n_layers, self.batch_size, self._cap,
                                      host_pages=self.host_pages, **kw)
            else:
                pool = PagedKVPool(cfg, cfg.n_layers, self.batch_size, self._cap, **kw)
            self.last_pool = pool
        else:
            pool.faults = self.faults
            pool.reset()
            pool.emit_gauges()
        run = _ContinuousRun(self, pool, requests)
        results = run.serve()
        self.last_stats = run.stats()
        return results

    def _log_stats_line(self, n_steps: int, pool, sched) -> None:
        v = self.obs.value
        spec = ""
        if self.drafter is not None:
            drafted = v("serve.spec.draft_tokens")
            acc = v("serve.spec.accepted_tokens")
            spec = (f" draft={drafted:.0f} accept={acc:.0f} ({acc / drafted:.0%})" if drafted
                    else " draft=0")
        print(
            f"[serve] step {n_steps}: "
            f"queue={len(sched.waiting)} active={len(sched.active_slots())} "
            f"tokens dec/pre={v('serve.step.tokens', kind='decode'):.0f}"
            f"/{v('serve.step.tokens', kind='prefill'):.0f} "
            f"gen={v('serve.tokens.generated'):.0f} "
            f"pool free={pool.alloc.free_count} "
            f"occ={v('pool.occupancy_frac'):.0%} "
            f"adopted={pool.shared_hits} cow={pool.cow_forks}"
            f"{spec}"
        )

    def _admit(self, req: Request, slot: int, sched, pool, temps, seeds, counts, idx: int,
               prior: Optional[list] = None):
        """Admit ``req`` into ``slot``: the pool adopts any registered shared
        prefix and reserves the rest; the prompt's other tokens run through
        the mixed step as chunks. Returns the placed ``Slot``, or None if
        the pool lacks pages.

        ``prior`` (a preempted request's generated tokens) makes this a
        restore: the prompt becomes prompt + prior, re-prefilled in chunks
        through the same mixed step, the slot's generated list starts as
        ``prior`` (so the limit and EOS go on counting) and the sample
        index resumes at ``len(prior)``; a draw depends only on (engine
        seed, request seed, index), so the restored stream is the
        uninterrupted one."""
        cap = self._cap
        prompt = np.asarray(req.tokens, np.int32)[-cap:]
        if len(prompt) == 0:
            prompt = np.full((1,), self.eos, np.int32)  # empty prompt -> 1 pad
        new_limit = max(0, min(req.max_new_tokens, cap - len(prompt) + 1))
        if new_limit == 0:
            st = sched.place(slot, req, eos_id=self._eos_for(req), new_limit=0)
            st.done = True
            return st
        prior = list(prior) if prior else []
        # len(prompt + prior) <= cap by the new_limit clamp above.
        full = np.concatenate([prompt, np.asarray(prior, np.int32)]) if prior else prompt
        shared = pool.admit(slot, full, new_limit - len(prior))
        if shared is None:
            return None
        st = sched.place(
            slot, req, eos_id=self._eos_for(req), new_limit=new_limit,
            prompt=full, prompt_pos=shared,
        )
        st.generated = prior
        st.n_prior = len(prior)  # the prompt carries them already
        temps[slot] = req.temperature
        seeds[slot] = idx if req.seed is None else req.seed
        counts[slot] = len(prior)
        return st


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy tokens: int32 argmax over the last axis (first maximum)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


def _copy_tree(dst: dict, src: dict) -> None:
    """Copy every tensor of ``src`` into the same place in ``dst``, in
    place, skipping those that already are ``dst``'s (written in place)."""
    for k, d in dst.items():
        if isinstance(d, dict):
            _copy_tree(d, src[k])
        elif src[k] is not d:
            d.copy_(src[k])


class _Step(NamedTuple):
    """One mixed step's plan and host inputs, by slot."""

    plan: list            # the step's rows (scheduler StepItems)
    width: int            # 1, or the chunk width
    tokens: np.ndarray    # (n_slots, width): a verification row is [cur, d_1..d_K]
    qlens: np.ndarray
    ladder: np.ndarray    # verification rows
    replays: int          # what the step runs: compact replays + the narrow one
    positions: int        # what it computes: R x chunk a compact replay, n_slots the narrow
    n_decode: int         # the planned tokens of decode and verification rows
    n_prefill: int        # and of prompt chunks


class _ContinuousRun:
    """One ``generate()`` of the continuous engine: the scheduler, the pool
    and every request's lifecycle, one method a phase of a step in the order
    of the spans a step opens. It calls the engine's seams (``_admit``,
    ``_run_mixed``, ...) through the engine, where tests replace them."""

    def __init__(self, eng: ServeEngine, pool: PagedKVPool, requests: Sequence[Request]):
        n_slots = eng.batch_size
        self.eng, self.tr, self.pool, self.requests = eng, eng.tracer, pool, requests
        self.tier = pool if isinstance(pool, TieredPagePool) else None
        self.sched = ContinuousScheduler(n_slots, token_budget=eng._budget,
                                         prefill_chunk=eng._chunk)
        self.sched.submit(list(requests))
        self.ctl, self.faults, self.drafter = eng.order_ctl, eng.faults, eng.drafter
        if self.drafter is not None:
            self.drafter.reset()
        self.idx_of = {id(r): i for i, r in enumerate(requests)}  # default seeds
        self.cur = np.full((n_slots,), eng.eos, np.int32)  # last sampled token
        self.temps = np.zeros((n_slots,), np.float32)
        self.seeds = np.zeros((n_slots,), np.int64)
        self.counts = np.zeros((n_slots,), np.int64)
        self.results: dict[int, GenerationResult] = {}
        self.resume: dict[int, list] = {}       # preempted: id(request) -> generated
        self.n_preempts: dict[int, int] = {}    # id(request) -> times preempted
        self.work = StepStats()                 # the run's own counts
        self.step, self.t0 = 0, time.perf_counter_ns()
        self.deadlines = any(r.deadline_s is not None for r in requests)
        # Request lifecycles, by id(request), in perf_counter_ns: when it
        # became admissible (the boundary of its arrival step, generate()'s
        # entry for step 0, or its preemption) while it waits; its waits
        # for admission, summed; each token's arrival on the host, from t0.
        self.ready_ns, self.queue_ns, self.token_ns = {}, {}, {}
        self.arriving = collections.deque(sorted(requests, key=lambda r: r.arrival))
        self.arrive(self.t0)

    def serve(self) -> list[GenerationResult]:
        """Step until no request is left; the results in request order."""
        eng, sched = self.eng, self.sched
        while sched.has_work():
            t_iter = time.perf_counter()
            with self.tr.span("serve.step", step=self.step):
                self.boundary()
                self.admit()
                drafts = self.draft()
                plan = self.plan(drafts)
                if not plan:
                    if self.tier is not None and self.tier.suspended_slots():
                        # Suspended work only: stream pages back, splice later.
                        self.prefetch(False)
                        self.step += 1
                        continue
                    if sched.waiting:
                        self.step = max(self.step + 1, sched.next_arrival())
                        continue
                    break
                s = self.inputs(plan, drafts)
                got = self.device_step(s)
                if got is None:  # failed twice: its rows failed, serving goes on
                    continue
                self.commit(s, *got)
            eng._m_step_time.observe(time.perf_counter() - t_iter)
            n = self.work.mixed_steps
            if eng._log_every and n % eng._log_every == 0:
                eng._log_stats_line(n, self.pool, sched)
        eng._m_admit_paused.set(0.0)
        return [self.results[id(r)] for r in self.requests]

    # ---- request lifecycle -------------------------------------------------------

    def arrive(self, now: int) -> None:
        while self.arriving and self.arriving[0].arrival <= self.step:
            self.ready_ns[id(self.arriving.popleft())] = now

    def resolve(self, r: Request, tokens: list, status: str) -> None:
        now = time.perf_counter_ns()
        key = id(r)
        if key in self.ready_ns:  # retired while waiting: that wait counts
            self.queue_ns[key] = self.queue_ns.get(key, 0) + now - self.ready_ns.pop(key)
        times = tuple(self.token_ns.pop(key, ()))
        n_tok = len(tokens)
        ttft = times[0] if times else now - self.t0
        res = GenerationResult(
            rid=r.rid, tokens=np.asarray(tokens, np.int32), steps=n_tok, ttft_s=ttft / 1e9,
            tpot_s=_tpot((now - self.t0 - ttft) / 1e9, n_tok), status=status,
            n_preemptions=self.n_preempts.get(key, 0), queue_s=self.queue_ns.pop(key, 0) / 1e9,
            token_s=tuple(x / 1e9 for x in times))
        self.results[key] = res
        self.eng._cancelled.discard(r.rid)
        self.eng._record_result(res)
        self.tr.instant("serve.request.finish", rid=r.rid, status=status, token_ns=times)

    def retire(self, slot: int):
        st = self.sched.retire(slot)
        self.pool.release(slot)
        if self.drafter is not None:
            self.drafter.release(slot)
        self.cur[slot] = self.eng.eos
        self.temps[slot] = 0.0
        return st

    def finish(self, slot: int, status: str = "ok") -> None:
        st = self.retire(slot)
        self.resolve(st.request, list(st.generated), status)

    def drop(self, pred, status: str) -> None:
        """Resolve waiting and finish active requests matching ``pred``, as ``status``."""
        for r in self.sched.drain_waiting(pred):
            self.resolve(r, self.resume.pop(id(r), []), status)
        for i in list(self.sched.active_slots()):
            if pred(self.sched.slots[i].request):
                self.finish(i, status)

    def live(self) -> list[int]:
        """Runnable slots whose request is not done."""
        return [i for i in self.sched.runnable_slots() if not self.sched.slots[i].done]

    def preempt_one(self) -> bool:
        """Evict a live slot under pool pressure (``select_victim``; a
        suspended slot holds no device page, so it is no candidate):
        release its pages and requeue it at the queue head (restored by a
        chunked re-prefill of prompt + generated-so-far), or fail it past
        its bound. False when no slot is live."""
        eng, slots = self.eng, self.sched.slots
        cands = [(i, slots[i].request.priority, len(slots[i].generated),
                  self.pool.shared_donor(i)) for i in self.live()]
        if not cands:
            return False
        slot = select_victim(cands)
        st = self.retire(slot)
        r = st.request
        n_pre = self.n_preempts[id(r)] = self.n_preempts.get(id(r), 0) + 1
        limit = eng.max_preemptions if r.max_preemptions is None else r.max_preemptions
        if n_pre > limit:
            self.resolve(r, list(st.generated), "failed")
            return True
        self.resume[id(r)] = list(st.generated)
        self.sched.requeue(r)
        self.ready_ns[id(r)] = time.perf_counter_ns()
        self.work.preemptions += 1
        eng._m_preempt.inc()
        eng._m_req_requeued.inc()
        self.tr.instant("serve.preempt", rid=r.rid, slot=slot, generated=len(st.generated))
        return True

    # ---- the host tier ------------------------------------------------------------

    def spill_one(self, keep: int) -> bool:
        """Spill the coldest runnable slot, keeping at least ``keep``
        runnable (the watermark pass keeps one so the stream advances;
        under pressure it may go to zero: the freed pages are what lets a
        resume complete). A slot resumed and not yet stepped is no
        candidate: its fetches would be wasted."""
        pool, ctl = self.tier, self.ctl
        run = self.live()
        cands = [i for i in run if pool.can_spill(i) and not pool.shielded(i)]
        if not cands or len(run) <= keep:
            return False
        stats = slot_reuse_stats(ctl.order.value, [int(n) for n in pool.lens], pool.page,
                                 snake_group=ctl.snake_group)
        victim = select_spill_victim([(i, self.sched.slots[i].request.priority,
                                       pool.shared_donor(i), stats[i]["mean"]) for i in cands])
        if victim is None or not pool.spill_slot(victim):
            return False  # host full, or an injected tier.spill stall
        self.sched.suspend(victim)
        self.tr.instant("serve.spill", slot=victim, pages=pool.offslot_pages(victim))
        return True

    def tier_boundary(self) -> None:
        """In resolution order: splice finished resumes back in, spill down
        to the watermark, then open the fetch queue of the slot the pool
        lets resume, if any, in the next step's visit order."""
        pool, wm = self.tier, self.eng._spill_wm
        for i in pool.suspended_slots():
            if pool.resume_ready(i) and pool.complete_resume(i):
                self.sched.resume(i)
                self.tr.instant("serve.tier_resume", slot=i)
        while pool.occupancy() >= wm and self.spill_one(keep=1):
            pass
        if (i := pool.next_resume(wm, runnable=bool(self.live()))) is not None:
            n = pool.offslot_pages(i)
            group = self.ctl.effective_group(max(n, 1))
            pool.start_resume(i, order=future_visit_window(pool.lens[i] // pool.page, n, n, group))

    def prefetch(self, overlapped: bool) -> None:
        with self.tr.span("serve.prefetch", overlapped=overlapped):
            for i in self.tier.suspended_slots():
                self.tier.issue_fetches(i, self.eng.prefetch_depth, overlapped=overlapped)

    def overlap(self) -> None:
        """Issued after the replay is launched: the copies run on the
        pool's side stream beside the step, into staged rows that are
        spliced at a later boundary, never into the pages it reads."""
        if self.tier.fetch_backlog():
            self.prefetch(True)

    # ---- a step, phase by phase -----------------------------------------------------

    def boundary(self) -> None:
        """Arrivals, the fault plan's cancels, then cancels and deadlines;
        then the tier's work, before admission: spilling down to the spill
        watermark is what un-pauses admission."""
        eng, faults = self.eng, self.faults
        self.arrive(time.perf_counter_ns())
        if faults is not None:
            faults.begin_step(self.step)
            eng._cancelled.update(int(rid) for rid in faults.take_cancels())
        if eng._cancelled:
            self.drop(lambda r: r.rid in eng._cancelled, "cancelled")
        if self.deadlines:
            now_s = (time.perf_counter_ns() - self.t0) / 1e9
            self.drop(lambda r: r.deadline_s is not None and now_s > r.deadline_s, "deadline")
        if self.tier is not None:
            self.tier_boundary()

    def admit(self) -> None:
        """Fill free slots with arrived requests while the pool can reserve
        what the discipline guarantees; the watermark pauses it under
        pressure (never with no slot active). A preempted request's
        admission is its restore. Then shed past the queue bound."""
        eng, tr, sched, pool = self.eng, self.tr, self.sched, self.pool
        with tr.span("serve.admission"):
            paused = pool.occupancy() >= eng._watermark and bool(sched.active_slots())
            eng._m_admit_paused.set(float(paused))
            while not paused and (slot := sched.free_slot()) is not None:
                req = sched.pop_admissible(self.step)
                if req is None:
                    break
                key = id(req)
                restored = key in self.resume
                with (tr.span("serve.preempt_restore", rid=req.rid) if restored
                      else contextlib.nullcontext()):
                    st = eng._admit(req, slot, sched, pool, self.temps, self.seeds, self.counts,
                                    self.idx_of.get(key, 0), prior=self.resume.get(key))
                if st is None:
                    sched.requeue(req)  # no pages yet; retry after retirements
                    eng._m_req_requeued.inc()
                    break
                now = time.perf_counter_ns()
                wait = now - self.ready_ns.pop(key, now)
                self.queue_ns[key] = self.queue_ns.get(key, 0) + wait
                self.token_ns.setdefault(key, [])
                tr.instant("serve.request.admit", rid=req.rid, slot=slot, wait_ns=wait)
                self.resume.pop(key, None)
                eng._m_req_admitted.inc()
                if restored and st.prompt is not None:
                    n_re = int(len(st.prompt) - st.prompt_pos)
                    self.work.restore_tokens += n_re
                    eng._m_restore_tok.inc(n_re)
                if st.done:  # zero-limit request: emits nothing
                    self.finish(slot)
        if eng.max_queue is not None:
            for r in sched.shed_over(self.step, eng.max_queue):
                self.resolve(r, self.resume.pop(id(r), []), "shed")

    def draft(self) -> dict[int, list[int]]:
        """Drafts by slot, once a boundary and before the plan loop (a model
        drafter runs steps of its own, so a re-plan must not call it
        again). K is clamped so the verification chunk stays inside the
        row's limit and capacity (its writes stay inside the reservation)
        and the wide width."""
        if self.drafter is None:
            return {}
        eng, sched = self.eng, self.sched
        want = []
        for i in sched.runnable_slots():
            st = sched.slots[i]
            if st.done or st.prefilling:
                continue
            kmax = min(eng.draft_len, st.new_limit - len(st.generated) - 1,
                       eng._cap - int(self.pool.lens[i]) - 1, eng._chunk - 1)
            if kmax >= 1:
                ctx = np.concatenate([st.prompt, np.asarray(st.generated[st.n_prior:], np.int32)])
                want.append((i, ctx, kmax))
        if not want:
            return {}
        with self.tr.span("serve.draft", rows=len(want)):
            out = self.drafter.draft_batch(want)
        drafts = {i: [int(t) for t in out.get(i, [])][:kmax] for i, _, kmax in want}
        return {i: d for i, d in drafts.items() if d}

    def plan(self, drafts: dict[int, list[int]]) -> list:
        """Plan under pressure: make every planned row writable; a
        PoolExhausted (optimistic growth or an injected fault) spills a
        victim to the host tier when there is one, else preempts one, and
        plans again. Each round removes a runnable slot, so this ends;
        ensure_writable is idempotent for the rows it already did."""
        draft_lens = {i: len(d) for i, d in drafts.items()} or None
        while True:
            with self.tr.span("serve.plan_step"):
                plan = self.sched.plan_step(draft_lens)
            try:
                for it in plan:
                    self.pool.ensure_writable(it.slot, it.q_len)
            except PoolExhausted:
                if (self.tier is not None and self.spill_one(keep=0)) or self.preempt_one():
                    continue
                raise
            break
        self.eng._m_queue.set(len(self.sched.waiting))
        self.eng._m_active.set(len(self.sched.active_slots()))
        return plan

    def inputs(self, plan: list, drafts: dict[int, list[int]]) -> _Step:
        """The step's width and host inputs; captures the steps its layout
        needs here, outside the step's span."""
        eng, slots, cur = self.eng, self.sched.slots, self.cur
        n_slots = eng.batch_size
        width = 1 if all(it.q_len == 1 for it in plan) else eng._chunk
        tokens = np.full((n_slots, width), eng.eos, np.int32)
        qlens = np.zeros((n_slots,), np.int32)
        ladder = np.zeros((n_slots,), bool)
        n_decode = n_prefill = 0
        for it in plan:
            st = slots[it.slot]
            if it.is_prefill:
                row = st.prompt[st.prompt_pos : st.prompt_pos + it.q_len]
                n_prefill += it.q_len
            else:
                row = [int(cur[it.slot])] + drafts.get(it.slot, [])[: it.n_draft]
                ladder[it.slot] = it.n_draft > 0
                n_decode += it.q_len
            tokens[it.slot, : len(row)] = row
            qlens[it.slot] = it.q_len
        eng._m_budget.set((n_decode + n_prefill) / self.sched.token_budget)
        sel, narrow_rows = eng._layout(width, qlens)
        narrow_runs = bool(narrow_rows.any())
        if len(sel):
            eng._mixed_step(width, self.pool)
        if narrow_runs:
            eng._mixed_step(1, self.pool)
        return _Step(plan, width, tokens, qlens, ladder, replays=len(sel) + narrow_runs,
                     positions=eng._rows * width * len(sel) + n_slots * narrow_runs,
                     n_decode=n_decode, n_prefill=n_prefill)

    def device_step(self, s: _Step) -> Optional[tuple[np.ndarray, int]]:
        """Run the step: its tokens and when they reached the host (ns from
        t0), or None when it failed twice (one transient failure is
        retried): its rows fail and the step is spent. The span closes once
        the tokens are on the host, so it brackets the step's device time."""
        eng, tr, pool = self.eng, self.tr, self.pool
        # The order in effect now (a switch after the last step takes
        # effect here): one staged int32, nothing captured. A suspended
        # row stages length 0 over its dummied table.
        order_group = self.ctl.effective_group(pool.blocks_per_seq)
        lens = pool.step_lens()
        with tr.span("serve.device_step", width=s.width, rows=len(s.plan),
                     tokens=s.n_decode + s.n_prefill, positions=s.positions,
                     **({"replays": s.replays} if s.width > 1 else {})) as args:
            eng._clock.into(args)
            for attempt in range(2):
                try:
                    # An injected device fault fires before anything is
                    # staged or run, so the retry runs the same step on the
                    # same state.
                    if self.faults is not None:
                        self.faults.raise_if("device.step")
                    toks = eng._run_mixed(s.width, s.tokens, pool, s.qlens, order_group,
                                          self.temps, self.seeds, self.counts, lens, s.ladder,
                                          self.overlap if self.tier is not None else None)
                    # One reading a step: when its tokens reached the host.
                    return toks, time.perf_counter_ns() - self.t0
                except StepCaptureError:
                    raise
                except Exception as err:
                    if attempt == 0:
                        eng._m_retries.inc()
                        tr.instant("serve.step_retry", step=self.step, error=repr(err))
                    else:
                        tr.instant("serve.step_failed", step=self.step, error=repr(err))
            for it in s.plan:
                if self.sched.slots[it.slot] is not None:
                    self.finish(it.slot, "failed")
        self.step += 1
        return None

    def commit(self, s: _Step, toks: np.ndarray, landed: int) -> None:
        """Boundary work after the step: advance, record, finish, the
        gauges and the order's sampling."""
        eng, pool, slots, ctl = self.eng, self.pool, self.sched.slots, self.ctl
        counts, cur, token_ns = self.counts, self.cur, self.token_ns
        with self.tr.span("serve.commit"):
            self.step += 1
            self.work.mixed_steps += 1
            self.work.wide_steps += s.width > 1
            eng._m_tok_decode.inc(s.n_decode)
            eng._m_tok_prefill.inc(s.n_prefill)
            (eng._m_steps_wide if s.width > 1 else eng._m_steps_narrow).inc()
            if s.width > 1:
                eng._m_wide_replays.inc(s.replays)
            for it in s.plan:
                st = slots[it.slot]
                pool.advance(it.slot, it.q_len)
                if it.is_prefill:
                    st.prompt_pos += it.q_len
                    if not it.finishes_prompt:
                        continue
                    # Prompt complete: publish its frozen pages for later
                    # admissions to adopt, then take the first sample.
                    pool.register_prompt(it.slot, st.prompt)
                if it.n_draft:
                    self.verify(it, s.tokens[it.slot, 1:it.q_len].tolist(), toks, landed)
                    continue
                tok = int(toks[it.slot, it.q_len - 1])
                token_ns[id(st.request)].append(landed)
                counts[it.slot] += 1
                cur[it.slot] = tok
                if st.record(tok):
                    self.finish(it.slot)
            if self.faults is not None and self.faults.fired_this_step:
                # A step that absorbed a fault is followed by a pool audit.
                pool.check_invariants()
            pool.emit_gauges()
            # The widest decode or verification chunk (K+1 under
            # speculation): the query width a KV sweep is amortized over.
            step_q = max((it.q_len for it in s.plan if not it.is_prefill), default=1)
            n = self.work.mixed_steps
            if ctl.enabled:
                # Adaptation samples on its own cadence: the decision needs
                # a fresh reading, not the last gauge.
                if ctl.maybe_adapt(n, pool, eng.llc, step_q=step_q):
                    self.tr.instant("serve.order_switch", order=ctl.order.value, step=n)
            else:
                eng.llc.maybe_sample(n, pool, step_q=step_q)

    def verify(self, it, drafts: list[int], toks: np.ndarray, landed: int) -> None:
        """Commit a verification row [cur, d_1..d_K]: t_i = toks[slot, i] is
        what the sequential stream samples after the first i drafts. Accept
        the longest prefix with d_{i+1} == t_i, emit t_0..t_a (stopping at
        EOS or the limit as a sequential stream would), roll the rest of
        the chunk back; the sample count advances by the tokens emitted."""
        eng, slot, k = self.eng, it.slot, len(drafts)
        st = self.sched.slots[slot]
        times = self.token_ns[id(st.request)]
        a = 0
        while a < k and drafts[a] == int(toks[slot, a]):
            a += 1
        for emitted, tok in enumerate(toks[slot, : a + 1].tolist(), 1):
            times.append(landed)
            if finished := st.record(tok):
                break
        self.cur[slot] = tok
        self.counts[slot] += emitted
        n_roll = it.q_len - emitted
        if n_roll and not finished:
            self.pool.rollback(slot, n_roll)
        accepted = emitted - 1
        self.work.draft_tokens += k
        self.work.accepted_tokens += accepted
        self.work.rollback_tokens += k - accepted
        eng._m_draft_tok.inc(k)
        eng._m_accept_tok.inc(accepted)
        eng._m_rollback_tok.inc(k - accepted)
        if finished:
            self.finish(slot)

    def stats(self) -> StepStats:
        """The run's counts, with the pool's and the results' by status."""
        s, pool = self.work, self.pool
        s.pages_adopted, s.prompt_tokens_adopted = pool.shared_hits, pool.shared_tokens
        s.cow_forks = pool.cow_forks
        if (t := self.tier) is not None:
            s.spills, s.tier_fetches = t.spills, t.fetches
            s.prefetch_hits, s.prefetch_wasted = t.prefetch_hits, t.prefetch_wasted
        by = collections.Counter(r.status for r in self.results.values())
        s.shed, s.deadline_miss = by["shed"], by["deadline"]
        s.cancelled, s.failed = by["cancelled"], by["failed"]
        return s
