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
otherwise. Identical prompt prefixes share pages (adoption +
copy-on-write).

Steps as captured graphs (``serve.step_graph``), the counterpart of the
reference's jitted steps: on the card the continuous mixed step is one
CUDA graph per width (two at most, sharing one memory pool) and the static
decode step one graph per engine, each captured at its first use and
replayed for every step after; tokens, block table, lengths, q_lens and
the reversal group reach it through static buffers, and greedy argmax runs
inside it. The engine owns what a graph's pointers bake in: the pool's
pages (its host state is reset at each ``generate()``) and the static
decode caches of ``max_len``, into which each group's prefill result is
copied. The static prefill stays eager: its shape changes with each
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
victim (``select_victim``: lowest priority, then not a prefix donor, then
fewest generated tokens, then slot), which is requeued at the queue head
and restored by a chunked re-prefill of prompt + generated-so-far through
the same two mixed-step widths (nothing is captured anew), or fails once
past its preemption bound. A failed step dispatch is retried once, then
the step's rows fail (``status="failed"``) and serving goes on. The pool
is written in place, so the retry relies on a step being idempotent: it
writes positions ``len..len+q_len`` that only it reads, and ``len``
advances on the host after success only. On the card a replay that fails
raises (a CUDA error is sticky; no retry could succeed). ``faults`` (a
``serve.faults.FaultPlan``) injects pool exhaustion, admission refusals,
step failures and cancels at planned steps.

Tiered KV memory, continuous path, as in the reference: ``host_pages``
puts a ``serve.tiering.TieredPagePool`` host tier under the device pool.
At ``spill_watermark`` occupancy, and before a preemption, the coldest
slot (largest modeled reuse distance, ``core.cache_sim.slot_reuse_stats``)
is spilled to pinned host memory and suspended; a suspended slot resumes
when the pool is calm, its pages fetched ``prefetch_depth`` a boundary in
the next step's visit order (``core.schedule.future_visit_window``), the
copies issued on a side stream after the step's replay is launched and
before the host waits for its tokens, and it rejoins the plans only once
every page is back, written into the pool's own tensors: the captured
steps never see a new one.

Speculative decoding, continuous path, as in the reference: ``drafter`` (a
``serve.spec.Drafter``) proposes up to ``draft_len`` tokens a decode row
once a step boundary; the row runs as a ``q_len = K+1`` verification chunk
in the same two captured widths, the target token at each chunk position
is read from the one step (a sampling row draws at position p with sample
index ``count + p``, the index sequential steps would use), the longest
matching draft prefix and one token more are committed, and the rest is
rolled back out of the pool (``PagedKVPool.rollback``).

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
into staging, the copy enqueued), ``serve.replay`` (the graph's launch;
the eager prefill's forward is ``serve.forward``) and ``serve.sync`` (the
host's wait for the tokens); ``serve.step`` also holds
``serve.admission`` and ``serve.commit`` (advance, record, finish, the
gauges). On the card a step span carries ``device_ns``, its window
between CUDA events (``step_graph.DeviceClock``), and ``gap_ns``, the
card's wait since the previous step's window (since ``generate()``'s
entry for the first): the events are read once done, after the next
step's launch and at the end of ``generate()``, so no wait is added.
``positions`` on ``serve.device_step`` (slots x width) and
``serve.prefill`` (rows x bucket) count what the step computes beside
its ``tokens``. Each request leaves two instants: ``serve.request.admit``
(``rid``, ``slot``, ``wait_ns``: from when it became admissible, at its
arrival step's boundary or its preemption, to its admission; the static
path's group waits until its prefill starts) and
``serve.request.finish`` (``rid``, ``status``, ``token_ns``: each token's
arrival on the host in ns from ``generate()``'s entry, one clock reading
a step), which ``GenerationResult.queue_s`` and ``token_s`` repeat.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Optional, Sequence

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
        self._m_shed = r.counter("serve.shed")
        self._m_deadline = r.counter("serve.deadline_miss")
        self._m_cancel = r.counter("serve.cancelled")
        self._m_failed = r.counter("serve.failed")
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
        if self.scheduler == "continuous":
            results = self._generate_continuous(requests)
        else:
            results = []
            t0 = time.perf_counter_ns()  # TTFT includes queueing behind earlier groups
            for i in range(0, len(requests), self.batch_size):
                group = list(requests[i : i + self.batch_size])
                results.extend(self._generate_batch(group, base_idx=i, t0=t0))
        self._clock.read()  # the last steps' windows: their tokens are on the host
        return results

    def compiled_step_count(self) -> int:
        """Step graphs the engine holds, over its whole life: continuous, one
        per mixed-step width used (at most two: 1 and the chunk width);
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

    def _new_step(self, name: str, fn, inputs: dict, state) -> StepGraph:
        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        step = StepGraph(name, fn, inputs, device=self.device, state=state,
                         pool=self._graph_pool, clock=self._clock)
        self._m_compiles.inc()
        self.tracer.instant("serve.compile", step=name, variants=self.compiled_step_count() + 1)
        return step

    def _record_result(self, res: GenerationResult) -> None:
        self._m_req_finished.inc()
        self._m_generated.inc(res.steps)
        if res.status == "ok":
            self._m_ttft.observe(res.ttft_s)
            self._m_tpot.observe(res.tpot_s)
        elif res.status == "deadline":
            self._m_deadline.inc()
        elif res.status == "cancelled":
            self._m_cancel.inc()
        elif res.status == "shed":
            self._m_shed.inc()
        elif res.status == "failed":
            self._m_failed.inc()

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

    def _pick(self, logits: torch.Tensor, greedy: torch.Tensor, draws) -> np.ndarray:
        """``greedy`` (the int32 argmax of ``logits`` over the last axis) as
        a host array, with the positions of ``draws`` — (index, temperature,
        seed) — replaced by draws from the logits there."""
        if draws:
            greedy = greedy.clone()
            for idx, temp, seed in draws:
                greedy[idx] = sample_token(logits[idx], temp, seed)
        return greedy.cpu().numpy()

    def _sample(self, logits: torch.Tensor, greedy: torch.Tensor, temps: np.ndarray,
                seeds: np.ndarray, count: int) -> np.ndarray:
        """One token per row of logits (B, V), as a host array: greedy where
        the temperature is 0, else a draw with sample index ``count``."""
        return self._pick(logits, greedy, [
            (int(b), float(temps[b]), sample_seed(self.seed, seeds[b], count))
            for b in np.flatnonzero(temps > 0.0)
        ])

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
            step.capture()
            self._decode = step
        # Copying the group's caches in is the first decode step's staging:
        # its device window opens here (the step's own staging keeps it).
        self._clock.begin()
        _copy_tree(self._decode_caches, caches)
        return self._decode

    def _decode_fn(self, caches: dict):
        def step(tokens):
            with on_mesh(self.mesh, pcfg=self.pcfg):
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
                with on_mesh(self.mesh, pcfg=self.pcfg):
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
        writes only the dummy page 0."""
        step = self._mixed.get(width)
        if step is None:
            n = self.batch_size
            step = self._new_step(
                f"mixed step (width {width})", self._mixed_fn(pool.pages),
                {"tokens": (n, width), "block_table": (n, pool.blocks_per_seq), "lens": (n,),
                 "q_lens": (n,), "order_group": ()},
                # This rank's pages but the dummy page 0: the invalid rows'
                # writes land there in no fixed order, and nothing reads them.
                [t[:, 1:] for t in pool.local_pages().values()],
            )
            step.capture()
            self._mixed[width] = step
        return step

    def _mixed_fn(self, pages: dict):
        def step(tokens, block_table, lens, q_lens, order_group):
            caches = assemble_cache_view(pages, block_table, lens, q_lens, order_group)
            with on_mesh(self.mesh):
                logits, _ = self.lm.decode_step(self.params, tokens, caches)
            logits = whole(logits)
            return logits, _argmax(logits)
        return step

    @torch.no_grad()
    def _run_mixed(self, step: StepGraph, tokens, pool, qlens, order_group, temps, seeds,
                   counts, lens, ladder, overlap=None) -> np.ndarray:
        """One ragged step: (n_slots, width) tokens over ``pool``'s block
        table and the staged lengths ``lens`` -> the sampled token at every
        chunk position, as a host array. Greedy everywhere; a sampling row
        draws at its last valid position with sample index ``counts[row]``,
        a verification row (``ladder[row]``) at every position p with index
        ``counts[row] + p``. ``overlap`` is host work issued once the
        replay is launched, before the host waits for its tokens."""
        tr = self.tracer
        with tr.span("serve.stage"):
            step.stage(tokens=tokens, block_table=pool.block_tables, lens=lens, q_lens=qlens,
                       order_group=order_group)
        with tr.span("serve.replay"):
            logits, greedy = step()
        self._clock.read()  # the windows before, while the card runs this one
        if overlap is not None:
            overlap()
        draws = []
        for b in np.flatnonzero((temps > 0.0) & (qlens > 0)):
            q = int(qlens[b])
            for p in (range(q) if ladder[b] else (q - 1,)):
                idx = int(counts[b]) + (p if ladder[b] else 0)
                draws.append(((int(b), p), float(temps[b]),
                              sample_seed(self.seed, seeds[b], idx)))
        with tr.span("serve.sync"):
            return self._pick(logits, greedy, draws)

    # ---- continuous path -----------------------------------------------------

    def _generate_continuous(self, requests: Sequence[Request]) -> list[GenerationResult]:
        cfg = self.lm.cfg
        n_slots = self.batch_size
        cap = self._cap
        sched = ContinuousScheduler(
            n_slots, token_budget=self._budget, prefill_chunk=self._chunk
        )
        sched.submit(list(requests))
        idx_of = {id(r): i for i, r in enumerate(requests)}  # default seeds
        tiered = self.host_pages is not None and self.host_pages > 0
        pool = self.last_pool
        if pool is None:
            pool_kw = dict(device=self.device, prefix_sharing=self.prefix_sharing,
                           registry=self.obs, admission=self.admission,
                           n_pages=self.pool_pages, faults=self.faults, mesh=self.mesh,
                           pcfg=self.pcfg)
            if tiered:
                pool = TieredPagePool(cfg, cfg.n_layers, n_slots, cap,
                                      host_pages=self.host_pages, **pool_kw)
            else:
                pool = PagedKVPool(cfg, cfg.n_layers, n_slots, cap, **pool_kw)
            self.last_pool = pool
        else:
            pool.faults = self.faults
            pool.reset()
            pool.emit_gauges()
        ctl = self.order_ctl
        faults = self.faults
        drafter = self.drafter
        if drafter is not None:
            drafter.reset()

        results: dict[int, GenerationResult] = {}
        resume: dict[int, list] = {}       # preempted: id(request) -> generated
        n_preempts: dict[int, int] = {}    # id(request) -> times preempted
        tally = {"preempt": 0, "restore": 0, "draft": 0, "accept": 0, "roll": 0}
        cur = np.full((n_slots,), self.eos, np.int32)  # last sampled token
        temps = np.zeros((n_slots,), np.float32)
        seeds = np.zeros((n_slots,), np.int64)
        counts = np.zeros((n_slots,), np.int64)
        t0 = time.perf_counter_ns()
        tr = self.tracer
        # Request lifecycles, by id(request), in perf_counter_ns: when it
        # became admissible (the boundary of its arrival step, generate()'s
        # entry for step 0, or its preemption) while it waits; its waits
        # for admission, summed; each token's arrival on the host, from t0.
        ready_ns: dict[int, int] = {}
        queue_ns: dict[int, int] = {}
        token_ns: dict[int, list[int]] = {}
        by_arrival = sorted(requests, key=lambda r: r.arrival)
        n_arrived = 0

        def arrive(step: int, now: int) -> None:
            nonlocal n_arrived
            while n_arrived < len(by_arrival) and by_arrival[n_arrived].arrival <= step:
                ready_ns[id(by_arrival[n_arrived])] = now
                n_arrived += 1

        arrive(0, t0)

        def resolve(r, tokens: list, status: str) -> None:
            now = time.perf_counter_ns()
            key = id(r)
            if key in ready_ns:  # retired while waiting: that wait counts
                queue_ns[key] = queue_ns.get(key, 0) + now - ready_ns.pop(key)
            times = tuple(token_ns.pop(key, ()))
            n_tok = len(tokens)
            ttft = times[0] if times else now - t0
            res = GenerationResult(
                rid=r.rid,
                tokens=np.asarray(tokens, np.int32),
                steps=n_tok,
                ttft_s=ttft / 1e9,
                tpot_s=_tpot((now - t0 - ttft) / 1e9, n_tok),
                status=status,
                n_preemptions=n_preempts.get(key, 0),
                queue_s=queue_ns.pop(key, 0) / 1e9,
                token_s=tuple(x / 1e9 for x in times),
            )
            results[key] = res
            self._cancelled.discard(r.rid)
            self._record_result(res)
            tr.instant("serve.request.finish", rid=r.rid, status=status, token_ns=times)

        def retire(slot: int):
            st = sched.retire(slot)
            pool.release(slot)
            if drafter is not None:
                drafter.release(slot)
            cur[slot] = self.eos
            temps[slot] = 0.0
            return st

        def finish(slot: int, status: str = "ok") -> None:
            st = retire(slot)
            resolve(st.request, list(st.generated), status)

        def preempt(slot: int) -> None:
            # Evict a live slot under pool pressure: release its pages and
            # requeue it at the queue head (restored by a chunked re-prefill
            # of prompt + generated-so-far), or fail it past its bound.
            st = retire(slot)
            r = st.request
            n_pre = n_preempts[id(r)] = n_preempts.get(id(r), 0) + 1
            limit = self.max_preemptions if r.max_preemptions is None else r.max_preemptions
            if n_pre > limit:
                resolve(r, list(st.generated), "failed")
                return
            resume[id(r)] = list(st.generated)
            sched.requeue(r)
            ready_ns[id(r)] = time.perf_counter_ns()
            tally["preempt"] += 1
            self._m_preempt.inc()
            self._m_req_requeued.inc()
            tr.instant("serve.preempt", rid=r.rid, slot=slot, generated=len(st.generated))

        def preempt_victim() -> bool:
            # Suspended slots are no candidates: they hold no device page.
            cands = [
                (i, sched.slots[i].request.priority, len(sched.slots[i].generated),
                 pool.shared_donor(i))
                for i in sched.runnable_slots()
                if not sched.slots[i].done
            ]
            if not cands:
                return False
            preempt(select_victim(cands))
            return True

        def spill_one(keep: int) -> bool:
            # Spill the coldest runnable slot, keeping at least ``keep``
            # runnable (the watermark pass keeps one so the stream advances;
            # under pressure it may go to zero: the freed pages are what
            # lets a resume complete). A slot resumed and not yet stepped is
            # no candidate: its fetches would be wasted.
            run = [i for i in sched.runnable_slots() if not sched.slots[i].done]
            cands = [i for i in run if pool.can_spill(i) and not pool.shielded(i)]
            if not cands or len(run) <= keep:
                return False
            stats = slot_reuse_stats(ctl.order.value, [int(n) for n in pool.lens], pool.page,
                                     snake_group=ctl.snake_group)
            victim = select_spill_victim([
                (i, sched.slots[i].request.priority, pool.shared_donor(i), stats[i]["mean"])
                for i in cands
            ])
            if victim is None or not pool.spill_slot(victim):
                return False  # host full, or an injected tier.spill stall
            sched.suspend(victim)
            tr.instant("serve.spill", slot=victim, pages=pool._offslot_pages(victim))
            return True

        def tier_boundary() -> None:
            # In resolution order: splice finished resumes back in, spill
            # down to the watermark, then open the fetch queue of at most
            # one suspended slot, in the next step's visit order.
            for i in pool.suspended_slots():
                if pool.resume_ready(i) and pool.complete_resume(i):
                    sched.resume(i)
                    tr.instant("serve.tier_resume", slot=i)
            while pool.occupancy() >= self._spill_wm and spill_one(keep=1):
                pass
            suspended = pool.suspended_slots()
            if not suspended or any(pool._suspended[i].started for i in suspended):
                return
            runnable = [i for i in sched.runnable_slots() if not sched.slots[i].done]
            n_alloc = pool.alloc.n_pages - 1
            held = n_alloc - pool.alloc.free_count
            for i in suspended:
                n_pgs = pool._offslot_pages(i)
                # Resume only into calm (one that pushes occupancy back over
                # the spill watermark just moves the pressure to another
                # victim), unless nothing is runnable.
                calm = (held + n_pgs) / max(n_alloc, 1) < self._spill_wm
                if pool.alloc.available >= pool.resume_need(i) and (calm or not runnable):
                    group = ctl.effective_group(max(n_pgs, 1))
                    pool.start_resume(i, order=future_visit_window(
                        int(pool.lens[i]) // pool.page, n_pgs, n_pgs, group))
                    break

        def prefetch(overlapped: bool) -> None:
            with tr.span("serve.prefetch", overlapped=overlapped):
                for i in pool.suspended_slots():
                    pool.issue_fetches(i, self.prefetch_depth, overlapped=overlapped)

        def overlap() -> None:
            # Issued after the replay is launched: the copies run on the
            # pool's side stream beside the step, into staged rows that are
            # spliced at a later boundary, never into the pages it reads.
            if pool.fetch_backlog():
                prefetch(True)

        step = 0
        n_steps = n_wide = 0
        while sched.has_work():
            t_iter = time.perf_counter()
            with tr.span("serve.step", step=step):
                arrive(step, time.perf_counter_ns())
                # ---- step-boundary lifecycle checks ----
                if faults is not None:
                    faults.begin_step(step)
                    for rid in faults.take_cancels():
                        self._cancelled.add(int(rid))
                if self._cancelled:
                    for r in sched.drain_waiting(lambda r: r.rid in self._cancelled):
                        resolve(r, resume.pop(id(r), []), "cancelled")
                    for i in list(sched.active_slots()):
                        if sched.slots[i].request.rid in self._cancelled:
                            finish(i, "cancelled")
                now_s = (time.perf_counter_ns() - t0) / 1e9
                for r in sched.drain_waiting(
                    lambda r: r.deadline_s is not None and now_s > r.deadline_s
                ):
                    resolve(r, resume.pop(id(r), []), "deadline")
                for i in list(sched.active_slots()):
                    r = sched.slots[i].request
                    if r.deadline_s is not None and now_s > r.deadline_s:
                        finish(i, "deadline")

                # The tier's boundary work comes before admission: spilling
                # down to the spill watermark is what un-pauses admission.
                if tiered:
                    tier_boundary()

                # Admission: fill free slots with arrived requests while the
                # pool can reserve what the discipline guarantees; the
                # watermark pauses it under pressure (never with no slot
                # active). A preempted request's admission is its restore.
                with tr.span("serve.admission"):
                    paused = pool.occupancy() >= self._watermark and bool(sched.active_slots())
                    self._m_admit_paused.set(float(paused))
                    while not paused and (slot := sched.free_slot()) is not None:
                        req = sched.pop_admissible(step)
                        if req is None:
                            break
                        restored = id(req) in resume
                        with (tr.span("serve.preempt_restore", rid=req.rid) if restored
                              else contextlib.nullcontext()):
                            st = self._admit(req, slot, sched, pool, temps, seeds, counts,
                                             idx_of.get(id(req), 0), prior=resume.get(id(req)))
                        if st is None:
                            sched.requeue(req)  # no pages yet; retry after retirements
                            self._m_req_requeued.inc()
                            break
                        now = time.perf_counter_ns()
                        wait = now - ready_ns.pop(id(req), now)
                        queue_ns[id(req)] = queue_ns.get(id(req), 0) + wait
                        token_ns.setdefault(id(req), [])
                        tr.instant("serve.request.admit", rid=req.rid, slot=slot, wait_ns=wait)
                        resume.pop(id(req), None)
                        self._m_req_admitted.inc()
                        if restored and st.prompt is not None:
                            n_re = int(len(st.prompt) - st.prompt_pos)
                            tally["restore"] += n_re
                            self._m_restore_tok.inc(n_re)
                        if st.done:  # zero-limit request: emits nothing
                            finish(slot)

                if self.max_queue is not None:
                    for r in sched.shed_over(step, self.max_queue):
                        resolve(r, resume.pop(id(r), []), "shed")

                # Drafting, once a boundary and before the plan loop (a
                # model drafter runs steps of its own, so a re-plan must not
                # call it again). K is clamped so the verification chunk
                # stays inside the row's limit and capacity (its writes
                # stay inside the reservation) and the wide width.
                drafts: dict[int, list[int]] = {}
                if drafter is not None:
                    want = []
                    for i in sched.runnable_slots():
                        st = sched.slots[i]
                        if st.done or st.prefilling:
                            continue
                        kmax = min(self.draft_len, st.new_limit - len(st.generated) - 1,
                                   cap - int(pool.lens[i]) - 1, self._chunk - 1)
                        if kmax < 1:
                            continue
                        ctx = np.concatenate(
                            [st.prompt, np.asarray(st.generated[st.n_prior:], np.int32)])
                        want.append((i, ctx, kmax))
                    if want:
                        with tr.span("serve.draft", rows=len(want)):
                            out = drafter.draft_batch(want)
                        for i, _, kmax in want:
                            d = [int(t) for t in out.get(i, [])][:kmax]
                            if d:
                                drafts[i] = d

                # Plan under pressure: make every planned row writable; a
                # PoolExhausted (optimistic growth or an injected fault)
                # spills a victim to the host tier when there is one, else
                # preempts one, possibly the failing slot, and plans again.
                # Each round removes a runnable slot, so this ends;
                # ensure_writable is idempotent for the rows it already did.
                draft_lens = {i: len(d) for i, d in drafts.items()} or None
                while True:
                    with tr.span("serve.plan_step"):
                        plan = sched.plan_step(draft_lens)
                    if not plan:
                        break
                    try:
                        for it in plan:
                            pool.ensure_writable(it.slot, it.q_len)
                    except PoolExhausted:
                        if tiered and spill_one(keep=0):
                            continue
                        if not preempt_victim():
                            raise
                        continue
                    break
                self._m_queue.set(len(sched.waiting))
                self._m_active.set(len(sched.active_slots()))
                if not plan:
                    if tiered and pool.suspended_slots():
                        # Nothing runnable but suspended work: spend the
                        # boundary streaming pages back (nothing to overlap
                        # with) and splice at the next one.
                        prefetch(False)
                        step += 1
                        continue
                    if sched.waiting:
                        nxt = sched.next_arrival()
                        step = max(step + 1, nxt if nxt is not None else step + 1)
                        continue
                    break
                planned = sum(it.q_len for it in plan)
                self._m_budget.set(planned / sched.token_budget)

                width = 1 if all(it.q_len == 1 for it in plan) else self._chunk
                mixed = self._mixed_step(width, pool)
                tokens = np.full((n_slots, width), self.eos, np.int32)
                qlens = np.zeros((n_slots,), np.int32)
                ladder = np.zeros((n_slots,), bool)
                n_decode = n_prefill = 0
                for it in plan:
                    st = sched.slots[it.slot]
                    if it.is_prefill:
                        seg = st.prompt[st.prompt_pos : st.prompt_pos + it.q_len]
                        tokens[it.slot, : len(seg)] = seg
                        n_prefill += it.q_len
                    else:
                        row = [int(cur[it.slot])] + drafts.get(it.slot, [])[: it.n_draft]
                        tokens[it.slot, : len(row)] = row
                        ladder[it.slot] = it.n_draft > 0
                        n_decode += it.q_len
                    qlens[it.slot] = it.q_len

                # The order in effect now (a switch after the last step
                # takes effect here): one staged int32, nothing captured.
                # A suspended row stages length 0 over its dummied table.
                order_group = ctl.effective_group(pool.blocks_per_seq)
                lens_op = pool.step_lens() if tiered else pool.lens

                def dispatch():
                    # An injected device fault fires before anything is
                    # staged or run, so the retry runs the same step on the
                    # same state.
                    if faults is not None:
                        faults.raise_if("device.step")
                    return self._run_mixed(mixed, tokens, pool, qlens, order_group, temps,
                                           seeds, counts, lens_op, ladder,
                                           overlap if tiered else None)

                # The device span closes once the sampled tokens are on the
                # host, so it brackets the step's device time; positions:
                # what the step computes (every slot at its width).
                with tr.span("serve.device_step", width=width, rows=len(plan), tokens=planned,
                             positions=n_slots * width) as args:
                    self._clock.into(args)
                    try:
                        toks = dispatch()
                    except StepCaptureError:
                        raise
                    except Exception as err:
                        # One transient failure is retried; a second fails
                        # the step's rows, and serving goes on.
                        self._m_retries.inc()
                        tr.instant("serve.step_retry", step=step, error=repr(err))
                        try:
                            toks = dispatch()
                        except StepCaptureError:
                            raise
                        except Exception as again:
                            tr.instant("serve.step_failed", step=step, error=repr(again))
                            for it in plan:
                                if sched.slots[it.slot] is not None:
                                    finish(it.slot, "failed")
                            step += 1
                            continue
                    # One reading a step: when its tokens reached the host.
                    landed = time.perf_counter_ns() - t0
                # Boundary work after the step: advance, record, finish,
                # the gauges and the order's sampling.
                with tr.span("serve.commit"):
                    step += 1
                    n_steps += 1
                    n_wide += width > 1
                    self._m_tok_decode.inc(n_decode)
                    self._m_tok_prefill.inc(n_prefill)
                    (self._m_steps_wide if width > 1 else self._m_steps_narrow).inc()
                    for it in plan:
                        st = sched.slots[it.slot]
                        pool.advance(it.slot, it.q_len)
                        if it.is_prefill:
                            st.prompt_pos += it.q_len
                            if not it.finishes_prompt:
                                continue
                            # Prompt complete: publish its frozen pages for later
                            # admissions to adopt, then take the first sample.
                            pool.register_prompt(it.slot, st.prompt)
                        if it.n_draft == 0:
                            tok = int(toks[it.slot, it.q_len - 1])
                            token_ns[id(st.request)].append(landed)
                            counts[it.slot] += 1
                            cur[it.slot] = tok
                            if st.record(tok):
                                finish(it.slot)
                            continue
                        # A verification row [cur, d_1..d_K]: target t_i =
                        # toks[slot, i] is what the sequential stream samples
                        # after the first i drafts. Accept the longest prefix
                        # with d_{i+1} == t_i, emit t_0..t_a (stopping at EOS or
                        # the limit as a sequential stream would), roll the rest
                        # of the chunk back; the sample count advances by the
                        # tokens emitted.
                        d = drafts.get(it.slot, [])[: it.n_draft]
                        k = len(d)
                        a = 0
                        while a < k and d[a] == int(toks[it.slot, a]):
                            a += 1
                        emitted = 0
                        finished = False
                        for p in range(a + 1):
                            tok = int(toks[it.slot, p])
                            token_ns[id(st.request)].append(landed)
                            emitted += 1
                            cur[it.slot] = tok
                            if st.record(tok):
                                finished = True
                                break
                        counts[it.slot] += emitted
                        n_roll = it.q_len - emitted
                        if n_roll and not finished:
                            pool.rollback(it.slot, n_roll)
                        accepted = emitted - 1
                        tally["draft"] += k
                        tally["accept"] += accepted
                        tally["roll"] += k - accepted
                        self._m_draft_tok.inc(k)
                        self._m_accept_tok.inc(accepted)
                        self._m_rollback_tok.inc(k - accepted)
                        if finished:
                            finish(it.slot)
                    if faults is not None and faults.fired_this_step:
                        # A step that absorbed a fault is followed by a pool audit.
                        pool.check_invariants()
                    pool.emit_gauges()
                    # The widest decode or verification chunk (K+1 under
                    # speculation): the query width a KV sweep is amortized over.
                    step_q = max((it.q_len for it in plan if not it.is_prefill), default=1)
                    if ctl.enabled:
                        # Adaptation samples on its own cadence: the decision
                        # needs a fresh reading, not the last gauge.
                        if ctl.maybe_adapt(n_steps, pool, self.llc, step_q=step_q):
                            tr.instant("serve.order_switch", order=ctl.order.value, step=n_steps)
                    else:
                        self.llc.maybe_sample(n_steps, pool, step_q=step_q)
            self._m_step_time.observe(time.perf_counter() - t_iter)
            if self._log_every and n_steps and n_steps % self._log_every == 0:
                self._log_stats_line(n_steps, pool, sched)

        self._m_admit_paused.set(0.0)
        by_status: dict[str, int] = {}
        for res in results.values():
            by_status[res.status] = by_status.get(res.status, 0) + 1
        self.last_stats = StepStats(
            mixed_steps=n_steps,
            wide_steps=n_wide,
            pages_adopted=pool.shared_hits,
            prompt_tokens_adopted=pool.shared_tokens,
            cow_forks=pool.cow_forks,
            preemptions=tally["preempt"],
            restore_tokens=tally["restore"],
            shed=by_status.get("shed", 0),
            deadline_miss=by_status.get("deadline", 0),
            cancelled=by_status.get("cancelled", 0),
            failed=by_status.get("failed", 0),
            spills=getattr(pool, "spills", 0),
            tier_fetches=getattr(pool, "fetches", 0),
            prefetch_hits=getattr(pool, "prefetch_hits", 0),
            prefetch_wasted=getattr(pool, "prefetch_wasted", 0),
            draft_tokens=tally["draft"],
            accepted_tokens=tally["accept"],
            rollback_tokens=tally["roll"],
        )
        return [results[id(r)] for r in requests]

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
