"""One run of one cell: set-up, the measured window of waves, the traced
wave, the check against the plain reference, and the result line.

A wave is one ``ServeEngine.generate()`` call of the cell's ``wave``
requests, all arriving at its start (a burst of users), each greedy and
running to its drawn output length (``eos_id=-1``). Waves run back to back
until ``seconds`` have passed since the first began; the window is whole
waves. With ``trace`` one more wave runs under the profiler after them.

What a configuration runs and is judged by (``Model``: the port's config,
the weights, the plain reference) is this module's ``port_config``,
``bench.weights.Weights`` and ``bench.reference.model.logits_at``, unless
its file names a module that defines its own (``model_of``).

Only ``run.py``'s ``main`` looks for the card; the tests drive
``run_cell`` on the CPU at a reduced size.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from bench import traffic
from bench.counts import Shapes
from bench.profiling import DeviceProfile, profile_call
from bench.reference.check import numbers, served_sequence, token_gaps
from bench.reference.model import logits_at
from bench.spec import Cell, load_module, load_reader
from bench.weights import Weights

__all__ = ["Served", "WaveRecord", "RunRecord", "Model", "model_of", "port_config", "Bench",
           "run_cell", "forbidden_modules", "FORBIDDEN"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Served:
    """One request as the program served it."""
    prompt: np.ndarray     # the prompt as the program ran it (static: left-padded)
    prompt_len: int        # the request's own prompt length
    want: int              # output length asked for
    tokens: np.ndarray     # served tokens
    ttft_s: float          # the engine's GenerationResult fields
    tpot_s: float
    status: str


@dataclasses.dataclass
class WaveRecord:
    start: float           # host clock at generate() call and return
    end: float
    served: list[Served]
    spans: list            # the engine's SpanEvents of the wave
    stats: object          # the engine's StepStats (continuous), else None


@dataclasses.dataclass
class RunRecord:
    """What the per-layer readers read."""
    cell: Cell
    shapes: Shapes
    waves: list[WaveRecord]            # the window's waves, unprofiled
    profiled: Optional[WaveRecord]     # the traced wave
    profile: Optional[DeviceProfile]   # its device profile (the card only)

    @property
    def window_s(self) -> float:
        return self.waves[-1].end - self.waves[0].start


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def port_config(c: dict):
    """The port's ``ModelConfig`` for a configuration file: the file's
    sizes on the family of the port's config named ``port_arch``."""
    from repro_torch.configs.registry import get_config

    base = get_config(c["port_arch"])
    s = Shapes.from_config(c)
    kw = dict(n_layers=s.layers, d_model=s.d, n_heads=s.heads, n_kv_heads=s.kv_heads,
              head_dim=s.head_dim, d_ff=s.d_ff, vocab=s.vocab, rope_theta=float(c["rope_theta"]),
              norm_eps=float(c["rms_norm_eps"]), tie_embeddings=bool(c["tie_word_embeddings"]),
              dtype=c["dtype"], param_dtype=c["dtype"])
    if s.experts:
        kw["moe"] = dataclasses.replace(base.moe, num_experts=s.experts, top_k=s.top_k,
                                        d_ff_expert=s.d_ff_expert)
    if c["tie_word_embeddings"]:
        raise ValueError("tied embeddings are not laid out by bench.weights")
    return base.with_(**kw)


@dataclasses.dataclass(frozen=True)
class Model:
    """What one configuration file runs and is judged by:
    ``port_config(c) -> ModelConfig``; ``Weights(shapes, c, *, device,
    dtype)``, whose ``.params`` are in the port's layout, ``.fill(seed)``
    draws them anew in place and ``.device`` is where they live; and
    ``logits_at(params, c, seqs, *, fp8=False)``, the plain float32 forward
    (TF32 off) and, with ``fp8``, its e4m3 control."""
    port_config: Callable
    Weights: type
    logits_at: Callable


def model_of(config: dict) -> Model:
    """Each of the three from the module the file names (``"module"``),
    where that module defines it, else the default."""
    mod = load_module(config)
    return Model(getattr(mod, "port_config", port_config), getattr(mod, "Weights", Weights),
                 getattr(mod, "logits_at", logits_at))


class Bench:
    """The engine of one cell on its weights, and the waves it serves."""

    def __init__(self, cell: Cell, device: str):
        from repro_torch.models.model import build_model
        from repro_torch.obs.trace import Tracer
        from repro_torch.serve import ServeEngine

        self.cell = cell
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # A checkout's first run builds every kernel of the port at once,
            # so that no later run, of this cell or another, compiles.
            from repro_torch.kernels.cuda_lib import build_all

            build_all()
        self.shapes = Shapes.from_config(cell.config)
        model = model_of(cell.config)
        self.cfg = model.port_config(cell.config).with_(**cell.settings.get("model", {}))
        e = dict(cell.settings["engine"])
        scheduler = e.pop("scheduler")
        self.slots, self.max_len = int(e.pop("slots")), int(e.pop("max_len"))
        self.continuous = scheduler == "continuous"
        self.sizes = traffic.request_sizes(cell.mix, int(cell.settings["wave"]), self.max_len)
        dtype = getattr(torch, cell.config["dtype"])
        self.weights = model.Weights(self.shapes, cell.config, device=self.device, dtype=dtype)
        self.tracer = Tracer(capacity=1 << 20)
        drafter = cell.settings.get("drafter")
        if drafter:
            from repro_torch.serve import make_drafter

            e["drafter"] = make_drafter(drafter["kind"], n_slots=self.slots,
                                        max_len=self.max_len,
                                        ngram_max=int(drafter.get("ngram_max", 4)))
            e["draft_len"] = int(drafter.get("draft_len", 4))
        self.engine = ServeEngine(
            build_model(self.cfg, device=self.device), self.weights.params,
            batch_size=self.slots, max_len=self.max_len, scheduler=scheduler,
            tracer=self.tracer, device=self.device, **e)
        self.pad = self.cfg.eos_id

    def _requests(self, wave):
        from repro_torch.serve import Request

        return [Request(tokens=r.tokens, max_new_tokens=r.max_new, temperature=0.0, rid=i,
                        eos_id=-1) for i, r in enumerate(wave)]

    def warm_up(self) -> None:
        """Capture and warm the shapes the cell's traffic uses: the
        continuous engine's two mixed-step widths (a prompt of more than
        one token runs at the chunk width, a decode step at width 1); the
        static engine's prefill at the wave's bucket and its decode step."""
        if self.continuous:
            wave = [traffic.WaveRequest(np.full(8, 2, np.int32), 3)]
        else:
            bucket = max(s.prompt for s in self.sizes)
            wave = [traffic.WaveRequest(np.full(bucket, 2, np.int32), 2)] * self.slots
        self.engine.generate(self._requests(wave))
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def serve(self, wave, profiled: bool = False):
        """One wave -> (WaveRecord, DeviceProfile or None)."""
        reqs = self._requests(wave)
        self.tracer.clear()
        prof = None
        start = time.perf_counter()
        if profiled and self.device.type == "cuda":
            results, prof = profile_call(lambda: self.engine.generate(reqs), self.tracer)
        else:
            results = self.engine.generate(reqs)
            self.sync()
        end = time.perf_counter()
        served = []
        for i, (w, res) in enumerate(zip(wave, results)):
            prompt = w.tokens
            if not self.continuous:   # left-padded into its group's bucket
                group = wave[i - i % self.slots:][:self.slots]
                bucket = min(max(len(g.tokens) for g in group), self.max_len)
                prompt = np.concatenate([np.full(bucket - len(prompt), self.pad, np.int32),
                                         prompt[-bucket:]])
            served.append(Served(prompt, len(w.tokens), w.max_new, np.asarray(res.tokens),
                                 float(res.ttft_s), float(res.tpot_s), res.status))
        stats = self.engine.last_stats if self.continuous else None
        return WaveRecord(start, end, served, self.tracer.events(), stats), prof

    def wave(self, seed: int, index: int):
        return traffic.make_wave(self.cell.mix, self.sizes, seed, index, self.shapes.vocab)

    def free(self) -> None:
        """Drop the program's state (its engine, pools, caches, graphs); the
        weights stay for the reference."""
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def sample(served: list[Served], n: int, seed: int) -> list[Served]:
    """The requests the check compares: the finished one with the most
    served tokens, and n - 1 others drawn from the seed."""
    done = [s for s in served if s.status == "ok" and len(s.tokens)]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (len(done[i].tokens), done[i].prompt_len))
    rest = [i for i in range(len(done)) if i != longest]
    pick = traffic.rng_for(seed, 2).permutation(len(rest))[: max(n - 1, 0)]
    return [done[longest]] + [done[rest[i]] for i in sorted(pick)]


def reference_numbers(weights, config: dict, chosen: list[Served], *,
                      control: bool = False) -> dict:
    """The compared numbers of the chosen requests under the configuration's
    plain reference; with ``control`` those of the tokens its fp8 control
    puts first, at the same positions."""
    ref_logits = model_of(config).logits_at
    seqs = [served_sequence(s.prompt, s.tokens, weights.device) for s in chosen]
    ref = ref_logits(weights.params, config, seqs)
    if control:
        ctl = ref_logits(weights.params, config, seqs, fp8=True)
        return numbers([token_gaps(r, c.argmax(dim=-1)) for r, c in zip(ref, ctl)])
    return numbers([token_gaps(r, s.tokens) for r, s in zip(ref, chosen)])


def end_to_end(run: RunRecord, setup_s: float) -> dict:
    tokens = sum(len(s.tokens) for w in run.waves for s in w.served)
    return {"tokens_per_s": tokens / run.window_s, "setup_s": setup_s}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t0: Optional[float] = None) -> tuple[dict, dict]:
    """One run: (the result line's object, what else the run saw)."""
    t0 = time.perf_counter() if t0 is None else t0
    phases = {"start": time.perf_counter() - t0}
    b = Bench(cell, device)
    phases["engine"] = time.perf_counter() - t0
    b.weights.fill(seed)
    b.sync()
    phases["weights"] = time.perf_counter() - t0
    b.warm_up()
    waves: list[WaveRecord] = []
    first = time.perf_counter()
    setup_s = phases["warm_up"] = first - t0
    while not waves or waves[-1].end - first < seconds:
        waves.append(b.serve(b.wave(seed, len(waves)))[0])
    profiled, prof = b.serve(b.wave(seed, len(waves)), profiled=True) if trace else (None, None)
    run = RunRecord(cell, b.shapes, waves, profiled, prof)
    peak = torch.cuda.max_memory_allocated() if b.device.type == "cuda" else 0

    served = [s for w in waves + ([profiled] if profiled else []) for s in w.served]
    attempted = len(served)
    failed = sum(s.status != "ok" or len(s.tokens) != s.want for s in served)
    b.free()
    check = cell.settings["check"]
    chosen = sample(served, int(check["requests"]), seed)
    read = reference_numbers(b.weights, cell.config, chosen) if chosen else {}
    compared = {name: {"value": read.get(name), "limit": float(limit)}
                for name, limit in check["limits"].items()}
    sound = all(c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = end_to_end(run, setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if b.device.type == "cuda" else b.device.type,
           "kind": torch.cuda.get_device_name(0) if b.device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(sound and failed == 0 and attempted > 0),
           "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if prof is not None:
        dev.update(busy_s=prof.busy_s, window_s=prof.wall_s)
        out["breakdown"] = prof.breakdown()
    info = {"setup_s": phases, "window_s": run.window_s, "waves": len(waves),
            "wave_s": [w.end - w.start for w in waves],
            "compared": len(chosen), "numbers": read,
            "device_records": prof.records if prof else None}
    out["checks"] = dict(compared, failed_requests={"value": failed, "limit": 0})
    return out, info
