"""Fault-tolerant training loop: checkpoint/resume, watchdog, injection.

A port of ``repro.train.loop``: build the step, restore the latest
checkpoint or initialize, place the state on the mesh (``mesh``; None
trains on one device), iterate over the data with a watchdog,
checkpoint on a cadence, and on a failure stop with ``interrupted=True``
after a final checkpoint, so that the next run resumes from it. A
``RuntimeError`` inside a step counts as a failure, as in the reference; a
refused kernel launch raises one too, so a caller that needs every step
must check ``interrupted`` and the number of losses. A failure inside the
optimizer's in-place update (``PartialUpdate``) leaves a state that is no
step's, so that failure writes no final checkpoint and the next run resumes
from the last one written.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.data.pipeline import DataConfig, make_batch_iterator
from repro_torch.models.model import LM
from repro_torch.obs import Registry, Tracer
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import FailureInjector, StepTimeout, Watchdog
from repro_torch.train.step import (
    PartialUpdate,
    check_device,
    make_train_state,
    make_train_step,
    shard_state,
)

log = logging.getLogger(__name__)

__all__ = ["TrainResult", "run_training"]


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: list
    resumed_from: Optional[int]
    interrupted: bool = False
    registry: Optional[Registry] = None   # step metrics
    tracer: Optional[Tracer] = None       # step/checkpoint spans


def _batch_tokens(batch) -> int:
    """Token count of one batch (throughput accounting): the ``tokens``
    leaf when present, else the largest integer leaf's element count."""
    if isinstance(batch, dict):
        if "tokens" in batch:
            return int(np.prod(np.shape(batch["tokens"])))
        sizes = [
            int(np.prod(np.shape(v)))
            for v in batch.values()
            if np.issubdtype(np.asarray(v).dtype, np.integer)
        ]
        return max(sizes, default=0)
    return 0


def run_training(
    lm: LM,
    tcfg: TrainConfig,
    pcfg: ParallelConfig = ParallelConfig(),
    mesh=None,
    *,
    device="cuda",
    steps: Optional[int] = None,
    data_cfg: Optional[DataConfig] = None,
    injector: Optional[FailureInjector] = None,
    step_timeout_s: float = 0.0,
    log_every: int = 10,
    make_batch: Optional[Callable[[int], dict]] = None,
    registry: Optional[Registry] = None,
    tracer: Optional[Tracer] = None,
) -> TrainResult:
    """Train ``lm`` for ``steps`` (default ``tcfg.total_steps``) on
    ``data_cfg``'s synthetic batches or ``make_batch(step)``. ``device``
    must be the model's; it defaults to ``"cuda"`` and raises without a GPU
    unless the caller names the CPU. With ``mesh`` (a ``DeviceMesh``) every
    rank of it calls this with the same arguments: the state is sharded by
    ``pcfg`` after init or restore, each step takes the whole batch and
    keeps its rank's shard, and rank 0 writes the checkpoints."""
    check_device(lm, device)
    steps = steps or tcfg.total_steps
    ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)

    # Telemetry: per-step time/loss/grad-norm metrics and step/checkpoint
    # spans, in-process (export is the caller's choice, e.g. the launcher's
    # --metrics-out).
    obs = registry if registry is not None else Registry()
    tr = tracer if tracer is not None else Tracer()
    m_steps = obs.counter("train.steps")
    m_tokens = obs.counter("train.tokens")
    m_retries = obs.counter("train.steps", event="watchdog_retry")
    m_step_time = obs.histogram("train.step_time_s")
    g_loss = obs.gauge("train.loss")
    g_gnorm = obs.gauge("train.grad_norm")
    g_lr = obs.gauge("train.lr")
    g_tput = obs.gauge("train.throughput_tokens_per_s")

    state = make_train_state(lm, tcfg, tcfg.seed, device=device)
    resumed_from = None
    if ckpt.latest_step() is not None:
        with tr.span("train.restore"):
            state, resumed = ckpt.restore_latest(state)
        resumed_from = resumed
        log.info("resumed from step %d", resumed)
    if mesh is not None:
        state = shard_state(state, pcfg, mesh)
    start = resumed_from + 1 if resumed_from is not None else 0

    src = None
    if make_batch is None:
        if data_cfg is None:
            raise ValueError("run_training needs data_cfg or make_batch")
        src = make_batch_iterator(data_cfg, start_step=start)
        batch_fn = lambda step: next(src)
    else:
        batch_fn = make_batch

    step_fn = make_train_step(lm, tcfg, pcfg, mesh)
    batch0 = batch_fn(start)
    losses = []
    interrupted = False
    state_clean = True
    t0 = time.time()
    i = start
    try:
        while i < steps:
            batch = batch_fn(i) if i != start else batch0
            t_step = time.perf_counter()
            try:
                if injector is not None:
                    injector.maybe_fail(i)
                # The span closes after float(loss), which waits for the
                # card, so it covers the step's device time, not its launch.
                with tr.span("train.step", step=i):
                    if step_timeout_s > 0:
                        with Watchdog(step_timeout_s):
                            state, metrics = step_fn(state, batch)
                            loss = float(metrics["loss"])  # blocks inside the watchdog
                    else:
                        state, metrics = step_fn(state, batch)
                        loss = float(metrics["loss"])
            except StepTimeout:
                log.warning("step %d hit watchdog; re-running batch", i)
                tr.instant("train.watchdog_retry", step=i)
                m_retries.inc()
                continue  # straggler mitigation: redo the step
            except RuntimeError as e:
                state_clean = not isinstance(e, PartialUpdate)
                log.error("step %d failed: %s — %s", i, e, "checkpoint + stop" if state_clean
                          else "stop; the state is half-updated, so no final checkpoint")
                tr.instant("train.failure", step=i)
                interrupted = True
                break
            dt_step = time.perf_counter() - t_step
            n_tok = _batch_tokens(batch)
            m_steps.inc()
            m_tokens.inc(n_tok)
            m_step_time.observe(dt_step)
            g_loss.set(loss)
            if "grad_norm" in metrics:
                g_gnorm.set(float(metrics["grad_norm"]))
            if "lr" in metrics:
                g_lr.set(float(metrics["lr"]))
            if dt_step > 0 and n_tok:
                g_tput.set(n_tok / dt_step)
            losses.append(loss)
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {i}: {loss}")
            if log_every and i % log_every == 0:
                log.info("step %d loss %.4f (%.2fs elapsed)", i, loss, time.time() - t0)
            if tcfg.checkpoint_every and (i + 1) % tcfg.checkpoint_every == 0:
                with tr.span("train.checkpoint", step=i):
                    ckpt.save(state, i)
            i += 1

        if state_clean:
            with tr.span("train.checkpoint", step=max(i - 1, 0), final=True):
                ckpt.save(state, max(i - 1, 0), blocking=True)
        else:
            ckpt.wait()
    finally:
        if src is not None:
            src.close()
    return TrainResult(
        final_step=i - 1,
        losses=losses,
        resumed_from=resumed_from,
        interrupted=interrupted,
        registry=obs,
        tracer=tr,
    )
