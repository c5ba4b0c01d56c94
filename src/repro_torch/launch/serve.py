"""Serving launcher: init params from a seed and serve synthetic requests
through the port's ServeEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
      --page-size 64 --max-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
      --reduced --device cpu --scheduler static

``--scheduler auto`` (the default) picks the continuous scheduler where the
config supports it and the static one otherwise, as the JAX launcher does.

The flags are the JAX launcher's (``repro.launch.serve``) plus ``--device``
(default ``cuda``; with no GPU the launcher raises unless ``--device cpu``
is given). ``--ckpt-dir D`` serves the params of the newest checkpoint
under D (one the port's or the JAX package's training wrote), or the
seed's where D holds none. ``--attn-order auto`` turns on online order adaptation
(``serve.adapt``): the engine seeds its first order from
``--autotune-cache`` and re-picks it every ``--adapt-epoch`` mixed steps
from the modeled-LLC gauges that ``--llc-every`` also samples.
``--admission optimistic`` lets decode growth oversubscribe the pool
(``--pool-pages`` below the worst case makes the pressure real) and
preempts up to ``--max-preemptions`` times a request; ``--chaos-step-fail
N`` injects one device-step failure at mixed step N (retried once).
``--host-pages N`` backs the pool with an N-page host tier: at
``--spill-watermark`` occupancy the coldest slot spills to pinned host
memory instead of being preempted, and comes back ``--prefetch-depth``
pages a step boundary; ``--chaos-fetch-fail N`` drops N page fetches and
``--chaos-spill-stall N`` refuses N spills (the engine then preempts).
``--draft ngram|model`` turns on speculative decoding with ``--draft-len``
drafts a row (``model``: ``--draft-model ARCH``, by default the serving
model itself, self-speculation).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.schedule import Order
from repro_torch.models import build_model
from repro_torch.serve import (
    FaultPlan,
    Request,
    ServeEngine,
    make_drafter,
    supports_continuous,
)
from repro_torch.train.checkpoint import latest_step, restore_pytree

_AUTOTUNE_CACHE = "artifacts/hillclimb/autotune_cache.jsonl"


def pick_scheduler(choice: str, cfg) -> str:
    """``auto`` -> continuous where ``supports_continuous(cfg)``, else static."""
    if choice != "auto":
        return choice
    ok = supports_continuous(cfg)
    if not ok:
        print(
            f"scheduler=auto: {cfg.name} (family={cfg.family}, window={cfg.window}) "
            "does not support continuous batching; using static groups"
        )
    return "continuous" if ok else "static"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=None, help="restore params from here")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--attn-order", default="sawtooth",
                    choices=[o.value for o in Order] + ["auto"],
                    help="KV traversal order of the paged attention walk; 'auto' "
                         "enables online adaptation (seeded from the autotune cache, "
                         "re-picked from the live modeled-LLC gauges every "
                         "--adapt-epoch steps)")
    ap.add_argument("--snake-group", type=int, default=None,
                    help="block_snake reversal window in KV pages")
    ap.add_argument("--adapt-epoch", type=int, default=8)
    ap.add_argument("--adapt-hysteresis", type=float, default=0.05)
    ap.add_argument("--adapt-confirm", type=int, default=2)
    ap.add_argument("--autotune-cache", default=_AUTOTUNE_CACHE, metavar="PATH")
    ap.add_argument("--scheduler", default="auto", choices=["auto", "static", "continuous"])
    ap.add_argument("--page-size", type=int, default=None, help="KV page rows")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="tokens per ragged mixed step (default: batch size + one chunk)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per prefill chunk (default: 4 pages)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable prefix-page sharing / copy-on-write dedup")
    ap.add_argument("--admission", default="reserve", choices=["reserve", "optimistic"])
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound on the arrived waiting queue (newest are shed)")
    ap.add_argument("--admit-watermark", type=float, default=None,
                    help="pool-occupancy fraction at which admission pauses")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock deadline from engine start")
    ap.add_argument("--max-preemptions", type=int, default=2)
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="allocatable KV pool pages (default: every slot's worst case)")
    ap.add_argument("--host-pages", type=int, default=None,
                    help="host page tier capacity in pages (default: no tier); cold "
                         "slots spill there instead of being preempted")
    ap.add_argument("--spill-watermark", type=float, default=None,
                    help="pool occupancy at which the coldest slot spills (default: "
                         "min(0.85, admit watermark); needs --host-pages)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="host pages fetched back a step boundary while a spilled slot "
                         "resumes, in the next step's visit order")
    ap.add_argument("--draft", default="none", choices=["none", "ngram", "model"],
                    help="speculative decoding drafter (continuous scheduler): 'ngram' "
                         "looks up the row's own stream, 'model' runs a draft model")
    ap.add_argument("--draft-len", type=int, default=4, metavar="K",
                    help="draft tokens a decode row a step, verified as one q_len K+1 "
                         "chunk")
    ap.add_argument("--draft-model", default=None, metavar="ARCH",
                    help="arch of --draft model (reduced like the target, weights from "
                         "seed 1; default: the serving model itself)")
    ap.add_argument("--chaos-step-fail", type=int, default=0, metavar="N",
                    help="inject one transient device-step failure at mixed step N "
                         "(retried once)")
    ap.add_argument("--chaos-fetch-fail", type=int, default=0, metavar="N",
                    help="drop N host-to-device page fetches (requeued and retried; "
                         "needs --host-pages)")
    ap.add_argument("--chaos-spill-stall", type=int, default=0, metavar="N",
                    help="refuse N slot spills (the engine preempts instead; needs "
                         "--host-pages)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the obs metrics registry as JSONL here")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the span trace as Chrome-trace JSON here")
    ap.add_argument("--llc-every", type=int, default=8,
                    help="llc.* gauge sampling cadence in mixed steps (0 disables)")
    ap.add_argument("--llc-capacity-mib", type=float, default=None,
                    help="modeled LLC capacity of the llc.* gauges (MiB)")
    ap.add_argument("--log-every", type=int, default=0, metavar="STEPS",
                    help="print a one-line stats summary every N mixed steps")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.attn_order == "block_snake" and args.snake_group is None:
        valid = ", ".join(repr(o.value) for o in Order)
        ap.error(
            "traversal order 'block_snake' needs --snake-group (the reversal "
            f"window in KV pages); valid orders are: {valid}"
        )
    adapt = args.attn_order == "auto"

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not adapt:
        # 'auto' starts from the arch's configured order, which the
        # controller may re-seed from the cache and re-pick from there.
        cfg = cfg.with_(attn_order=args.attn_order)
    cfg = cfg.with_(snake_group=args.snake_group)
    lm = build_model(cfg, device=args.device)
    params = lm.init(0)
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, step = restore_pytree({"params": params}, args.ckpt_dir)
        params = state["params"]
        print(f"restored params from step {step}")
    drafter = None
    if args.draft != "none":
        draft_lm, draft_params = lm, params
        if args.draft == "model" and args.draft_model:
            draft_cfg = get_config(args.draft_model)
            if args.reduced:
                draft_cfg = draft_cfg.reduced()
            draft_lm = build_model(draft_cfg, device=args.device)
            draft_params = draft_lm.init(1)
        drafter = make_drafter(args.draft, lm=draft_lm, params=draft_params,
                               n_slots=args.batch_size, max_len=args.max_len,
                               page_size=args.page_size, prefill_chunk=args.prefill_chunk)
    faults = None
    if args.chaos_fetch_fail > 0 or args.chaos_spill_stall > 0 or args.chaos_step_fail > 0:
        faults = FaultPlan()
        if args.chaos_fetch_fail > 0:
            faults.fetch_fail(0, times=args.chaos_fetch_fail)
        if args.chaos_spill_stall > 0:
            faults.spill_stall(0, times=args.chaos_spill_stall)
        if args.chaos_step_fail > 0:
            faults.fail_device_step(args.chaos_step_fail)

    eng = ServeEngine(
        lm,
        params,
        batch_size=args.batch_size,
        max_len=args.max_len,
        scheduler=pick_scheduler(args.scheduler, cfg),
        page_size=args.page_size,
        token_budget=args.token_budget,
        prefill_chunk=args.prefill_chunk,
        prefix_sharing=not args.no_prefix_sharing,
        llc_every=args.llc_every,
        llc_capacity_bytes=args.llc_capacity_mib * 2**20 if args.llc_capacity_mib else None,
        log_every_steps=args.log_every,
        adapt_order=adapt,
        adapt_epoch=args.adapt_epoch,
        adapt_hysteresis=args.adapt_hysteresis,
        adapt_confirm=args.adapt_confirm,
        autotune_cache=args.autotune_cache,
        admission=args.admission,
        max_queue=args.max_queue,
        admit_watermark=args.admit_watermark,
        max_preemptions=args.max_preemptions,
        pool_pages=args.pool_pages,
        host_pages=args.host_pages,
        spill_watermark=args.spill_watermark,
        prefetch_depth=args.prefetch_depth,
        drafter=drafter,
        draft_len=args.draft_len,
        faults=faults,
        device=args.device,
    )
    if adapt and eng.order_ctl is not None:
        seeded = ("seeded from autotune cache" if eng.order_ctl.seeded_from
                  else "no autotune-cache hit")
        print(f"order adaptation on: starting order={eng.order_ctl.order.value} ({seeded}), "
              f"epoch={args.adapt_epoch}, hysteresis={args.adapt_hysteresis}, "
              f"confirm={args.adapt_confirm}")
    rng = np.random.default_rng(0)
    reqs = [
        Request(
            tokens=rng.integers(2, cfg.vocab, size=rng.integers(4, 32)).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=args.temperature,
            rid=i,
            deadline_s=args.deadline_s,
        )
        for i in range(args.requests)
    ]
    t0 = time.time()
    results = eng.generate(reqs)
    dt = time.time() - t0
    ok = [r for r in results if r.status == "ok"]
    tok = sum(r.steps for r in results)
    print(f"served {len(results)} requests, {tok} tokens in {dt:.2f}s ({tok/dt:.1f} tok/s)")
    if len(ok) < len(results):
        by: dict[str, int] = {}
        for r in results:
            by[r.status] = by.get(r.status, 0) + 1
        print("  statuses: " + ", ".join(f"{k}={v}" for k, v in sorted(by.items())))
    stats = eng.last_stats
    if stats is not None:
        print(
            f"  {stats.mixed_steps} mixed steps ({stats.wide_steps} wide), "
            f"{stats.pages_adopted} prefix pages adopted "
            f"({stats.prompt_tokens_adopted} tokens), "
            f"{stats.cow_forks} CoW forks"
        )
        if stats.preemptions or stats.shed or stats.deadline_miss or stats.failed:
            print(
                f"  resilience: {stats.preemptions} preemptions "
                f"({stats.restore_tokens} tokens re-prefilled), "
                f"{stats.shed} shed, {stats.deadline_miss} deadline, "
                f"{stats.cancelled} cancelled, {stats.failed} failed"
            )
        if stats.draft_tokens:
            print(
                f"  speculative: {stats.draft_tokens} drafted, "
                f"{stats.accepted_tokens} accepted ({stats.acceptance_rate:.0%}), "
                f"{stats.rollback_tokens} rolled back"
            )
        if stats.spills or stats.tier_fetches:
            hit_rate = stats.prefetch_hits / max(stats.tier_fetches, 1)
            print(
                f"  tiering: {stats.spills} spills, {stats.tier_fetches} fetches "
                f"(hit rate {hit_rate:.0%}, {stats.prefetch_wasted} wasted)"
            )
    for r in results[:4]:
        print(f"  rid={r.rid} -> {r.tokens.tolist()}")

    if args.metrics_out:
        from repro_torch.obs import write_metrics_jsonl

        n = write_metrics_jsonl(eng.obs, args.metrics_out, extra={"arch": args.arch})
        print(f"wrote {n} metric series -> {args.metrics_out}")
    if args.trace_out:
        eng.tracer.write(args.trace_out)
        print(f"wrote {len(eng.tracer.events())} trace events -> {args.trace_out}")


if __name__ == "__main__":
    main()
