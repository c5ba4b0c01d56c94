"""Multi-pod dry-run: trace every (arch × input-shape × mesh) cell on a fake
process group of 256 or 512 ranks, without allocating anything.

A port of ``repro.launch.dryrun``. For each cell this
  1. joins a fake process group of the mesh's size as rank 0
     (:func:`fake_world`: backend ``"fake"`` on a ``FakeStore``, from
     ``torch.testing._internal.distributed.fake_pg``, whose collectives
     return at once and move nothing) and builds the 16x16 single-pod or
     the 2x16x16 multi-pod ``DeviceMesh`` through
     ``launch.mesh.make_production_mesh``;
  2. under ``FakeTensorMode`` (no tensor holds memory) builds the full-size
     model, places the params (and the optimizer state) as DTensors on the
     port's own ``dist.sharding`` specs, and runs one call of the step the
     shape names -- ``train.step.make_train_step``, ``make_serve_steps``'
     prefill, or its decode step over the caches a prefill built -- under
     ``analysis.trace.RankTrace``, which records rank 0's local ops;
  3. records the local bytes of the arguments and outputs, the peak of the
     live intermediates, flops and bytes accessed, collective bytes by kind
     and the roofline terms at the H100's constants into
     ``artifacts/dryrun_torch/<cell>.json``;
  4. leaves the process group, on an error too.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m \\
      --shape decode_32k --mesh single --out /tmp/dry --no-resume

The model's attention runs the plain ``reference`` impl (the reference
traces ``attn_impl="xla"``): no kernel runs on fake tensors, and the trace
needs no card. The layers are Python lists, so the trace unrolls every
layer: a full-depth trace holds the depth-1/2 extrapolation
(``extrapolate_cell``) to account. Importing this module joins no group and
sets nothing (the reference sets ``XLA_FLAGS`` on import). The fake group is
process-wide state, so a process runs one cell at a time and belongs to no
other group meanwhile.

long_500k is skipped (and recorded as such) for pure full-attention archs;
SWA / SSM / hybrid archs run it (DESIGN.md §5).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.analysis import roofline as rf
from repro_torch.analysis import trace as trace_mod
from repro_torch.configs import ARCH_IDS, SHAPES, ParallelConfig, TrainConfig, get_config
from repro_torch.dist import sharding as shd
from repro_torch.dist.context import activation_rules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.train.step import (
    make_serve_steps,
    make_train_state,
    make_train_step,
    place_batch,
    shard_state,
)

DEFAULT_OUT = "artifacts/dryrun_torch"

# archs where long_500k decode is meaningful (sub-quadratic / bounded KV)
LONG_OK = {"mixtral-8x7b", "mamba2-130m", "zamba2-2_7b"}
ALL_ARCHS = [a for a in ARCH_IDS if a != "paper-gb10"]
MESH_RANKS = {"single": 256, "multi": 512}


@contextlib.contextmanager
def fake_world(world_size: int):
    """Join a fake process group of ``world_size`` ranks as rank 0 for the
    block, and leave it after, on an error too. Raises if this process
    already belongs to a group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("the dry-run joins a fake process group of its own; this process "
                           "already belongs to one")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dryrun_parallel_cfg(mesh, shape_kind: str, overrides: dict | None = None) -> ParallelConfig:
    kw: dict = {}
    if "pod" not in mesh.mesh_dim_names:
        kw["fsdp_axes"] = ("data",)
        kw["data_axes"] = ("data",)
    if shape_kind == "train":
        kw["microbatches"] = 8
    if overrides:
        kw.update(overrides)
    return ParallelConfig(**kw)


def cfg_for_dryrun(arch: str, overrides: dict | None = None):
    cfg = get_config(arch)
    kw = dict(attn_impl="reference", remat="full")
    if overrides:
        kw.update(overrides)
    return cfg.with_(**kw)


def _cell_cfg(arch: str, overrides: dict | None, reduced: bool):
    """The cell's config: ``cfg_for_dryrun``'s, or with ``reduced`` its
    ``.reduced()`` form (remat none, as the reference's) with ``overrides``
    applied after the reduction, so a reduced cell can still set its
    depth."""
    if not reduced:
        return cfg_for_dryrun(arch, overrides)
    return cfg_for_dryrun(arch).reduced().with_(attn_impl="reference", **(overrides or {}))


def local_bytes(*trees) -> int:
    """Bytes of the distinct storages behind the tensors of ``trees``, a
    DTensor counting its local shard: what one rank holds of them."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    seen: dict[int, int] = {}
    for t in tree_leaves(trees):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _activation_rules(pcfg: ParallelConfig, mesh):
    if not pcfg.seq_shard_activations:
        return None
    names = mesh.mesh_dim_names
    dp = tuple(a for a in pcfg.data_axes if a in names)
    tp = pcfg.tensor_axis
    return {
        "residual": shd.P(dp, tp, None),
        "moe_tokens": shd.P((dp + (tp,)) if tp in names else dp, None),
    }


def lower_cell(
    arch: str,
    shape_name: str,
    mesh,
    mesh_name: str,
    *,
    cfg_overrides: dict | None = None,
    par_overrides: dict | None = None,
    shape_overrides: dict | None = None,
    train_cfg: TrainConfig | None = None,
    reduced: bool = False,
):
    """Trace one cell on ``mesh`` (a ``DeviceMesh`` over a fake group, see
    :func:`fake_world`). ``shape_overrides`` replaces fields of the shape
    (``seq_len``, ``global_batch``), ``train_cfg`` the training step's
    ``TrainConfig()``. Returns (record dict, ``analysis.trace.RankTrace``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape = SHAPES[shape_name]
    cfg = _cell_cfg(arch, cfg_overrides, reduced)
    if reduced:
        shape = shape.reduced()
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    pcfg = dryrun_parallel_cfg(mesh, shape.kind, par_overrides)
    tr = trace_mod.RankTrace()

    t0 = time.perf_counter()
    with FakeTensorMode(), activation_rules(_activation_rules(pcfg, mesh)):
        lm = build_model(cfg, device="cpu")
        batch = lm.input_specs(shape)
        if shape.kind == "train":
            if shape.global_batch % max(pcfg.microbatches, 1):
                pcfg = dataclasses.replace(pcfg, microbatches=1)
            tcfg = train_cfg or TrainConfig()
            state = shard_state(make_train_state(lm, tcfg, 0, device="cpu"), pcfg, mesh)
            step = make_train_step(lm, tcfg, pcfg, mesh)
            arg_bytes = local_bytes(state, place_batch(batch, pcfg, mesh, "cpu"))
            alias_bytes = local_bytes(state)
            t_setup = time.perf_counter() - t0
            t0 = time.perf_counter()
            with tr:
                outputs = step(state, batch)
        else:
            params = lm.init(0)
            params = shd.distribute(params, shd.param_specs(params, pcfg, mesh), mesh)
            prefill, decode = make_serve_steps(lm, pcfg, mesh, max_len=shape.seq_len)
            if shape.kind == "prefill":
                arg_bytes = local_bytes(params, place_batch(batch, pcfg, mesh, "cpu"))
                alias_bytes = 0
                t_setup = time.perf_counter() - t0
                t0 = time.perf_counter()
                with tr:
                    outputs = prefill(params, batch)
            else:  # decode: the prefill only builds the caches, untraced
                _, caches = prefill(params, batch)
                tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32)
                arg_bytes = local_bytes(params, tokens, caches)
                alias_bytes = local_bytes(caches)
                t_setup = time.perf_counter() - t0
                t0 = time.perf_counter()
                with tr:
                    outputs = decode(params, tokens, caches)
        t_lower = time.perf_counter() - t0
        out_bytes = local_bytes(outputs)

    cost = trace_mod.cost(tr)
    coll = trace_mod.collective_bytes(tr)
    chips = mesh.size()
    terms = rf.analyze(
        arch=arch,
        shape=shape_name,
        mesh_name=mesh_name,
        chips=chips,
        cost=cost,
        coll=coll,
        cfg=cfg,
        shape_cfg=shape,
    )
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "status": "ok",
        "lower_s": round(t_lower, 2),
        "compile_s": 0.0,
        "setup_s": round(t_setup, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": tr.peak_live_bytes,
            "alias_bytes": alias_bytes,
            "generated_code_bytes": 0,
        },
        "cost": {"flops": cost["flops"], "bytes_accessed": cost["bytes accessed"]},
        "collectives": coll,
        "roofline": terms.to_row(),
        "param_count": rf.param_count(cfg),
        "active_param_count": rf.active_param_count(cfg),
        "ops": len(tr.ops),
    }
    return record, tr


def should_skip(arch: str, shape_name: str) -> str | None:
    if shape_name == "long_500k" and arch not in LONG_OK:
        return "long_500k needs sub-quadratic attention; pure full-attention arch (DESIGN.md §5)"
    return None


# --------------------------------------------------------------------------
# depth-extrapolated roofline: traces at depth 1 and 2, extended affinely to
# full depth (exact for homogeneous layer stacks). The trace unrolls every
# layer, so a full-depth trace can check it (chip_smoke.py does).
# --------------------------------------------------------------------------


def _depth_units(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.ssm.shared_attn_every
    return cfg.n_layers


def _depth_overrides(cfg, units: int) -> dict:
    if cfg.family == "hybrid":
        return {"n_layers": units * cfg.ssm.shared_attn_every}
    if cfg.family == "encdec":
        return {"n_layers": units, "n_encoder_layers": units}
    return {"n_layers": units}


def extrapolate_cell(arch: str, shape_name: str, mesh, mesh_name: str,
                     *, cfg_overrides: dict | None = None,
                     par_overrides: dict | None = None, reduced: bool = False):
    """Roofline record from depth-1 and depth-2 traces, extended to full
    depth (``reduced``: of the reduced config and shape)."""
    full_cfg = _cell_cfg(arch, cfg_overrides, reduced)
    units = _depth_units(full_cfg)
    recs = {}
    for u in (1, 2):
        ov = dict(cfg_overrides or {})
        ov.update(_depth_overrides(full_cfg, u))
        ov["scan_layers"] = False
        pov = dict(par_overrides or {})
        pov["microbatches"] = 1  # flops/bytes are ~batch-linear, m-invariant
        rec, _ = lower_cell(
            arch, shape_name, mesh, mesh_name, cfg_overrides=ov, par_overrides=pov,
            reduced=reduced,
        )
        recs[u] = rec

    def lin(f):
        # affine in depth; clamped below at the depth-2 value, as the
        # reference's (whose depth-1 modules XLA's CSE could make dearer)
        a, b = f(recs[1]), f(recs[2])
        return max(a + (units - 1) * (b - a), b, 0)

    cost = {
        "flops": lin(lambda r: r["cost"]["flops"]),
        "bytes accessed": lin(lambda r: r["cost"]["bytes_accessed"]),
    }
    kinds = set(recs[1]["collectives"]) | set(recs[2]["collectives"])
    coll = {k: lin(lambda r: r["collectives"].get(k, 0)) for k in kinds}
    shape = SHAPES[shape_name].reduced() if reduced else SHAPES[shape_name]
    terms = rf.analyze(
        arch=arch,
        shape=shape_name,
        mesh_name=mesh_name,
        chips=mesh.size(),
        cost=cost,
        coll=coll,
        cfg=full_cfg,
        shape_cfg=shape,
    )
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "method": "unrolled depth-1/2 affine extrapolation to full depth "
                  f"({units} units), microbatches=1",
        "depth_units": units,
        "cost": cost,
        "collectives": coll,
        "roofline": terms.to_row(),
        "depth1": {"cost": recs[1]["cost"], "collectives": recs[1]["collectives"]},
        "depth2": {"cost": recs[2]["cost"], "collectives": recs[2]["collectives"]},
    }


def _error_record(arch: str, shape_name: str, mesh_name: str, e: Exception) -> dict:
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "error", "error": f"{type(e).__name__}: {e}",
        "traceback": traceback.format_exc()[-4000:],
    }


def run_extrapolation(archs, shapes, out_dir: str, *, resume: bool = True,
                      mesh_name: str = "single", suffix: str = "rf",
                      cfg_overrides: dict | None = None,
                      par_overrides: dict | None = None):
    """The roofline pass (single-pod, as the reference's)."""
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch in archs:
        for shape_name in shapes:
            cell = f"{arch}__{shape_name}__{mesh_name}"
            path = os.path.join(out_dir, f"{cell}.{suffix}.json")
            if resume and os.path.exists(path):
                with open(path) as f:
                    results.append(json.load(f))
                print(f"[skip-cached] rf {cell}")
                continue
            if should_skip(arch, shape_name):
                continue
            try:
                with fake_world(MESH_RANKS[mesh_name]):
                    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"), device="cpu")
                    rec = extrapolate_cell(
                        arch, shape_name, mesh, mesh_name,
                        cfg_overrides=cfg_overrides, par_overrides=par_overrides,
                    )
                r = rec["roofline"]
                print(
                    f"[rf] {cell}: bottleneck={r['bottleneck']} "
                    f"Tc={r['compute_s']:.4f} Tm={r['memory_s']:.4f} "
                    f"Tx={r['collective_s']:.4f} util={r['hw_flops_util']:.3f} "
                    f"useful={r['useful_ratio']:.3f}"
                )
            except Exception as e:  # recorded per cell; the run goes on, then exits 1
                rec = _error_record(arch, shape_name, mesh_name, e)
                print(f"[rf ERROR] {cell}: {rec['error']}")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1, default=str)
            results.append(rec)
    return results


def run(archs, shapes, meshes, out_dir: str, *, resume: bool = True, save_hlo: bool = False):
    """Trace every cell; ``save_hlo`` also writes each cell's per-op trace
    (``<cell>.trace.txt``, ``analysis.trace.trace_text``)."""
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch in archs:
        for shape_name in shapes:
            for mesh_name in meshes:
                cell = f"{arch}__{shape_name}__{mesh_name}"
                path = os.path.join(out_dir, cell + ".json")
                if resume and os.path.exists(path):
                    with open(path) as f:
                        rec = json.load(f)
                    results.append(rec)
                    print(f"[skip-cached] {cell}: {rec['status']}")
                    continue
                skip = should_skip(arch, shape_name)
                if skip:
                    rec = {
                        "arch": arch, "shape": shape_name, "mesh": mesh_name,
                        "status": "skipped", "reason": skip,
                    }
                else:
                    try:
                        with fake_world(MESH_RANKS[mesh_name]):
                            mesh = make_production_mesh(multi_pod=(mesh_name == "multi"),
                                                        device="cpu")
                            rec, tr = lower_cell(arch, shape_name, mesh, mesh_name)
                        if save_hlo:
                            with open(os.path.join(out_dir, cell + ".trace.txt"), "w") as f:
                                f.write(trace_mod.trace_text(tr))
                        r = rec["roofline"]
                        print(
                            f"[ok] {cell}: trace={rec['lower_s']}s "
                            f"flops/dev={rec['cost']['flops']:.3e} "
                            f"coll/dev={rec['collectives'].get('total', 0):.3e}B "
                            f"bottleneck={r['bottleneck']} util={r['hw_flops_util']:.3f}"
                        )
                        del tr
                    except Exception as e:  # recorded per cell; the run goes on, then exits 1
                        rec = _error_record(arch, shape_name, mesh_name, e)
                        print(f"[ERROR] {cell}: {rec['error']}")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
                results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped, {n_err} errors / {len(results)} cells")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="arch id(s), comma-sep, or 'all'")
    ap.add_argument("--shape", default="all", help="shape name(s) or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write each cell's per-op trace (<cell>.trace.txt)")
    ap.add_argument(
        "--roofline", action="store_true",
        help="run the depth-extrapolated roofline pass (single-pod)",
    )
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    if args.roofline:
        results = run_extrapolation(archs, shapes, args.out, resume=not args.no_resume)
    else:
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        results = run(
            archs, shapes, meshes, args.out, resume=not args.no_resume, save_hlo=args.save_hlo
        )
    if any(r["status"] == "error" for r in results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
