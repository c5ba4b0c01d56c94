"""Sharding specs: divisibility tightening + path-pattern parameter rules,
and their placements on a torch ``DeviceMesh``.

A port of ``repro.dist.sharding``. The contract is the reference's,
*pattern + divisibility*:

  1. Leaf path names decide where a tensor would like to live on the mesh
     (Megatron-style: TP on the head/expert-ffn dim of input projections,
     TP on the contraction dim of output projections, FSDP on the other
     matrix dim, vocab-sharded embeddings).
  2. :func:`tighten` then drops every mesh axis that does not evenly divide
     its dim, so the same rules serve full production configs, tiny
     ``.reduced()`` CPU configs, GQA head counts smaller than the TP degree,
     and factored optimizer statistics.

The spec functions are pure shape logic. They take a ``DeviceMesh`` with
named dims or a :class:`MeshShape` (axis name -> size, no devices: the
counterpart of the reference's ``AbstractMesh``), so the dry-run's
production meshes and the CPU tests share one code path. A spec is a
:class:`P`, a tuple with one entry a dim: None, an axis name, or a tuple of
axis names.

Leaf paths are the port's: its layer stacks are lists, so a leaf is
``layers/3/attn/wq/w`` of shape (d, h*hd) where the reference has
``layers/attn/wq/w`` of shape (L, d, h*hd). The rules align to trailing dims
and replicate the leading ones, so the port's spec is the reference's with
the stacked axes removed, apart from a stacked leaf whose only per-layer dim
is the stack axis (none of the port's params has one; ROADMAP §C).

:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``: ``Shard(d)`` on each mesh dim named for tensor dim ``d``,
``Replicate()`` on the others. A multi-axis entry is several ``Shard(d)``
on one tensor dim, which DTensor splits in mesh-dim order; an entry whose
axes run against the mesh's order has no such form and raises.
"""

from __future__ import annotations

import re
from typing import Mapping, Sequence

from repro_torch.configs.base import ParallelConfig

__all__ = [
    "P",
    "MeshShape",
    "tighten",
    "spec_for",
    "param_specs",
    "param_shardings",
    "batch_spec",
    "batch_shardings",
    "cache_specs",
    "cache_shardings",
    "placements",
    "distribute",
    "path_str",
    "tree_map_with_path",
]


class P(tuple):
    """A partition spec: one entry a tensor dim (None, an axis name, or a
    tuple of axis names). ``P("data", None) == ("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class MeshShape:
    """A device-free mesh: axis names and sizes, as ``AbstractMesh`` in the
    reference. ``MeshShape((16, 16), ("data", "model"))``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


# --------------------------------------------------------------------------
# divisibility tightening
# --------------------------------------------------------------------------


def _mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size for a ``DeviceMesh``, a :class:`MeshShape` or a
    plain mapping. A ``DeviceMesh``'s sizes come from its ``shape``, not
    its rank tensor ``mesh``, which newer torch builds by indexing (an op
    that ``FakeTensorMode`` refuses on a real tensor); an object with named
    dims and no ``shape`` gives its ``mesh`` grid's."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # torch DeviceMesh
        shape = mesh.shape if hasattr(mesh, "shape") else mesh.mesh.shape
        return dict(zip(names, (int(n) for n in shape)))
    return dict(mesh.shape)


def _as_tuple(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _collapse(names: tuple[str, ...]):
    """() -> None, ('a',) -> 'a', so specs compare cleanly."""
    if not names:
        return None
    if len(names) == 1:
        return names[0]
    return names


def tighten(shape: Sequence[int], spec: Sequence, mesh) -> P:
    """Drop mesh axes that do not evenly divide their dim.

    ``spec`` has one entry per dim of ``shape``; each entry is an axis name,
    a tuple of axis names (the longest *prefix* whose combined size divides
    the dim is kept), or None. Axes absent from the mesh, or already
    consumed by an earlier dim, are dropped too. The result has exactly
    ``len(shape)`` entries.
    """
    if len(spec) != len(shape):
        raise ValueError(f"spec {tuple(spec)!r} does not match shape {tuple(shape)!r}")
    sizes = _mesh_sizes(mesh)
    out = []
    used: set[str] = set()
    for dim, entry in zip(shape, spec):
        names = tuple(a for a in _as_tuple(entry) if a in sizes and a not in used)
        keep: tuple[str, ...] = ()
        prod = 1
        for a in names:
            prod *= sizes[a]
            if dim % prod:
                break
            keep = keep + (a,)
        used.update(keep)
        out.append(_collapse(keep))
    return P(*out)


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------

# Column-parallel projections: (.., d_in, d_out) with d_out the TP dim.
_TP_OUT_COL = r"(?:wq|wk|wv|w_gate|w_up|in_proj|proj_in|vision_proj|lm_head)"
# Row-parallel projections: (.., d_in, d_out) with d_in the TP dim.
_TP_IN_ROW = r"(?:wo|w_down|out_proj)"

# (pattern, trailing-dims spec). Entries: "fsdp" -> pcfg.fsdp_axes (tuple,
# prefix-tightened), "tp" -> pcfg.tensor_axis, None -> replicated. The spec
# aligns to the *last* len(spec) dims; leading dims (hybrid groups, experts,
# the optimizer's stacked moments) are replicated unless a rule says
# otherwise.
_RULES: list[tuple[re.Pattern, tuple]] = [
    (re.compile(r"embed/table$"), ("tp", "fsdp")),
    (re.compile(_TP_OUT_COL + r"(?:/w)?$"), ("fsdp", "tp")),
    (re.compile(_TP_OUT_COL + r"/b$"), ("tp",)),
    (re.compile(_TP_IN_ROW + r"(?:/w)?$"), ("tp", "fsdp")),
    (re.compile(_TP_IN_ROW + r"/b$"), ("fsdp",)),
    (re.compile(r"router(?:/w)?$"), ("fsdp", None)),  # router stays f32/replicated-out
    (re.compile(r"router/b$"), (None,)),
    (re.compile(r"conv_w$"), (None, "tp")),  # depthwise conv: channel dim
]

# Everything else (norm scales, biases, SSM scalars, factored optimizer
# row/col stats): ZeRO-style shard of the trailing dim over the FSDP axes;
# tighten replicates the small/odd ones.
_FALLBACK = ("fsdp",)


def path_str(path: Sequence) -> str:
    """'layers/3/attn/wq/w' from a key path (dict keys, list indices,
    NamedTuple field names)."""
    return "/".join(str(p) for p in path)


def tree_map_with_path(fn, tree, prefix: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and NamedTuples, with
    the same structure out (a leaf is anything else)."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), prefix + (f,))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, prefix + (i,)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _resolve(entry, pcfg: ParallelConfig):
    if entry == "fsdp":
        return tuple(pcfg.fsdp_axes)
    if entry == "tp":
        return pcfg.tensor_axis
    return entry


def _shape(x) -> tuple:
    return tuple(getattr(x, "shape", ()))


def spec_for(path: str, shape: Sequence[int], pcfg: ParallelConfig, mesh) -> P:
    """PartitionSpec for one parameter leaf (full rank, tightened)."""
    rank = len(shape)
    trailing: tuple = _FALLBACK
    for pat, rule in _RULES:
        if pat.search(path):
            trailing = rule
            break
    trailing = trailing[max(0, len(trailing) - rank):]
    full = (None,) * (rank - len(trailing)) + tuple(_resolve(e, pcfg) for e in trailing)
    return tighten(shape, full, mesh)


def param_specs(params, pcfg: ParallelConfig, mesh):
    """Tree of specs matching ``params`` (tensors, meta tensors, or anything
    with a ``shape``)."""
    return tree_map_with_path(
        lambda path, x: spec_for(path_str(path), _shape(x), pcfg, mesh), params)


# --------------------------------------------------------------------------
# batches
# --------------------------------------------------------------------------


def batch_spec(global_batch: int, pcfg: ParallelConfig, mesh) -> P:
    """Spec for the leading batch dim: data axes, tightened (batch 1 on a
    16-way data mesh falls back to replication rather than erroring)."""
    axes = tuple(a for a in pcfg.data_axes if a in _mesh_sizes(mesh))
    return tighten((global_batch,), (axes,), mesh)


def _batch_leaf_spec(x, pcfg: ParallelConfig, mesh) -> P:
    rank = len(_shape(x))
    if rank == 0:
        return P()
    return P(batch_spec(_shape(x)[0], pcfg, mesh)[0], *([None] * (rank - 1)))


# --------------------------------------------------------------------------
# KV caches / decode state
# --------------------------------------------------------------------------


def cache_specs(caches, pcfg: ParallelConfig, mesh):
    """Specs for serving caches (stacked (L, B, S, H[, hd]) layout).

    Batch dim goes on the data axes. KV heads go on the tensor axis when
    the head count divides it; GQA head counts that don't (hkv < TP degree)
    fall back to sharding the *sequence* dim on the tensor axis. SSM decode
    state ('conv'/'ssd' leaves) shards its batch dim; scalars ('len',
    'kv_len') replicate.
    """
    sizes = _mesh_sizes(mesh)
    data_axes = tuple(a for a in pcfg.data_axes if a in sizes)
    tp = pcfg.tensor_axis if pcfg.tensor_axis in sizes else None

    def batch_entry(dim: int):
        return tighten((dim,), (data_axes,), mesh)[0]

    def leaf(path, x):
        name = str(path[-1]) if path else ""
        shape = _shape(x)
        rank = len(shape)
        spec = [None] * rank
        if name in ("k", "v", "k_scale", "v_scale"):
            h_dim = rank - 2 if name in ("k", "v") else rank - 1
            s_dim, b_dim = h_dim - 1, h_dim - 2
            if b_dim >= 0:
                spec[b_dim] = batch_entry(shape[b_dim])
                if tp is not None and shape[h_dim] % sizes[tp] == 0:
                    spec[h_dim] = tp
                elif tp is not None and shape[s_dim] % sizes[tp] == 0:
                    spec[s_dim] = tp
        elif name == "conv" and rank >= 3:  # (.., B, width-1, channels)
            spec[rank - 3] = batch_entry(shape[rank - 3])
        elif name == "ssd" and rank >= 4:  # (.., B, H, P, N)
            spec[rank - 4] = batch_entry(shape[rank - 4])
        return P(*spec)

    return tree_map_with_path(leaf, caches)


# --------------------------------------------------------------------------
# DTensor placements on a DeviceMesh
# --------------------------------------------------------------------------


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: one a
    mesh dim, ``Shard(d)`` where tensor dim ``d`` names that mesh dim,
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _as_tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry!r} for dim {d} runs against the mesh's dim order "
                f"{tuple(names)}; DTensor splits one tensor dim in mesh-dim order only")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def distribute(tree, specs, mesh):
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` with its spec's
    placements (``tree`` holds the full value, the same on every rank; each
    rank keeps its own shard of it, with no communication). A DTensor leaf
    is redistributed; non-tensor leaves pass through."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    def leaf(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        spec = specs
        for k in path:
            spec = getattr(spec, k) if hasattr(spec, "_fields") else spec[k]
        pl = placements(spec, mesh)
        if isinstance(x, DTensor):
            return x.redistribute(mesh, pl)
        return distribute_tensor(x.detach(), mesh, pl, src_data_rank=None)

    return tree_map_with_path(leaf, tree)


def param_shardings(params, pcfg: ParallelConfig, mesh):
    """Tree of DTensor placements matching ``params`` on a ``DeviceMesh``."""
    return tree_map_with_path(lambda _, s: placements(s, mesh),
                              param_specs(params, pcfg, mesh))


def batch_shardings(batch, pcfg: ParallelConfig, mesh):
    """Batch-dim placements for every leaf of a batch tree."""
    return tree_map_with_path(lambda _, x: placements(_batch_leaf_spec(x, pcfg, mesh), mesh),
                              batch)


def cache_shardings(caches, pcfg: ParallelConfig, mesh):
    """Placements of :func:`cache_specs` on a ``DeviceMesh``."""
    return tree_map_with_path(lambda _, s: placements(s, mesh),
                              cache_specs(caches, pcfg, mesh))
