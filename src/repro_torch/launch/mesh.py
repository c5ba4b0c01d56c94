"""Mesh builders on ``torch.distributed``.

A port of ``repro.launch.mesh``. Functions, never module-level constants:
importing this module touches no device and no process group.

  * ``make_local_mesh(data, model)`` -- a ``DeviceMesh`` of shape (data,
    model) named ("data", "model") over the ranks of the default process
    group, whose world size must be ``data * model``. With no process group
    and a world of 1 it first joins one on its own (:func:`init_single_process`);
  * ``make_production_mesh(multi_pod=...)`` -- the reference's (16, 16)
    ("data", "model") or (2, 16, 16) ("pod", "data", "model") mesh; it
    raises where the world size differs rather than build another shape;
  * ``production_mesh_shape`` -- the same shapes without devices
    (``dist.sharding.MeshShape``), for spec computation and the dry-run.

A process joins a larger world by ``torch.distributed.init_process_group``
with its own store, rank and world size (the CPU tests use gloo on a
``FileStore``); nothing here reads a cluster's environment.
"""

from __future__ import annotations

import os
import tempfile

import torch

from repro_torch.dist.sharding import MeshShape

__all__ = ["make_local_mesh", "make_production_mesh", "production_mesh_shape",
           "init_single_process"]


def _device_type() -> str:
    """``cuda`` where a GPU is usable, else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def init_single_process(device: str | None = None) -> None:
    """Join a process group of world size 1, if none is joined yet: NCCL on
    the card, gloo on the CPU, on a ``FileStore`` in a fresh temporary
    directory (no TCP port to choose)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    device = device or _device_type()
    backend = "nccl" if device == "cuda" else "gloo"
    path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    store = dist.FileStore(path, 1)
    kw = {}
    if device == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, store=store, rank=0, world_size=1, **kw)


def _mesh(shape: tuple, names: tuple, device: str | None):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = device or _device_type()
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a {shape} mesh needs a process group of {n} ranks; join one with "
                "torch.distributed.init_process_group before building the mesh")
        init_single_process(device)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {n} ranks; the process "
                         f"group has {world}")
    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_local_mesh(data: int = 1, model: int = 1, *, device: str | None = None):
    """A (data, model) ``DeviceMesh`` over every rank of the process group
    (tests, CPU runs, one card)."""
    return _mesh((data, model), ("data", "model"), device)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's shape and names, without devices."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device: str | None = None):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = production_mesh_shape(multi_pod=multi_pod)
    return _mesh(tuple(shape.shape.values()), shape.axis_names, device)
