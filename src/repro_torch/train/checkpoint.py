"""Atomic, asynchronous checkpointing of the train state.

A port of ``repro.train.checkpoint`` with its on-disk layout, so that a
checkpoint the JAX package wrote restores into the port:

    <dir>/step_<N>/
        manifest.json     key paths, shapes, dtypes, step
        shard_0.npz       one array per key path; bfloat16 saved as a uint16 view

Key paths join dict keys and NamedTuple field names with ``/``
(``params/layers/attn/wq/w``, ``opt/m/embed/table``, ``opt/step``). The
reference stacks layer params on leading axes; the port keeps them as a
list of per-layer dicts (the hybrid's Mamba layers as a list of groups of
layers), so a list is stacked at save and unstacked at restore under the
same key paths, a list of lists on two axes.

Writes are atomic (tmp dir + rename) and asynchronous (a background thread,
after a synchronous copy to the host); ``latest_step`` only ever sees fully
written checkpoints. Retention keeps the newest k.

Sharded states: a DTensor leaf is gathered whole before it is written (a
collective: every rank of its mesh saves), and only rank 0 of the process
group writes. ``restore_pytree(..., shardings=specs, mesh=mesh)`` places the
restored tree on ``mesh`` by the specs (``train.step.state_shardings``), so
a state saved on one mesh restores onto another.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.context import whole
from repro_torch.train.optimizer import named_leaves, stack_members

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree", "latest_step"]


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0, or no group."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _to_host(x) -> tuple[np.ndarray, str]:
    """(numpy array, dtype name) of a tensor or a Python scalar; bfloat16
    as its uint16 bits."""
    x = whole(x)
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(x, np.int32 if isinstance(x, int) else None)
    return arr, str(arr.dtype)


def _host_flat(tree, prefix: tuple = ()):
    """(key path, numpy array, dtype name) of every leaf, lists of layer
    dicts stacked on a leading axis."""
    if hasattr(tree, "_fields"):  # NamedTuple (OptState)
        for f in tree._fields:
            yield from _host_flat(getattr(tree, f), prefix + (f,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _host_flat(v, prefix + (k,))
    elif isinstance(tree, list):
        lead, members = stack_members(tree)
        for path, _ in named_leaves(members[0]):
            parts = [_to_host(_leaf(item, path)) for item in members]
            stacked = np.stack([a for a, _ in parts])
            yield prefix + path, stacked.reshape(lead + stacked.shape[1:]), parts[0][1]
    else:
        arr, dt = _to_host(tree)
        yield prefix, arr, dt


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _write(flat: list, directory: str, step: int) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    meta = {"step": step, "keys": {}, "time": time.time()}
    arrays = {}
    for path, arr, dt in flat:
        arrays[_key(path)] = arr
        meta["keys"][_key(path)] = {"dtype": dt, "shape": list(arr.shape)}
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_pytree(tree, directory: str, step: int) -> str:
    """Synchronous atomic save (rank 0 writes). Returns the final
    checkpoint path."""
    flat = list(_host_flat(tree))
    if _writer():
        return _write(flat, directory, step)
    return os.path.join(directory, f"step_{step:08d}")


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _fill(template, data, keys: dict, prefix: tuple):
    if hasattr(template, "_fields"):
        return type(template)(*(_fill(getattr(template, f), data, keys, prefix + (f,))
                                for f in template._fields))
    if isinstance(template, dict):
        return {k: _fill(v, data, keys, prefix + (k,)) for k, v in template.items()}
    if isinstance(template, list):
        lead, members = stack_members(template)
        out = [{} for _ in members]
        for path, leaf in named_leaves(members[0]):
            stacked = _load(data, keys, prefix + path)
            stacked = stacked.reshape((len(members),) + stacked.shape[len(lead):])
            for i, item in enumerate(out):
                for k in path[:-1]:
                    item = item.setdefault(k, {})
                item[path[-1]] = _from_host(stacked[i], keys[_key(prefix + path)]["dtype"],
                                            leaf.device)
        for n in reversed(lead[1:]):  # regroup: (groups, layers a group)
            out = [out[i:i + n] for i in range(0, len(out), n)]
        return out
    arr = _load(data, keys, prefix)
    if isinstance(template, torch.Tensor):
        return _from_host(arr, keys[_key(prefix)]["dtype"], template.device)
    return type(template)(arr)


def _load(data, keys: dict, path: tuple) -> np.ndarray:
    key = _key(path)
    if key not in data or key not in keys:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    return data[key]


def restore_pytree(template, directory: str, step: Optional[int] = None, *, shardings=None,
                   mesh=None):
    """Restore into ``template``'s structure (tensors on the template
    leaves' devices, in the saved dtypes). ``shardings`` (a tree of specs
    matching ``template``, e.g. ``train.step.state_shardings``) places the
    result on the ``DeviceMesh`` ``mesh``, each rank keeping its shard;
    this reshards across mesh changes. Returns (tree, step)."""
    if shardings is not None and mesh is None:
        raise ValueError("restore_pytree(shardings=...) needs the mesh to place them on")
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        tree = _fill(template, data, meta["keys"], ())
    if shardings is not None:
        from repro_torch.dist.sharding import distribute

        tree = distribute(tree, shardings, mesh)
    return tree, step


class CheckpointManager:
    """Async writer + retention + resume helper."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, tree, step: int, *, blocking: bool = False):
        self.wait()  # one in-flight write at a time
        flat = list(_host_flat(tree))  # the host copy, before training moves on
        if not _writer():
            return

        def work():
            try:
                _write(flat, self.directory, step)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _gc(self):
        steps = sorted(
            int(m.group(1))
            for m in (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(self.directory))
            if m
        )
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def restore_latest(self, template, *, shardings=None, mesh=None):
        self.wait()
        return restore_pytree(template, self.directory, shardings=shardings, mesh=mesh)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)
