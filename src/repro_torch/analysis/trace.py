"""A trace of one rank's work: the port's counterpart of
``repro.analysis.hlo``.

The reference reads per-device flops and bytes from the compiled module's
``cost_analysis()``, and per-device collective bytes from its HLO text.
Torch has neither, so the dry-run runs a step under :class:`RankTrace`, a
``TorchDispatchMode`` that records every aten op reaching a local tensor
(plain or fake): the op, its inputs' and outputs' local shapes and dtypes,
its flops (``torch.utils.flop_counter``'s formulas on those local shapes:
products, convolutions and attention; elementwise ops count 0) and, for a
collective, its kind and result bytes.

Per rank, not global: an op on a DTensor is handed back to DTensor
(``NotImplemented``), which runs this rank's local op, and that local op is
what is recorded. DTensor's sharding propagation also runs each op at its
global shape on fake tensors to learn the output's metadata; it enters the
fake mode once more to do so, and ops run at that depth are not recorded.

Memory: each storage a recorded op allocates is tracked until it is freed
(a weak reference to it); ``peak_live_bytes`` is the most that were alive
at once. ``bytes accessed`` is the sum of each recorded op's input and
output bytes, views, bare allocations and waits left out: an unfused upper
bound, where XLA's figure is of the fused module.

Collective kinds carry the reference's names: ``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all`` and
``collective-permute`` (an all-to-all that sends to one rank and receives
from one, the form ``funcol.permute_tensor`` issues). ``wait_tensor`` is
not counted, as the reference skips ``-done``.
"""

from __future__ import annotations

import re
import threading
import weakref
from collections import Counter, defaultdict
from typing import NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["OpRecord", "RankTrace", "cost", "collective_bytes", "parse_shape_bytes",
           "count_ops", "trace_text"]

_DTYPE_BYTES = {str(d).removeprefix("torch."): d.itemsize
                for d in vars(torch).values() if isinstance(d, torch.dtype)}
_SHAPE_RE = re.compile(r"([a-z0-9_]+)\[([0-9,]*)\]")
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


class OpRecord(NamedTuple):
    op: str                   # "aten.mm.default"
    inputs: tuple             # ((shape, dtype name), ...) of the tensor arguments
    outputs: tuple            # the same, of the results
    flops: int
    bytes: int                # input + output bytes; 0 for views, allocations, waits
    collective: Optional[str]  # the reference's kind, for a collective


def _type_str(shape, dtype: str) -> str:
    return f"{dtype}[{','.join(str(int(n)) for n in shape)}]"


def parse_shape_bytes(type_str: str) -> int:
    """Bytes of every ``dtype[d0,d1,...]`` in ``type_str`` (torch dtype
    names: ``bfloat16[8]``, ``(float32[4], int32[2])``); unknown names count
    0."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _is_permute(args) -> bool:
    """An ``all_to_all_single(input, output_splits, input_splits, group)``
    whose splits name one peer each way."""
    if len(args) < 3 or not all(isinstance(s, (list, tuple)) for s in args[1:3]):
        return False
    return all(sum(1 for n in s if n) <= 1 for s in args[1:3])


def _collective_kind(func, args) -> Optional[str]:
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._opname
    if name.startswith("wait"):
        return None
    if "all_reduce" in name or "allreduce" in name:
        return "all-reduce"
    if "all_gather" in name or "allgather" in name:
        return "all-gather"
    if "reduce_scatter" in name:
        return "reduce-scatter"
    if "all_to_all" in name or "alltoall" in name:
        return "collective-permute" if _is_permute(args) else "all-to-all"
    if "broadcast" in name:
        return "broadcast"
    return None


def _fake_depth():
    """(the active fake mode, how deep it is entered), or None."""
    mode = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    if mode is None:
        return None
    return id(mode), len(getattr(mode, "enter_stack", ()))


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RankTrace(TorchDispatchMode):
    """Records one rank's local ops while it is entered (see the module
    docstring). ``ops`` is the list of :class:`OpRecord`; ``peak_live_bytes``
    the peak of the live storages the recorded ops allocated."""

    def __init__(self):
        super().__init__()
        try:
            from torch.distributed.tensor import DTensor
        except ImportError:  # a torch built without distributed
            DTensor = None
        self._dtensor = DTensor
        self.ops: list[OpRecord] = []
        self.peak_live_bytes = 0
        self._live_bytes = 0
        self._storages: dict[int, tuple] = {}   # id -> (weak ref or None if external, bytes)
        self._lock = threading.Lock()
        self._base = None

    def __enter__(self):
        self._base = _fake_depth()
        return super().__enter__()

    # -- storage lifetimes -------------------------------------------------

    def _freed(self, key: int, nbytes: int) -> None:
        with self._lock:
            if self._storages.pop(key, None) is not None:
                self._live_bytes -= nbytes

    def _see(self, t: torch.Tensor, *, allocated: bool) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes() if allocated else 0
        ref = weakref.ref(st, lambda _, key=key, n=n: self._freed(key, n))
        with self._lock:
            self._storages[key] = (ref, n)
            self._live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self._live_bytes)

    # -- dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._dtensor is not None and any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if func.namespace == "prim" or _fake_depth() != self._base:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(t.device.type == "meta" for t in ins + outs):
            return out
        for t in ins:
            self._see(t, allocated=False)
        for t in outs:
            self._see(t, allocated=True)
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(func._overloadpacket)
        flops = int(formula(*args, **kwargs, out_val=out)) if formula is not None else 0
        kind = _collective_kind(func, args)
        name = func._opname
        moves = not (func.is_view or name.startswith(("empty", "new_empty"))
                     or (func.namespace in _COLLECTIVE_NAMESPACES and name.startswith("wait")))
        nbytes = sum(_nbytes(t) for t in ins + outs) if moves else 0
        spec = lambda ts: tuple((tuple(t.shape), str(t.dtype).removeprefix("torch."))  # noqa: E731
                                for t in ts)
        self.ops.append(OpRecord(str(func), spec(ins), spec(outs), flops, nbytes, kind))
        return out


def _ops(trace) -> list:
    return trace.ops if isinstance(trace, RankTrace) else list(trace)


def cost(trace) -> dict:
    """``{"flops", "bytes accessed"}`` of one rank, the keys of the
    reference's ``cost_analysis()``."""
    ops = _ops(trace)
    return {"flops": sum(r.flops for r in ops), "bytes accessed": sum(r.bytes for r in ops)}


def collective_bytes(trace) -> dict[str, int]:
    """Result bytes of one rank's collectives by kind, and their
    ``total``: the keys of ``repro.analysis.hlo.collective_bytes``, each
    kind present only where one was issued."""
    out: dict[str, int] = defaultdict(int)
    for r in _ops(trace):
        if r.collective:
            out[r.collective] += sum(parse_shape_bytes(_type_str(*o)) for o in r.outputs)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return dict(out)


def count_ops(trace, names=("aten.mm", "aten.bmm", "aten.addmm")) -> dict[str, int]:
    """How many times each op of ``names`` (an op packet, ``aten.mm``) was
    recorded; ``names=None`` counts every op."""
    got = Counter(r.op.rsplit(".", 1)[0] for r in _ops(trace))
    return dict(got) if names is None else {n: got.get(n, 0) for n in names}


def trace_text(trace) -> str:
    """One line an op: ``op(inputs) -> outputs``, with its flops, bytes and
    collective kind where there are any (the counterpart of the module text
    the reference's ``--save-hlo`` writes)."""
    lines = []
    for r in _ops(trace):
        ins = ", ".join(_type_str(*t) for t in r.inputs)
        outs = ", ".join(_type_str(*t) for t in r.outputs)
        extra = "".join(f" {k}={v}" for k, v in (("flops", r.flops), ("bytes", r.bytes),
                                                  ("collective", r.collective)) if v)
        lines.append(f"{r.op}({ins}) -> ({outs}){extra}")
    return "\n".join(lines) + "\n"
