"""Captured serve steps: the port's counterpart of the reference engine's
``jax.jit`` around its steps.

A :class:`StepGraph` holds one step function and its static input buffers.
On the card it is captured once as a ``torch.cuda.CUDAGraph`` and every
call replays it: the host writes the step's inputs into pinned staging, one
``copy_`` moves them into the static device buffers, and one replay
launches every kernel of the step. On the CPU the same function runs
eagerly over the same buffers, as every entry point of the port does when
the caller names the CPU.

The inputs are int32 tensors, views into one flat buffer (and one pinned
staging buffer), so staging costs one host-to-device copy a step. A step
replayed several times in one engine step (``groups`` > 0: the continuous
engine's compact wide step, one replay a group of rows) stages every
group's inputs in one host-to-device copy into a device buffer of groups
(:meth:`StepGraph.stage_groups`), and each replay first moves its group
into the inputs by a copy on the device (:meth:`StepGraph.load`): no
staging is overwritten before its copy has run. A step
function must read every value that changes from step to step from those
buffers or from tensors that outlive the graph (a pool's pages, an
engine's caches; under a mesh, DTensors, whose local blocks the graph
reads and writes, DTensor's dispatch having run on the host at capture): a
Python number or a host read inside it would be baked into the capture.
Capture raises if the function synchronises with the host (an
``.item()``, ``int(t)``, ``bool(t)``); it never falls back to eager.

Capture (:meth:`StepGraph.capture`) zeroes the inputs, runs the function
once on a side stream (the warm-up: it loads and opts in every kernel,
makes cuBLAS's handles and workspaces), then records it into a graph whose
intermediates live in ``pool`` (several graphs of one engine share one
pool; they never run at the same time). The warm-up really runs, on the
zeroed inputs: the caller captures where what that writes is dead (a
paged step with every ``q_len`` 0 writes only the dummy page 0; the static
decode step's caches are overwritten by the first prefill's). The capture
itself runs nothing: the launches it issued are taken back out of
``cuda_lib.launch_counts`` and added again at every replay. Python's cyclic
garbage collector is run before the capture and held off during it: a dead
engine's graphs destroyed mid-capture would invalidate it (the capture is
in CUDA's global mode, where such a call from any thread is an error).

A :class:`DeviceClock` times the steps on the card without a host wait: a
step graph given one records a CUDA event before its staged copy and
another after its replay (:meth:`StepGraph.replay` replays without
closing the window, for a step of several replays, whose caller closes it
after the last), and the engine reads a pair once its work is
done, after launching the step that follows (``device_ns``: the step's
window on the card; ``gap_ns``: the card's wait since the previous window
ended). No event is recorded inside a capture; on the CPU the clock
records nothing.
"""

from __future__ import annotations

import gc
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import cuda_lib

__all__ = ["StepGraph", "StepCaptureError", "DeviceClock"]


class StepCaptureError(RuntimeError):
    """A step's warm-up, capture or replay failed on the card."""


class DeviceClock:
    """Windows of device time between CUDA events, read without a wait.

    :meth:`begin` and :meth:`end` record an event on the stream that was
    current at :meth:`start` and open or close a window; a window that
    ends is sent to the args dict named by :meth:`into` before it ended (a
    step span's). :meth:`read` adds to each such dict, for every ended
    window whose end event has completed, ``device_ns`` (its length) and
    ``gap_ns`` (from the end of the window before it, or from
    :meth:`start`, to its beginning); a window still running stays for a
    later read, so the engine reads after launching the next step, while
    the card works. A ``begin`` while a window is open keeps the earlier
    one (a step's staging that began before its graph's own). Events come
    from a ring, reused in turn; none is recorded while the stream is
    capturing, and off the card none at all."""

    _RING = 16   # events: enough for the windows a read can lag behind

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self._ring = ([torch.cuda.Event(enable_timing=True) for _ in range(self._RING)]
                      if self.on_card else [])
        self._next = 0
        self._stream = None
        self._prev = self._open = self._into = None
        self._closed: list = []          # (begin, end, args): ended, not read

    def _record(self):
        if not self.on_card or torch.cuda.is_current_stream_capturing():
            return None
        ev = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        ev.record(self._stream)
        return ev

    def start(self) -> None:
        """Mark the origin of the first window's gap (a ``generate()``'s
        entry) on the current stream, forgetting every window not read."""
        if self.on_card:
            self._stream = torch.cuda.current_stream(self.device)
        self._prev = self._record()
        self._open = self._into = None
        self._closed = []

    def into(self, args: dict) -> None:
        """Send the next window to end to ``args``."""
        self._into = args

    def begin(self) -> None:
        if self._open is None:
            self._open = self._record()

    def end(self) -> None:
        if self._open is not None:
            ev = self._record()
            if ev is not None:
                self._closed.append((self._open, ev, self._into))
                self._into = None
            self._open = None

    def read(self) -> None:
        """Put ``device_ns`` and ``gap_ns`` into the args of each ended
        window whose work is done, oldest first, up to the first still
        running. Never waits."""
        n = 0
        for b, e, args in self._closed:
            if not e.query():
                break
            if args is not None:
                args["device_ns"] = round(b.elapsed_time(e) * 1e6)
                if self._prev is not None:
                    args["gap_ns"] = round(self._prev.elapsed_time(b) * 1e6)
            self._prev = e
            n += 1
        del self._closed[:n]


class StepGraph:
    def __init__(self, name: str, fn: Callable, inputs: dict, *, device, state=(), pool=None,
                 clock: Optional[DeviceClock] = None, groups: int = 0):
        """``fn(**buffers)`` -> a tuple of tensors, where ``buffers`` maps
        each name of ``inputs`` (name -> shape) to its int32 static
        buffer on ``device``. ``state``: the tensors the step writes in
        place (for :meth:`replay_against_eager`). ``pool`` is a
        ``torch.cuda.graph_pool_handle()`` to share with other steps
        (default: a pool of its own). ``clock``: a window of it opens
        before each staged copy and closes after each call. ``groups``:
        how many groups of inputs :meth:`stage_groups` can stage at once."""
        self.name = name
        self.clock = clock
        self.fn = fn
        self.state = list(state)
        self.device = torch.device(device)
        self.pool = pool
        sizes = {key: math.prod(shape) for key, shape in inputs.items()}
        n = sum(sizes.values())
        self._flat = torch.zeros(n, dtype=torch.int32, device=self.device)
        on_card = self.device.type == "cuda"
        self._staging = torch.zeros(n, dtype=torch.int32, pin_memory=True) if on_card else self._flat
        self.inputs: dict[str, torch.Tensor] = {}
        self._host: dict[str, np.ndarray] = {}
        # Staging of several groups: (groups, n) pinned on the card, copied
        # whole into a device buffer of the same shape (the same buffer off
        # the card), one row of which load() moves into the inputs.
        self._group_staging = (torch.zeros((groups, n), dtype=torch.int32, pin_memory=True)
                               if on_card else torch.zeros((groups, n), dtype=torch.int32))
        self._group_flat = (torch.zeros((groups, n), dtype=torch.int32, device=self.device)
                            if on_card else self._group_staging)
        self._group_host: dict[str, np.ndarray] = {}
        at = 0
        for key, shape in inputs.items():
            self.inputs[key] = self._flat[at:at + sizes[key]].view(shape)
            self._host[key] = self._staging[at:at + sizes[key]].view(shape).numpy()
            self._group_host[key] = (self._group_staging[:, at:at + sizes[key]]
                                     .view((groups, *shape)).numpy())
            at += sizes[key]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[tuple] = None
        self.launches: dict[str, int] = {}   # kernel launches of one replay
        self.replays = 0

    def stage(self, **arrays) -> None:
        """Write host arrays into the inputs of those names (the others
        keep their last values). On the card the staging buffer is pinned
        and the copy asynchronous: call again only after reading the
        previous step's outputs on the host, which waits for the copy."""
        for key, arr in arrays.items():
            self._host[key][...] = arr
        if self.clock is not None:
            self.clock.begin()
        if self._staging is not self._flat:
            self._flat.copy_(self._staging, non_blocking=True)

    def stage_groups(self, n: int, **arrays) -> None:
        """Write the first ``n`` groups of inputs, each array with a leading
        axis of ``n`` groups (or one value for every group), and move them
        to the device in one copy; :meth:`load` then puts one group into
        the inputs. Name every input: a group's row keeps nothing from an
        earlier step. As with :meth:`stage`, call again only after reading
        the previous step's outputs on the host."""
        for key, arr in arrays.items():
            self._group_host[key][:n] = arr
        if self.clock is not None:
            self.clock.begin()
        if self._group_staging is not self._group_flat:
            self._group_flat[:n].copy_(self._group_staging[:n], non_blocking=True)

    def load(self, group: int) -> None:
        """Group ``group`` of the last :meth:`stage_groups` into the inputs,
        a copy on the device ordered before the next replay."""
        self._flat.copy_(self._group_flat[group])

    @torch.no_grad()
    def capture(self) -> None:
        """Warm up and capture the step (once; a no-op on the CPU). Raises
        :class:`StepCaptureError` naming the step if either fails."""
        if self.device.type != "cuda" or self.graph is not None:
            return
        self._flat.zero_()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side):
                self.fn(**self.inputs)
        except Exception as err:
            raise StepCaptureError(f"warm-up of the {self.name} failed: {err}") from err
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with cuda_lib.recording() as issued:
                with torch.cuda.graph(graph, pool=self.pool):
                    outputs = self.fn(**self.inputs)
        except Exception as err:
            raise StepCaptureError(
                f"capture of the {self.name} failed (a host read or synchronisation "
                f"inside the step?): {err}"
            ) from err
        finally:
            if collecting:
                gc.enable()
        self.graph, self.outputs = graph, tuple(outputs)
        self.launches = {k: v for k, v in issued.items() if v}

    @torch.no_grad()
    def __call__(self) -> tuple:
        """Run the step on the staged inputs (:meth:`replay`) and close the
        clock's window."""
        outputs = self.replay()
        if self.clock is not None:
            self.clock.end()
        return outputs

    @torch.no_grad()
    def replay(self) -> tuple:
        """Run the step on the inputs: replay the graph on the card
        (capturing it first if needed), the function itself on the CPU.
        Returns the step's outputs (on the card, the graph's static output
        tensors, overwritten by the next replay). The clock's window stays
        open."""
        if self.device.type != "cuda":
            return tuple(self.fn(**self.inputs))
        self.capture()
        try:
            self.graph.replay()
        except RuntimeError as err:
            raise StepCaptureError(f"replay of the {self.name} failed: {err}") from err
        cuda_lib.add_launches(self.launches)
        self.replays += 1
        return self.outputs

    def run_eager(self) -> tuple:
        """The step function itself on the current inputs (no graph): what a
        replay must equal."""
        with torch.no_grad():
            return tuple(self.fn(**self.inputs))

    def replay_against_eager(self) -> dict:
        """On the current inputs and state: replay the graph, then restore
        the state and run the step function eagerly. Returns, for each
        output and each state tensor, whether the two are equal to the bit
        and their largest absolute difference. The state is left as the
        eager run wrote it (as the replay did, when they are equal)."""
        before = [t.clone() for t in self.state]
        got = [t.clone() for t in self()]
        got_state = [t.clone() for t in self.state]
        for t, b in zip(self.state, before):
            t.copy_(b)
        del before
        want = self.run_eager()
        out = {}
        for kind, pairs in (("output", zip(got, want)), ("state", zip(got_state, self.state))):
            for i, (a, b) in enumerate(pairs):
                out[f"{kind}{i}"] = {"equal": _same_bits(a, b), "max_abs_diff": _max_diff(a, b)}
        return out


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    as_int = _BITS[a.element_size()]
    return bool(torch.equal(a.view(as_int), b.view(as_int)))


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in float32, a slice of the leading axis at a time
    (a pool of pages is gigabytes)."""
    if a.numel() == 0:
        return 0.0
    if a.dim() == 0:
        return float((a.float() - b.float()).abs())
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
