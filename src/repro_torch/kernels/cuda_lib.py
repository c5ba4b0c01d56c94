"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one source under ``src/repro_torch/csrc/`` with a plain C
entry point (all include ``csrc/common.cuh``; the flash forward, the
backward's dQ and dK/dV kernels, the SSD scan and, through
``csrc/decode_core.cuh``, the two decode kernels also ``csrc/sm90.cuh``:
Hopper's TMA, cp.async, mbarriers, clusters, wgmma and setmaxnreg in raw
PTX). It is compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``build/repro_torch/``
(listed in ``.gitignore``), named by a hash of the source, every header of
``csrc/`` and the flags, at first use, and loaded with ``ctypes``. Nothing is
compiled or loaded when this module is imported: the CPU tests import every
module on machines without ``nvcc``.

``launch_counts`` holds one integer per kernel. A wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernel. ``library_counts`` counts, apart from those, the
library calls that stand for a product the JAX package left to XLA (the
MoE's grouped product, ``ops.ragged_dot``), one where each is issued. A
CUDA graph capture calls the wrappers without running their kernels: it
takes what it issued back out of both counts (``recording``) and adds it
again at each replay (``add_launches``), so the counts stay the launches
the card ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = [
    "KERNELS",
    "ORDER_CODES",
    "BUILD_DIR",
    "build_all",
    "load",
    "launch_counts",
    "library_counts",
    "reset_launch_counts",
    "recording",
    "add_launches",
]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclasses.dataclass(frozen=True)
class Kernel:
    name: str          # launch-count key and library stem
    source: str        # file under csrc/
    entry: str         # exported C function
    argtypes: tuple    # ctypes argument types of ``entry``
    replaces: str      # the Pallas kernel this one replaces (file:line), or the
                       # plain functions of the reference it fuses (space-separated)
    extra: tuple = ()  # further C entries of the library: (name, argtypes) pairs


KERNELS = {
    "paged_decode": Kernel(
        name="paged_decode",
        source="paged_decode.cu",
        entry="paged_decode_bf16",
        # q, k_pool, v_pool, phys, logical, lens, q_lens, out,
        # B, C, Hq, Hkv, D, n_blocks, page, window, scale, stream
        argtypes=(_P,) * 8 + (_I,) * 8 + (_F, _P),
        replaces="src/repro/kernels/flash_decode.py:122",
        # the same launch recording its walk (+ visit, splits); the launch's
        # attributes at a shape (B, C, Hq, Hkv, D, n_blocks, page, out)
        extra=(("paged_decode_bf16_visit", (_P,) * 8 + (_I,) * 8 + (_F, _P, _P, _I)),
               ("paged_decode_attr", (_I,) * 7 + (_P,))),
    ),
    "flash_fwd": Kernel(
        name="flash_fwd",
        source="flash_fwd.cu",
        entry="flash_fwd_bf16",
        # q, k, v, o, lse, visit, B, Sq, Skv, Hq, Hkv, D, causal, window,
        # order, snake, scale, stream
        argtypes=(_P,) * 6 + (_I,) * 10 + (_F, _P),
        replaces="src/repro/kernels/flash_attention.py:141",
    ),
    "contig_decode": Kernel(
        name="contig_decode",
        source="contig_decode.cu",
        entry="contig_decode_bf16",
        # q, k, v, lens, out, B, S_max, Hq, Hkv, D, window, chunk, order,
        # snake, scale, stream
        argtypes=(_P,) * 5 + (_I,) * 9 + (_F, _P),
        replaces="src/repro/kernels/flash_decode.py:94",
        # as paged_decode's; the launch writing each row's lse too (+ lse,
        # splits); attributes at (B, S_max, Hq, Hkv, D, chunk, out), of the
        # launch without the lse and with it
        extra=(("contig_decode_bf16_visit", (_P,) * 5 + (_I,) * 9 + (_F, _P, _P, _I)),
               ("contig_decode_bf16_lse", (_P,) * 5 + (_I,) * 9 + (_F, _P, _P, _I)),
               ("contig_decode_attr", (_I,) * 6 + (_P,)),
               ("contig_decode_lse_attr", (_I,) * 6 + (_P,))),
    ),
    "flash_bwd_delta": Kernel(
        name="flash_bwd_delta",
        source="flash_bwd_delta.cu",
        entry="flash_bwd_delta_bf16",
        # o, dO, delta, n_rows, D, stream
        argtypes=(_P,) * 3 + (_I,) * 2 + (_P,),
        replaces="src/repro/kernels/flash_attention.py:332",
    ),
    "flash_bwd_dq": Kernel(
        name="flash_bwd_dq",
        source="flash_bwd_dq.cu",
        entry="flash_bwd_dq_bf16",
        # q, k, v, dO, lse, delta, dq, visit, B, Sq, Skv, Hq, Hkv, D, causal,
        # window, order, snake, scale, stream
        argtypes=(_P,) * 8 + (_I,) * 10 + (_F, _P),
        replaces="src/repro/kernels/flash_attention.py:345",
    ),
    "flash_bwd_dkv": Kernel(
        name="flash_bwd_dkv",
        source="flash_bwd_dkv.cu",
        entry="flash_bwd_dkv_bf16",
        # q, k, v, dO, lse, delta, dk, dv, visit, B, Sq, Skv, Hq, Hkv, D,
        # causal, window, order, snake, scale, stream
        argtypes=(_P,) * 9 + (_I,) * 10 + (_F, _P),
        replaces="src/repro/kernels/flash_attention.py:405",
    ),
    "ssd": Kernel(
        name="ssd",
        source="ssd.cu",
        entry="ssd_fwd_bf16",
        # x, dt, a, b, c, init_state, y, final, B, S, H, P, N, stream
        argtypes=(_P,) * 8 + (_I,) * 5 + (_P,),
        replaces="src/repro/kernels/ssd.py:40",
        # the same launch recording each CTA's items (+ visit); the
        # launch's attributes at (B, H, N, out)
        extra=(("ssd_fwd_bf16_visit", (_P,) * 8 + (_I,) * 5 + (_P, _P)),
               ("ssd_attr", (_I,) * 3 + (_P,))),
    ),
    "rope_kv_write": Kernel(
        name="rope_kv_write",
        source="rope_kv_write.cu",
        entry="rope_kv_write_bf16",
        # q, k, v, k_pages, v_pages, cos, sin, phys, offset, q_len, B, C, Hq,
        # Hkv, D, page, stream
        argtypes=(_P,) * 10 + (_I,) * 6 + (_P,),
        # no Pallas kernel: the reference's rope and paged write, fused
        replaces="src/repro/models/layers.py:90 src/repro/models/transformer.py:168",
    ),
}

# Order family as the kernels take it (the ``order`` int argument).
ORDER_CODES = {"cyclic": 0, "sawtooth": 1, "block_snake": 2}

launch_counts = {name: 0 for name in KERNELS}
# Library calls on the card, counted like launches but not kernels of this
# repository: ``ragged_dot`` is one ``torch.nn.functional.grouped_mm``.
library_counts = {"ragged_dot": 0}
_loaded: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    """Zero ``launch_counts`` and ``library_counts``."""
    for counts in (launch_counts, library_counts):
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def recording():
    """Yields a dict that receives, when the block ends, the launches each
    wrapper issued inside it; those are taken back out of
    ``launch_counts`` and ``library_counts`` (a graph capture issues
    launches the card does not run until a replay)."""
    before = [dict(counts) for counts in (launch_counts, library_counts)]
    issued: dict[str, int] = {}
    try:
        yield issued
    finally:
        for counts, was in zip((launch_counts, library_counts), before):
            issued.update({name: counts[name] - n for name, n in was.items()})
            counts.update(was)


def add_launches(counts: dict) -> None:
    """Count ``counts`` (kernel or library call -> launches) as run: a
    replay's launches."""
    for name, n in counts.items():
        (library_counts if name in library_counts else launch_counts)[name] += n


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME); the port's CUDA kernels are "
        "compiled from src/repro_torch/csrc at first use"
    )


def library_path(name: str) -> Path:
    src = (CSRC / KERNELS[name].source).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=None, *, verbose: bool = False) -> dict[str, dict]:
    """Compile every kernel in ``names`` (default: all) whose library is
    missing, one ``nvcc`` per source, all started together. Returns
    ``{name: {"path", "seconds", "log"}}``; ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel, in ``log``). Raises
    with the compiler's output if any build fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    out: dict[str, dict] = {}
    for name in names:
        path = library_path(name)
        if path.exists() and not verbose:
            out[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / KERNELS[name].source)]
        jobs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, path, time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, path, t0) in jobs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": str(path), "seconds": secs, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        spec = KERNELS[name]
        for entry, argtypes in ((spec.entry, spec.argtypes), *spec.extra):
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
