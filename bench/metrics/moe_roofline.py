"""The grouped products' share of their roofline in the traced wave, in %:
the least time the three expert products the engine ran could take
(``bench.counts_moe.moe_need`` of the wave's ``serve.moe`` instant, at the
data-sheet peaks) over the device time of the kernels of
``torch.nn.functional.grouped_mm`` in the profiler's trace. ``None`` where
the trace holds no such kernel or the wave no ``serve.moe``.

On the H100 (torch 2.11, CUDA 12.8) a bf16 ``grouped_mm`` launches two
kernels, matched by the fragments in ``GROUPED``: CUTLASS's grouped GEMM,
whose name the profiler gives mangled
(``_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9x``
``INS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShape...``), and
``at::cuda::detail::prepare_grouped_gemm_data``, which lays out each
group's pointers and shapes for it."""

from bench.counts import roofline_seconds
from bench.counts_moe import moe_need

GROUPED = ("GemmUniversalINS5_17GroupProblem", "prepare_grouped_gemm_data")


def read(run):
    if run.profile is None:
        return None
    t = sum(s for name, s in run.profile.op_s.items() if any(g in name for g in GROUPED))
    moe = [e.args for e in run.profiled.spans if e.name == "serve.moe"]
    if t <= 0 or not moe:
        return None
    need = moe_need(run.shapes, sum(a["rows"] for a in moe), sum(a["groups"] for a in moe))
    return 100.0 * roofline_seconds(*need) / t
