"""FLOPs and bytes of the dropless MoE's three grouped products (gate, up
and down: ``ops.ragged_dot``, ``torch.nn.functional.grouped_mm`` on the
card) from what the engine counted in a wave (the instant ``serve.moe``:
``rows``, the sorted choices the products ran, pad positions counted;
``groups``, the non-empty (launch, expert) groups).

* FLOPs: 6 · rows · d · ff (three products of 2 · d · ff a row).
* Bytes, bf16: every non-empty group reads its expert's three matrices
  (groups · 3 · d · ff · 2), and every row reads and writes its
  activations: x twice (gate, up), g and u written, their product read by
  down, y written (rows · (3d + 3ff) · 2).

These count what the launches do, pads included, not what the requests
need: the share taken against them is the kernel's own.

A group of r rows does 2 · r · d · ff FLOPs on d · ff · 2 + r · (d + ff) · 2
bytes in one product: at d 2048 and ff 1024 fewer than ~520 rows a group
stay under the H100's ridge (989e12 / 3.35e12 ≈ 295 FLOP/B). The cell's
groups hold about 32 rows (a narrow step: 256 slots x 8 choices over 64
experts) and 256 (a compact replay: 2,048 positions x 8) on average, so
every launch is bound by its bytes; the bound of the sums (the larger of
all FLOPs over the peak and all bytes over the bandwidth) is then the sum
of the launches' bounds.
"""

from __future__ import annotations

from bench.constants import BF16_BYTES
from bench.counts import Shapes

__all__ = ["moe_need"]


def moe_need(s: Shapes, rows: int, groups: int) -> tuple[int, int]:
    """(FLOPs, bytes) of the grouped products over ``rows`` routed rows in
    ``groups`` non-empty expert groups."""
    d, ff = s.d, s.d_ff_expert
    flops = 6 * rows * d * ff
    nbytes = (groups * 3 * d * ff + rows * (3 * d + 3 * ff)) * BF16_BYTES
    return flops, nbytes
