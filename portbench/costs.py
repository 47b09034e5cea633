"""The benchmark's yardstick of work: a frozen copy of the port's kernel
cost formulas (`repro_torch.launch.hlo_analysis` as of the benchmark's
first version) and the card's data-sheet peaks.

The port may change its own copy; the roofline and `mfu` metrics read
this one, so a later change to the program cannot move the bound it is
measured against. Each cost counts each input byte read once and each
output byte written once, and the operations the algorithm needs.

Peaks: NVIDIA H100 SXM5 80GB data sheet, dense rates, at its 700 W limit.
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12            # FMA counted as two operations
SIMPLE_OPS_PER_S = F32_FLOP_PER_S / 2  # one f32/int instruction per lane
BF16_FLOP_PER_S = 989e12          # tensor cores, dense
TF32_FLOP_PER_S = 495e12          # tensor cores, dense


@dataclass(frozen=True)
class KernelCost:
    """One call's work: `ops` operations, `bytes` moved and `ops_s`, the
    seconds those operations take at the card's peak for their type."""

    ops: float
    bytes: float
    ops_s: float

    def bound_ms(self) -> float:
        """The least time the card could take: the larger of bytes over
        the memory rate and `ops_s`, in milliseconds."""
        return 1e3 * max(self.bytes / HBM_BYTES_PER_S, self.ops_s)

    def bound_by(self) -> str:
        """"bytes" or "operations": which of the two sets the bound."""
        return ("bytes" if self.bytes / HBM_BYTES_PER_S > self.ops_s
                else "operations")


def distance_cost(t, n, d, elt) -> KernelCost:
    """x_test and x_train read once, the (t, n) output written once; the
    cross term's 2 t n d operations at the tensor cores' rate for the
    inputs' type (TF32 for f32, bf16 for bf16)."""
    peak = BF16_FLOP_PER_S if elt == 2 else TF32_FLOP_PER_S
    ops = 2.0 * t * n * d
    return KernelCost(ops, (t * d + n * d) * elt + t * n * 4, ops / peak)


def fill_cost(t, n) -> KernelCost:
    """acc read and written once, g and ranks read once. The increment is
    symmetric, so the function needs only the n(n+1)/2 pairs on and above
    the diagonal -- per test point one compare, one select and one add
    each -- and one add per element to mirror them into the other half."""
    ops = 3.0 * t * n * (n + 1) / 2 + float(n) * n
    return KernelCost(ops, 2 * n * n * 4 + 2 * t * n * 4,
                      ops / SIMPLE_OPS_PER_S)


def sti_megakernel_cost(t, n, d) -> KernelCost:
    """The whole sti step's work, whatever implements it: x_train, the
    batch and the labels read once, acc read and written once; the fill's
    operations on the CUDA cores and the distance's 2 t n d on the tensor
    cores, two pipes that could overlap, so the larger of the two times.
    The sort and the tables are O(t n) and left out."""
    dist, fill = distance_cost(t, n, d, 4), fill_cost(t, n)
    nbytes = 2 * n * n * 4 + (n * d + t * d) * 4 + (n + t) * 4 + 2 * n * 4
    return KernelCost(dist.ops + fill.ops, nbytes,
                      max(dist.ops_s, fill.ops_s))


def point_megakernel_cost(t, n, d) -> KernelCost:
    """The whole point-value step's work: x_train and the batch read once,
    vec read and written once; the distance's 2 t n d on the tensor
    cores. The sort is left out."""
    dist = distance_cost(t, n, d, 4)
    return KernelCost(dist.ops, (n * d + t * d) * 4 + (n + t) * 4
                      + 2 * n * 4, dist.ops_s)
