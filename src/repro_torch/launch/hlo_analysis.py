"""Roofline terms of the port's dry run: counterpart of
`repro.launch.hlo_analysis`.

compute term    = FLOPs per device / peak FLOP/s
memory term     = bytes per device / HBM bandwidth
collective term = collective bytes per device / link bandwidth

The reference reads FLOPs and bytes from XLA's cost analysis of the
compiled program and collective bytes from its HLO text. The port has
neither: `launch/dryrun.py` runs the step once on the meta device and
counts FLOPs with `torch.utils.flop_counter.FlopCounterMode`, bytes as
each dispatched op's inputs and outputs, and collective bytes as the
grid's own code moves them between cells
(`distributed.sharding.COLLECTIVES`). A hand-written kernel dispatches
no op: on meta tensors, while the dry run counts (`KERNELS.counting()`),
each wrapper returns a meta result of the kernel's shape and adds its
operations and bytes to `KERNELS` instead, by the formulas below — the
same ones `chip_smoke.py` bounds each kernel's time with, so there is
one definition of each kernel's cost. Outside that block a meta tensor
takes the kernel's path, as any tensor off the CPU does.

`HW` and the rates are NVIDIA's data-sheet peaks of one H100 SXM5 80GB
(dense, at its 700 W limit).
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import asdict, dataclass

__all__ = ["HW", "RooflineTerms", "KernelCost", "KERNELS", "roofline",
           "collective_bytes", "model_flops", "sti_model_flops",
           "distance_cost", "fill_cost", "rect_fill_cost",
           "sti_megakernel_cost", "point_megakernel_cost", "flash_cost",
           "visible_pairs", "sort_traffic", "sort_floor_ms",
           "rank_sort_cost", "point_update_cost"]

# H100 SXM5 data-sheet peaks (NVIDIA), dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # FMA counted as two operations
SIMPLE_OPS_PER_S = F32_FLOP_PER_S / 2  # one f32/int instruction per lane
BF16_FLOP_PER_S = 989e12        # tensor cores, dense
TF32_FLOP_PER_S = 495e12        # tensor cores, dense
NVLINK_BYTES_PER_S = 450e9      # NVLink 4, one direction

HW = {
    "peak_flops_bf16": BF16_FLOP_PER_S,
    "hbm_bw": HBM_BYTES_PER_S,
    "link_bw": NVLINK_BYTES_PER_S,
}


# ------------------------------------------------------- kernels' costs
@dataclass(frozen=True)
class KernelCost:
    """One kernel call's work: `ops` operations, `bytes` moved (each
    input read once, each output written once) and `ops_s`, the seconds
    those operations take at the card's peak for their type."""

    ops: float
    bytes: float
    ops_s: float

    def bound_ms(self) -> tuple[float, str]:
        """The least time the card could take, and what bounds it: the
        larger of bytes over the memory rate and `ops_s`."""
        by_bytes = self.bytes / HBM_BYTES_PER_S
        return 1e3 * max(by_bytes, self.ops_s), \
            "bytes" if by_bytes > self.ops_s else "operations"


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


def rect_fill_cost(t, nr, n) -> KernelCost:
    """The (nr, n) block read and written once, g and the rank table read
    once (the row table is a window of it). Outside the window's columns
    every element needs one compare, one select and one add per test
    point; the (nr, nr) block on the window's diagonal is symmetric, so it
    needs only its nr(nr+1)/2 pairs on and above the diagonal, and one add
    for each of the nr(nr-1)/2 below it to mirror them."""
    ops = (3.0 * t * (nr * (n - nr) + nr * (nr + 1) / 2)
           + float(nr) * (nr - 1) / 2)
    return KernelCost(ops, 2 * nr * n * 4 + 2 * t * n * 4,
                      ops / SIMPLE_OPS_PER_S)


def sti_megakernel_cost(t, n, d) -> KernelCost:
    """x_train, the batch and the labels read once, acc read and written
    once; the fill's operations (`fill_cost`) on the CUDA cores and the
    distance's 2 t n d on the tensor cores (`distance_cost`), two pipes
    that could overlap, so the larger of the two times. The sort and the
    tables are O(t n) and left out."""
    dist, fill = distance_cost(t, n, d, 4), fill_cost(t, n)
    nbytes = 2 * n * n * 4 + (n * d + t * d) * 4 + (n + t) * 4 + 2 * n * 4
    return KernelCost(dist.ops + fill.ops, nbytes,
                      max(dist.ops_s, fill.ops_s))


def point_megakernel_cost(t, n, d) -> KernelCost:
    """x_train and the batch read once, vec read and written once; the
    distance's 2 t n d on the tensor cores (`distance_cost`)."""
    dist = distance_cost(t, n, d, 4)
    return KernelCost(dist.ops, (n * d + t * d) * 4 + (n + t) * 4
                      + 2 * n * 4, dist.ops_s)


@functools.lru_cache(maxsize=None)
def visible_pairs(s, sk, causal, window) -> int:
    """(query, key) pairs that the causal / window masks leave visible
    (cached: the dry run asks once a layer)."""
    total = 0
    for q in range(s):
        hi = min(sk - 1, q) if causal else sk - 1
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def flash_cost(b, h, s, sk, d, causal, window, elt) -> KernelCost:
    """q, k, v read once and out written once; two products of 2 d
    operations per visible pair, at the tensor cores' rate for bf16
    inputs and the f32 rate for f32."""
    ops = 4.0 * b * h * d * visible_pairs(s, sk, causal, window)
    peak = BF16_FLOP_PER_S if elt == 2 else F32_FLOP_PER_S
    return KernelCost(ops, (2 * s + 2 * sk) * b * h * d * elt, ops / peak)


def sort_traffic(n, passes, ranks: bool = False) -> float:
    """The bytes a stable LSD radix sort of rows of `n` f32 keys moves,
    the port's two sorts' own traffic: per row, two prologue reads of the
    keys (the minimum and maximum, then the digit histograms: 4 n bytes
    each), the first pass (keys read, (key, index) pairs written: 12 n)
    and each later pass (16 n), so 4 n + 16 n P bytes for a row of P
    passes (`passes` holds each row's). `ranks` adds the int64 inverse
    permutation that `csrc/rank_sort.cu`'s last pass writes beside the
    order (8 n a row); the megakernel's sort writes none."""
    per_key = [4 + 16 * int(p) + (8 if ranks else 0) for p in passes]
    return float(n * sum(per_key))


def sort_floor_ms(n, passes) -> float:
    """The megakernel sort's own traffic (`sort_traffic`) over the card's
    memory rate."""
    return 1e3 * sort_traffic(n, passes) / HBM_BYTES_PER_S


def rank_sort_cost(t, n) -> KernelCost:
    """The rank stage on (t, n) f32 keys at its floor: the keys read once
    (4 bytes a key) and the int64 `order` and `ranks` written once (16).
    The sort's own traffic at P passes, `sort_traffic(n, passes,
    ranks=True)` (12 + 16 P bytes a key), is how far `csrc/rank_sort.cu`'s
    radix design stands above it. No operation is counted: the sort
    moves keys and compares none."""
    return KernelCost(0.0, 20.0 * t * n, 0.0)


def point_update_cost(t, n) -> KernelCost:
    """The knn point update on (t, n) at its floor: u (f32) and ranks
    (int64) read once, 12 bytes a key, and the (n,) f32 vector read and
    written once. `csrc/point_update.cu`'s two phases also write and read
    the per-row values once (20 bytes a key). No operation is counted:
    a few per key, far under the bytes' time."""
    return KernelCost(0.0, 12.0 * t * n + 8.0 * n, 0.0)


class _KernelCounts:
    """The running sum of the kernels' costs on meta tensors: while
    `active` (inside `counting()`), each wrapper's abstract path calls
    `add`; the dry run reads the sums."""

    def __init__(self):
        self.active = False
        self.reset()

    def reset(self) -> None:
        self.ops, self.bytes, self.calls = 0.0, 0.0, {}

    @contextlib.contextmanager
    def counting(self):
        """Zero the sums and take the wrappers' meta path in the block."""
        self.reset()
        was, self.active = self.active, True
        try:
            yield self
        finally:
            self.active = was

    def add(self, name: str, cost: KernelCost) -> None:
        self.ops += cost.ops
        self.bytes += cost.bytes
        self.calls[name] = self.calls.get(name, 0) + 1


KERNELS = _KernelCounts()


# ------------------------------------------------------------- roofline
def collective_bytes(counter=None) -> dict:
    """{kind: bytes, ..., "total": bytes} moved into the fullest cell (the
    one receiving the most) as counted by `counter` (default
    `distributed.sharding.COLLECTIVES`): the shape of the reference's
    per-chip dict, kinds "all-gather", "all-reduce", "collective-permute"."""
    if counter is None:
        from repro_torch.distributed.sharding import COLLECTIVES as counter
    out = dict(counter.fullest())
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


@dataclass
class RooflineTerms:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    peak_memory_per_chip: float
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / (FLOPs per chip * chips)

    def asdict(self):
        return asdict(self)


def roofline(flops: float, nbytes: float, coll: float, n_chips: int,
             model_flops_: float = 0.0, peak_memory: float = 0.0
             ) -> RooflineTerms:
    """The terms of one cell from its per-device FLOPs, bytes and
    collective bytes (the reference's `analyze_compiled`, fed by the meta
    run's counts instead of XLA's)."""
    t_c = flops / HW["peak_flops_bf16"]
    t_m = nbytes / HW["hbm_bw"]
    t_l = coll / HW["link_bw"]
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    useful = (model_flops_ / (flops * n_chips)) if flops else 0.0
    return RooflineTerms(
        flops_per_chip=flops, bytes_per_chip=nbytes,
        coll_bytes_per_chip=coll, t_compute=t_c, t_memory=t_m,
        t_collective=t_l, bottleneck=max(terms, key=terms.get),
        peak_memory_per_chip=peak_memory, model_flops=model_flops_,
        useful_ratio=useful)


def sti_model_flops(scfg) -> float:
    """Useful work of one STI-KNN valuation step (global):
    distance GEMM (2 t n d) + rank/g (~t n log n, negligible) + fill
    (t * n^2 gather-max-add, counted as 3 ops)."""
    t, n, d = scfg.test_chunk, scfg.n_train, scfg.feat_dim
    return float(2 * t * n * d + 3 * t * n * n)


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N*D forward-only.
    N counts ACTIVE params (MoE: top-k experts only); D = tokens."""
    from repro_torch.configs.base import PD, tree_leaves
    from repro_torch.models import build_model

    total = 0
    for pd in tree_leaves(build_model(cfg).desc(),
                          is_leaf=lambda x: isinstance(x, PD)):
        n = 1
        for s in pd.shape:
            n *= s
        if "expert" in pd.axes:  # scale expert params by topk/E
            n = n * cfg.experts_per_token // max(cfg.num_experts, 1)
        total += n
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    return float(mult * total * tokens)
