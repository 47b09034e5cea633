"""Public kernel entry points and the CUDA fills' registration.

Counterpart of `repro.kernels.ops`. `sti_fill`, `pairwise_distance` and
`flash_attention` pick by the device of their inputs: the CUDA kernel for
CUDA tensors, the plain version for CPU tensors (the JAX package picks
the Pallas kernel on a TPU and its oracle elsewhere, or as `use_pallas`
says). There is no `use_pallas` switch and no `pallas_supported`: the
tensors' device decides, and a CUDA tensor always takes the kernel.

`repro.kernels.ops` registers the Pallas fills as "pallas". Here the
kernels register as "cuda" in all four registries:

    sti_knn_interactions(..., fill="cuda")

resolves to `sti_fill_cuda` (zero-init) and `sti_fill_acc_cuda` (in
place), and the sharded engine's row-block update to
`sti_fill_rect_cuda` / `sti_fill_acc_rect_cuda`. `repro_torch/__init__`
imports this module, so the registration happens at package import time;
importing it builds nothing.
"""

from __future__ import annotations

from repro_torch.core.sti_knn import (
    register_acc_fill_fn,
    register_fill_fn,
    register_rect_acc_fill_fn,
    register_rect_fill_fn,
)
from repro_torch.kernels.distance import distance_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.sti_fill import (
    sti_fill_acc_cuda,
    sti_fill_acc_rect_cuda,
    sti_fill_cuda,
    sti_fill_rect_cuda,
)

__all__ = ["sti_fill", "pairwise_distance", "flash_attention"]


def sti_fill(g, ranks):
    """out[a, b] = sum_p g[p, max(ranks[p, a], ranks[p, b])] -> (n, n) f32
    from (t, n) g and (t, n) ranks: the kernel of `csrc/sti_fill.cu` on
    CUDA tensors, `sti_fill_plain` on CPU tensors (see
    `kernels.sti_fill`)."""
    return sti_fill_cuda(g, ranks)


def pairwise_distance(x_test, x_train):
    """(t, d), (n, d) -> (t, n) squared L2 distances, clamped at 0, f32
    accumulation: the kernel of `csrc/distance.cu` on CUDA tensors,
    `distance_plain` on CPU tensors (see `kernels.distance`)."""
    return distance_cuda(x_test, x_train)


def flash_attention(q, k, v, *, causal=True, window=None):
    """(b, h, s, d) attention with K/V heads already repeated: the kernel
    of `csrc/flash_attention.cu` on CUDA tensors, `flash_attention_plain`
    on CPU tensors (see `kernels.flash_attention`)."""
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


register_fill_fn("cuda", sti_fill_cuda)
register_acc_fill_fn("cuda", sti_fill_acc_cuda)
register_rect_fill_fn("cuda", sti_fill_rect_cuda)
register_rect_acc_fill_fn("cuda", sti_fill_acc_rect_cuda)
