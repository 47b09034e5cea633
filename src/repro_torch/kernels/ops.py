"""Public kernel entry points and the CUDA fills' registration.

Counterpart of `repro.kernels.ops`. `flash_attention` picks by the device
of its inputs: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors (the JAX package picks the Pallas kernel on a TPU and its
oracle elsewhere).

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
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.sti_fill import (
    sti_fill_acc_cuda,
    sti_fill_acc_rect_cuda,
    sti_fill_cuda,
    sti_fill_rect_cuda,
)

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, causal=True, window=None):
    """(b, h, s, d) attention with K/V heads already repeated: the kernel
    of `csrc/flash_attention.cu` on CUDA tensors, `flash_attention_plain`
    on CPU tensors (see `kernels.flash_attention`)."""
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


register_fill_fn("cuda", sti_fill_cuda)
register_acc_fill_fn("cuda", sti_fill_acc_cuda)
register_rect_fill_fn("cuda", sti_fill_rect_cuda)
register_rect_acc_fill_fn("cuda", sti_fill_acc_rect_cuda)
