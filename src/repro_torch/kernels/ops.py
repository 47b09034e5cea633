"""Register the CUDA fill kernels with the core fill registries.

Counterpart of `repro.kernels.ops`, which registers the Pallas fills as
"pallas". Here the kernels register as "cuda" in all four registries:

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
from repro_torch.kernels.sti_fill import (
    sti_fill_acc_cuda,
    sti_fill_acc_rect_cuda,
    sti_fill_cuda,
    sti_fill_rect_cuda,
)

__all__: list[str] = []

register_fill_fn("cuda", sti_fill_cuda)
register_acc_fill_fn("cuda", sti_fill_acc_cuda)
register_rect_fill_fn("cuda", sti_fill_rect_cuda)
register_rect_acc_fill_fn("cuda", sti_fill_acc_rect_cuda)
