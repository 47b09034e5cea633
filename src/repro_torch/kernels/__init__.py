"""The port's kernels (CUDA C++ for sm_90a, built at first use), their
plain PyTorch versions, and the streaming pipeline around them."""

from repro_torch.kernels import autotune, ops, ref, stream_kernels
from repro_torch.kernels.distance import distance_cuda, distance_plain
from repro_torch.kernels.sti_fill import (
    sti_fill_acc_cuda,
    sti_fill_acc_plain,
    sti_fill_cuda,
    sti_fill_plain,
)
from repro_torch.kernels.sti_pipeline import (
    fused_sti_knn_interactions,
    interaction_state_from_numpy,
    make_fused_step,
    pad_test_batch,
    prepare_fused_step,
)

__all__ = [
    "autotune",
    "ops",
    "ref",
    "stream_kernels",
    "distance_cuda",
    "distance_plain",
    "sti_fill_cuda",
    "sti_fill_acc_cuda",
    "sti_fill_plain",
    "sti_fill_acc_plain",
    "fused_sti_knn_interactions",
    "interaction_state_from_numpy",
    "make_fused_step",
    "pad_test_batch",
    "prepare_fused_step",
]
