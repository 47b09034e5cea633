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
from repro_torch.kernels.sti_megakernel import (
    megakernel_rank_phase_cuda,
    megakernel_rank_phase_plain,
    point_megakernel_cuda,
    point_megakernel_plain,
    sti_megakernel_cuda,
    sti_megakernel_plain,
)
from repro_torch.kernels.sti_pipeline import (
    fused_sti_knn_interactions,
    interaction_state_from_numpy,
    make_fused_step,
    make_point_step,
    pad_test_batch,
    prepare_fused_step,
    prepare_stream_step,
    stream_point_values,
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
    "sti_megakernel_cuda",
    "sti_megakernel_plain",
    "point_megakernel_cuda",
    "point_megakernel_plain",
    "megakernel_rank_phase_cuda",
    "megakernel_rank_phase_plain",
    "fused_sti_knn_interactions",
    "interaction_state_from_numpy",
    "make_fused_step",
    "make_point_step",
    "pad_test_batch",
    "prepare_fused_step",
    "prepare_stream_step",
    "stream_point_values",
]
