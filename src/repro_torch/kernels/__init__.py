"""The port's kernels (CUDA C++ for sm_90a, built at first use), their
plain PyTorch versions, and the streaming pipeline around them."""

from repro_torch.kernels import autotune, ops, ref, stream_kernels
from repro_torch.kernels.distance import distance_cuda, distance_plain
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.rank_sort import rank_order_cuda, rank_order_plain
from repro_torch.kernels.sti_fill import (
    rect_row_view,
    sti_fill_acc_cuda,
    sti_fill_acc_plain,
    sti_fill_acc_rect_cuda,
    sti_fill_acc_rect_plain,
    sti_fill_cuda,
    sti_fill_plain,
    sti_fill_rect_cuda,
    sti_fill_rect_plain,
)
from repro_torch.kernels.sti_megakernel import (
    megakernel_rank_phase_cuda,
    megakernel_rank_phase_plain,
    merge_sorted_tile,
    point_megakernel_cuda,
    point_megakernel_plain,
    sti_megakernel_cuda,
    sti_megakernel_plain,
    streaming_merge_reference,
)
from repro_torch.kernels.sti_pipeline import (
    fused_sti_knn_interactions,
    interaction_state_from_numpy,
    make_stream_step,
    pad_test_batch,
    prepare_sharded_stream_step,
    prepare_stream_step,
    sharded_sti_knn_interactions,
    stream_point_values,
)

__all__ = [
    "autotune",
    "ops",
    "ref",
    "stream_kernels",
    "distance_cuda",
    "distance_plain",
    "flash_attention_cuda",
    "flash_attention_plain",
    "rank_order_cuda",
    "rank_order_plain",
    "sti_fill_cuda",
    "sti_fill_acc_cuda",
    "sti_fill_plain",
    "sti_fill_acc_plain",
    "sti_fill_rect_cuda",
    "sti_fill_acc_rect_cuda",
    "sti_fill_rect_plain",
    "sti_fill_acc_rect_plain",
    "rect_row_view",
    "sti_megakernel_cuda",
    "sti_megakernel_plain",
    "point_megakernel_cuda",
    "point_megakernel_plain",
    "megakernel_rank_phase_cuda",
    "megakernel_rank_phase_plain",
    "merge_sorted_tile",
    "streaming_merge_reference",
    "fused_sti_knn_interactions",
    "interaction_state_from_numpy",
    "make_stream_step",
    "pad_test_batch",
    "prepare_stream_step",
    "prepare_sharded_stream_step",
    "stream_point_values",
    "sharded_sti_knn_interactions",
]
