"""repro_torch: the STI-KNN valuation system in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package `repro`, which stays the reference. Module paths
mirror it (`repro_torch.kernels.sti_fill` is the counterpart of
`repro.kernels.sti_fill`); this package imports neither `jax` nor `repro`.

    from repro_torch import get_method
    result = get_method("sti")(x_train, y_train, x_test, y_test, k=5)
    values = get_method("knn_shapley")(x_train, y_train, x_test, y_test)
    sharded = get_method("sti")(x_train, y_train, x_test, y_test, k=5,
                                engine="sharded", devices=["cuda"] * 4)
    approx = get_method("knn_shapley")(x_train, y_train, x_test, y_test,
                                       engine="approx", top_m=256)

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`, which runs every kernel's plain PyTorch version.

`ResilientValuationSession` wraps a session in guarded retries, atomic
checksummed checkpoints and NaN rollback; `repro_torch.serving.
valuation_service.ValuationService` serves valuation requests over a
mutable train set on top of it.

The LM substrate (dense decoders) lives in `repro_torch.models` and
`repro_torch.serving`; prefill attention runs the flash-attention kernel.
"""

from repro_torch.core import (
    ENGINES,
    ApproxValuationSession,
    ResilientValuationSession,
    ShardedValuationSession,
    ValuationMethod,
    ValuationResult,
    ValuationSession,
    analysis,
    get_method,
    knn_shapley_values,
    list_methods,
    loo_values,
    register_method,
    sti_knn_interactions,
    wknn_shapley_values,
)

from repro_torch.core.valuation import DataValuator

# Importing the kernels package registers the CUDA fills ("cuda") in the
# core fill registries; it builds nothing.
from repro_torch.kernels import ops as _ops  # noqa: F401
from repro_torch.kernels.sti_pipeline import fused_sti_knn_interactions

__all__ = [
    "sti_knn_interactions",
    "fused_sti_knn_interactions",
    "knn_shapley_values",
    "wknn_shapley_values",
    "loo_values",
    "analysis",
    "ENGINES",
    "DataValuator",
    "ValuationResult",
    "ValuationSession",
    "ShardedValuationSession",
    "ApproxValuationSession",
    "ResilientValuationSession",
    "ValuationMethod",
    "register_method",
    "get_method",
    "list_methods",
]
