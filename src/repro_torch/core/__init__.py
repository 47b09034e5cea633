"""Core valuation math, results and the method registry of the port."""

from repro_torch.core.sti_knn import (
    accumulate_fill,
    accumulate_rect_fill,
    pairwise_sq_dists,
    ranks_from_distances,
    ranks_from_order,
    register_acc_fill_fn,
    register_fill_fn,
    register_rect_acc_fill_fn,
    register_rect_fill_fn,
    resolve_fill,
    resolve_rect_fill,
    sti_knn_interactions,
    sti_knn_matrix_one_test,
    superdiagonal_g,
    superdiagonal_g_topm,
)
from repro_torch.core import analysis
from repro_torch.core.knn_shapley import (
    knn_shapley_from_sorted,
    knn_shapley_values,
)
from repro_torch.core.loo import loo_values
from repro_torch.core.results import ValuationResult
from repro_torch.core.session import (
    ApproxValuationSession,
    ShardedValuationSession,
    ValuationSession,
)
from repro_torch.core.resilient import ResilientValuationSession
from repro_torch.core.wknn import (
    WEIGHT_KINDS,
    distance_weights,
    wknn_shapley_values,
)
from repro_torch.core.methods import (
    ENGINES,
    ValuationMethod,
    get_method,
    list_methods,
    register_method,
    valid_engines,
)

__all__ = [
    "sti_knn_interactions",
    "sti_knn_matrix_one_test",
    "superdiagonal_g",
    "superdiagonal_g_topm",
    "pairwise_sq_dists",
    "ranks_from_distances",
    "ranks_from_order",
    "register_fill_fn",
    "register_acc_fill_fn",
    "accumulate_fill",
    "resolve_fill",
    "register_rect_fill_fn",
    "register_rect_acc_fill_fn",
    "accumulate_rect_fill",
    "resolve_rect_fill",
    "analysis",
    "knn_shapley_values",
    "knn_shapley_from_sorted",
    "wknn_shapley_values",
    "distance_weights",
    "WEIGHT_KINDS",
    "loo_values",
    "ValuationResult",
    "ValuationSession",
    "ShardedValuationSession",
    "ApproxValuationSession",
    "ResilientValuationSession",
    "ValuationMethod",
    "ENGINES",
    "valid_engines",
    "register_method",
    "get_method",
    "list_methods",
]
