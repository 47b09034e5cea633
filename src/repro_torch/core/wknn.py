"""Weighted KNN-Shapley: exact Shapley values for the soft-label weighted
KNN utility, streamed in O(t n^2) with no subset enumeration.

Counterpart of `repro.core.wknn`. The utility

    v(S) = (1/k) * sum_{j in topk_S} w_j * 1[y_j == y_test]

is linear in the per-point contribution c_j = w_j * 1[y_j == y_test], so
the KNN-Shapley recurrence (`repro_torch.core.knn_shapley`) applied to c
gives the exact values. Weight schemes (from squared distances, row-wise,
so independent of how test points are batched):

  * "rbf"     w = exp(-d2 / (2 sigma_p^2)), sigma_p^2 = mean_j d2[p, j]
              over the real columns (d2 < 1e20) of the row;
  * "inverse" w = 1 / (1 + sqrt(d2));
  * "uniform" w = 1 (recovers unweighted KNN-Shapley).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["wknn_shapley_values", "distance_weights", "WEIGHT_KINDS"]

WEIGHT_KINDS = ("rbf", "inverse", "uniform")


def distance_weights(d2: torch.Tensor, kind: str = "rbf", *,
                     sigma2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(t, n) squared distances -> (t, n) weights in (0, 1].

    `sigma2` (broadcastable to d2, typically (t, 1)) overrides the rbf
    bandwidth. Without it the bandwidth is the row mean over REAL columns
    only: soft-deleted train slots (the online service's fixed-capacity
    scheme) carry squared distances ~1e30, which would otherwise blow up
    the mean; the 1e20 cutoff keeps sentinel-free rows' mean unchanged."""
    if kind == "rbf":
        if sigma2 is not None:
            return torch.exp(-d2 / (2.0 * torch.clamp_min(sigma2, 1e-12)))
        real = d2 < 1e20
        cnt = torch.clamp_min(real.sum(-1, keepdim=True), 1)
        sigma2 = torch.clamp_min(
            torch.where(real, d2, 0.0).sum(-1, keepdim=True) / cnt, 1e-12)
        return torch.exp(-d2 / (2.0 * sigma2))
    if kind == "inverse":
        return 1.0 / (1.0 + torch.sqrt(d2))
    if kind == "uniform":
        return torch.ones_like(d2)
    raise ValueError(
        f"unknown weight kind {kind!r}; choose from {WEIGHT_KINDS}"
    )


def wknn_shapley_values(x_train, y_train, x_test, y_test, k: int, *,
                        weights: str = "rbf", test_batch: int = 512,
                        distance: str = "plain", device="cuda"
                        ) -> torch.Tensor:
    """(n,) exact Shapley values of the soft-label weighted KNN utility,
    averaged over the test set, on `device`. `weights` is one of
    WEIGHT_KINDS; `distance` as in `knn_shapley_values`."""
    if weights not in WEIGHT_KINDS:
        raise ValueError(
            f"unknown weight kind {weights!r}; choose from {WEIGHT_KINDS}"
        )
    from repro_torch.kernels.sti_pipeline import stream_point_values

    return stream_point_values(
        "wknn", x_train, y_train, x_test, y_test, int(k),
        test_batch=test_batch, method_opts={"weights": weights},
        distance=distance, device=device,
    )
