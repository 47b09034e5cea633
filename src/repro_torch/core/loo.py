"""Leave-one-out (LOO) data valuation for the KNN utility.

Counterpart of `repro.core.loo`. LOO_i = v(N) - v(N \\ {i}): removing
train point i changes the prediction for a test point only if rank(i) <
k, where the (k+1)-th neighbour slides into the window, so the delta is
(m(i) - m(k+1-th)) / k. `loo_values` is a thin wrapper over the
method-generic streaming pipeline (update kernel "loo").
"""

from __future__ import annotations

import torch

__all__ = ["loo_values"]


def loo_values(x_train, y_train, x_test, y_test, k: int, *,
               test_batch: int = 512, distance: str = "plain",
               device="cuda") -> torch.Tensor:
    """(n,) leave-one-out values of the KNN utility, averaged over the test
    set, on `device`; `distance` as in `knn_shapley_values`."""
    from repro_torch.kernels.sti_pipeline import stream_point_values

    return stream_point_values(
        "loo", x_train, y_train, x_test, y_test, int(k),
        test_batch=test_batch, distance=distance, device=device,
    )
