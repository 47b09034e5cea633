"""KNN-Shapley (Jia et al., 2019): exact single-point Shapley values of the
KNN utility, the paper's primary baseline.

Counterpart of `repro.core.knn_shapley`. Recurrence, per test point, with
train points sorted closest-first (1-based position i, m(i) = 1[label
match]):

  s_{alpha_n} = m(n) / n * min(k, n) / k
  s_{alpha_i} = s_{alpha_{i+1}} + (m(i) - m(i+1)) / k * min(k, i) / i

vectorized as a reverse cumulative sum (`knn_shapley_from_sorted`).
`knn_shapley_values` is a thin wrapper over the method-generic streaming
pipeline (`repro_torch.kernels.sti_pipeline.stream_point_values`, update
kernel "knn_shapley").
"""

from __future__ import annotations

import torch

__all__ = ["knn_shapley_values", "knn_shapley_from_sorted"]


def knn_shapley_from_sorted(match_sorted: torch.Tensor, k: int
                            ) -> torch.Tensor:
    """(..., n) label match (or any per-point value) in sorted order ->
    (..., n) f32 Shapley values in SORTED coordinates.

    Linear in `match_sorted`, which lets the streaming engine fold a
    validity mask in and reuse this closed form for the weighted
    contribution vector of `repro_torch.core.wknn`. Every rounding step is
    the JAX reference's: last = m[-1] * min(k, n) / (k n), step =
    (m[i] - m[i+1]) * min(k, i) / i / k, s = last + reverse cumsum."""
    m = match_sorted.to(torch.float32)
    n = m.shape[-1]
    i1 = torch.arange(n, dtype=torch.float32, device=m.device) + 1.0
    last = m[..., -1:] * min(k, n) / (k * n)
    diff = m[..., :-1] - m[..., 1:]
    coef = torch.clamp_max(i1[:-1], float(k)) / i1[:-1]
    step = diff * coef / k
    suffix = torch.flip(torch.cumsum(torch.flip(step, [-1]), -1), [-1])
    return torch.cat([last + suffix, last], dim=-1)


def knn_shapley_values(x_train, y_train, x_test, y_test, k: int, *,
                       test_batch: int = 512, distance: str = "plain",
                       device="cuda") -> torch.Tensor:
    """(n,) Shapley values of the KNN utility, averaged over the test set,
    on `device`. `distance` picks the distance stage ("plain" by default,
    the counterpart of the reference's deterministic "xla"; "cuda" or
    "auto" takes the CUDA kernel on a card)."""
    from repro_torch.kernels.sti_pipeline import stream_point_values

    return stream_point_values(
        "knn_shapley", x_train, y_train, x_test, y_test, int(k),
        test_batch=test_batch, distance=distance, device=device,
    )
