"""Certified error bounds for the approximate top-m valuation engine.

The port's own copy of `repro.core.approx` (numpy only, float64; the
tests hold it against the original function by function).
`engine="approx"` truncates every per-test-point recurrence to the m
candidates its LSH index proposed. The candidates are sorted by EXACT
distance, so whenever the measured matched prefix is P -- the first P
candidates equal the true P nearest neighbours, verified by the in-step
recall probe (`repro_torch.kernels.ann.matched_prefix_and_recall`) --
every recurrence term over positions 1..P is exactly the term the dense
engine computes. The approximation error is then bounded entirely by the
coefficient mass of the UN-verified tail, which this module sums in
closed form on the host: the bound is a deterministic function of
(method, n, k, m, P) and does not depend on the data at all, which is
what makes it a certificate rather than an estimate.

Coefficient facts used (1-based position i, 0-based recurrence index j0):

  * point recurrences (knn_shapley / wknn): per-position coefficient
    c(i) = min(k, i) / (k i); tail mass T(a) = sum_{i=a}^{n} c(i);
    per-point contributions live in [0, u_max] (u_max = 1: label matches
    and rbf/inverse/uniform weights are all <= 1);
  * interaction recurrences (sti / sii): step coefficient step(j0)
    (active for j0 > k, j0 >= 2) and anchor |last(n)|, from
    `repro_torch.core.sti_knn._recurrence_coeffs`; per-position u in
    [0, u_max] with u_max = 1/k;
  * loo: a point's value is nonzero only if it sits in the exact
    top-(k+1) window, so a matched prefix P >= k+1 certifies loo exactly
    (bound 0) and the worst case otherwise is 2 u_max / k.

All functions take 1-based prefix COUNTS (P = number of leading verified
positions, 0 if nothing is verified) and return plain floats.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "harmonic_number",
    "point_coef",
    "shapley_tail",
    "step_coef_sum",
    "point_error_bound",
    "interaction_error_bound",
    "error_bound",
    "POINT_METHODS",
    "INTERACTION_MODES",
]

POINT_METHODS = ("knn_shapley", "wknn", "loo")
INTERACTION_MODES = ("sti", "sii")

# Above this, H(x) switches from the exact vectorized sum to the
# asymptotic expansion (absolute error < 1e-14 there -- far below f32).
_EXACT_HARMONIC_LIMIT = 1 << 22
_EULER_GAMMA = 0.5772156649015328606


def harmonic_number(x: int) -> float:
    """H(x) = sum_{i=1}^{x} 1/i (H(0) = 0), exact vectorized float64 sum up
    to 2^22 and the Euler-Maclaurin expansion beyond (abs err < 1e-14)."""
    x = int(x)
    if x <= 0:
        return 0.0
    if x <= _EXACT_HARMONIC_LIMIT:
        return float(np.sum(1.0 / np.arange(1, x + 1, dtype=np.float64)))
    xf = float(x)
    return float(
        np.log(xf) + _EULER_GAMMA + 1.0 / (2.0 * xf) - 1.0 / (12.0 * xf * xf)
    )


def point_coef(i: int, k: int) -> float:
    """c(i) = min(k, i) / (k i), the KNN-Shapley recurrence coefficient at
    1-based sorted position i (c(i) = 1/k for i <= k, 1/i beyond)."""
    i, k = int(i), int(k)
    if i < 1:
        raise ValueError(f"position must be >= 1, got {i}")
    return min(k, i) / (k * i)


def shapley_tail(a: int, n: int, k: int) -> float:
    """T(a) = sum_{i=a}^{n} c(i): the total coefficient mass of sorted
    positions a..n in the KNN-Shapley recurrence (0 if a > n). Closed
    form: max(0, min(k, n) - a + 1)/k + H(n) - H(max(k, a-1))."""
    a, n, k = int(a), int(n), int(k)
    if a > n:
        return 0.0
    a = max(a, 1)
    in_window = max(0, min(k, n) - a + 1) / k
    return in_window + harmonic_number(n) - harmonic_number(max(k, a - 1))


def step_coef_sum(a: int, b: int, k: int, mode: str) -> float:
    """sum_{j0=a}^{b} step_coef(j0) of the interaction g recurrence
    (0-based j0; coefficients are active only for j0 > k, j0 >= 2):
    sti: 2 (j0 - k) / ((j0 - 1) j0); sii: 1 / (j0 - 1). Returns 0 for an
    empty range."""
    if mode not in INTERACTION_MODES:
        raise ValueError(f"unknown interaction mode {mode!r}")
    lo = max(int(a), int(k) + 1, 2)
    hi = int(b)
    if lo > hi:
        return 0.0
    j0 = np.arange(lo, hi + 1, dtype=np.float64)
    if mode == "sti":
        return float(np.sum(2.0 * (j0 - k) / ((j0 - 1.0) * j0)))
    return float(np.sum(1.0 / (j0 - 1.0)))


def _last_coef_abs(n: int, k: int, mode: str) -> float:
    """|last_coef(n)| of the g recurrence anchor (0 when n <= k)."""
    if n <= k or n < 2:
        return 0.0
    if mode == "sti":
        return 2.0 * (n - k) / (n * (n - 1.0))
    return 1.0 / (n - 1.0)


def point_error_bound(
    method: str, *, n: int, k: int, m: int, prefix: int, u_max: float = 1.0
) -> float:
    """Certified max |approx - exact| per POINT VALUE for one test fold.

    Args:
      method: "knn_shapley", "wknn" or "loo".
      n: full training-set size; m: candidate-list length (m >= k+1);
      prefix: verified matched-prefix count P (candidate positions 1..P
        proven equal to the true nearest neighbours), clipped to [0, m].
      u_max: per-point contribution ceiling (1 for all built-in methods).

    With P >= m every estimator term is exact and only the truncated tail
    remains: u_max (c(m) + T(m+1)). Otherwise positions beyond P are
    unverified on both sides: u_max (2 T(P+1) + c(max(P, 1))). loo: exact
    (0) once P >= k+1, else 2 u_max / k. The result is a sound bound for
    every train point -- matched, unmatched, or absent from the
    candidate list (absent points keep value 0 in the estimator and have
    true value at most u_max T(P+1)).
    """
    if method not in POINT_METHODS:
        raise ValueError(f"unknown point method {method!r}")
    n, k, m = int(n), int(k), int(m)
    p = max(0, min(int(prefix), m))
    if m >= n and p >= n:
        return 0.0
    if method == "loo":
        return 0.0 if p >= k + 1 else 2.0 * u_max / k
    if p >= m:
        return u_max * (point_coef(m, k) + shapley_tail(m + 1, n, k))
    return u_max * (
        2.0 * shapley_tail(p + 1, n, k) + point_coef(max(p, 1), k)
    )


def interaction_error_bound(
    mode: str, *, n: int, k: int, m: int, prefix: int,
    u_max: float | None = None,
) -> float:
    """Certified max |approx - exact| per OFF-DIAGONAL PAIR for one test
    fold of the sti/sii g recurrence (the diagonal is computed exactly by
    the approx engine -- it only needs label comparisons).

    With matched prefix P, both g and its truncated estimate agree on all
    step terms below P; the difference collects the exact tail
    sum_{j0>=P} (2 u_max per step), the estimator's own unverified steps
    over [P, m-1], and the two anchor terms:

        u_max (2 S(P, n-1) + 2 S(P, m-1) + 2 |last(n)|)

    where S = `step_coef_sum`. u_max defaults to 1/k (u = match/k).
    This also dominates |g| + |g_hat| for pairs outside the verified
    prefix, so it holds for every stored or dropped pair.
    """
    if mode not in INTERACTION_MODES:
        raise ValueError(f"unknown interaction mode {mode!r}")
    n, k, m = int(n), int(k), int(m)
    if u_max is None:
        u_max = 1.0 / k
    p = max(0, min(int(prefix), m))
    if m >= n and p >= n:
        return 0.0
    return u_max * (
        2.0 * step_coef_sum(p, n - 1, k, mode)
        + 2.0 * step_coef_sum(p, m - 1, k, mode)
        + 2.0 * _last_coef_abs(n, k, mode)
    )


def error_bound(
    method: str, *, n: int, k: int, m: int, prefix: int,
    u_max: float | None = None,
) -> float:
    """Dispatch to the point or interaction bound by method name; this is
    what `ApproxValuationSession.finalize` puts in meta["error_bound"]."""
    if method in INTERACTION_MODES:
        return interaction_error_bound(
            method, n=n, k=k, m=m, prefix=prefix, u_max=u_max
        )
    return point_error_bound(
        method, n=n, k=k, m=m, prefix=prefix,
        u_max=1.0 if u_max is None else u_max,
    )
