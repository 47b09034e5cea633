"""Brute-force O(2^n) oracles for Shapley / STI / SII on the KNN valuation.

These implement the *definitions* (paper Eqs. 1-3 and the classical Shapley /
SII formulas) by enumerating every subset S of the training set. They exist
solely as correctness oracles for tests (n <= ~14) and for the benchmark that
reproduces the paper's O(2^n) -> O(t n^2) speedup claim.

All functions take a precomputed sorted order per test point so that distance
tie-breaking is bit-identical to the fast path.

This is a verbatim copy of `repro.core.sti_baseline` (pure numpy): the port
keeps its own so that it imports nothing of the JAX package, and
`tests/test_torch_sti_core.py` holds the copy against the original.
"""

from __future__ import annotations

from math import comb
from typing import Optional

import numpy as np

__all__ = [
    "knn_utility_table",
    "weighted_knn_utility_table",
    "brute_force_sti",
    "brute_force_sii",
    "brute_force_shapley",
    "brute_force_wknn_shapley",
    "sorted_orders",
]


def sorted_orders(x_train: np.ndarray, x_test: np.ndarray) -> np.ndarray:
    """(t, n) index order of train points, closest first, stable ties."""
    d2 = (
        np.sum(x_test**2, -1)[:, None]
        - 2.0 * x_test @ x_train.T
        + np.sum(x_train**2, -1)[None, :]
    )
    return np.argsort(d2, axis=-1, kind="stable")


def knn_utility_table(
    order: np.ndarray, match: np.ndarray, k: int
) -> np.ndarray:
    """u_ytest(S) for every subset S (bitmask) of one test point.

    Args:
      order: (n,) train indices sorted closest-first for this test point.
      match: (n,) bool, label(train_i) == label(test) indexed by ORIGINAL id.
      k: KNN parameter.

    Returns:
      (2**n,) float table, entry m = u(S) for bitmask m over original ids.
    """
    n = order.shape[0]
    table = np.zeros(2**n, dtype=np.float64)
    for m in range(1, 2**n):
        cnt = 0
        hits = 0
        for j in order:  # closest first
            if m >> int(j) & 1:
                if match[j]:
                    hits += 1
                cnt += 1
                if cnt == k:
                    break
        table[m] = hits / k
    return table


def weighted_knn_utility_table(
    order: np.ndarray, contrib: np.ndarray, k: int
) -> np.ndarray:
    """v(S) = (1/k) sum of `contrib` over the k nearest members of S, for
    every subset S (bitmask over ORIGINAL ids) of one test point.

    Generalizes `knn_utility_table` from 0/1 label matches to arbitrary
    per-point contributions (the soft-label weighted KNN utility of
    repro.core.wknn with contrib[j] = w_j * 1[y_j == y_test])."""
    n = order.shape[0]
    table = np.zeros(2**n, dtype=np.float64)
    for m in range(1, 2**n):
        cnt = 0
        tot = 0.0
        for j in order:  # closest first
            if m >> int(j) & 1:
                tot += contrib[j]
                cnt += 1
                if cnt == k:
                    break
        table[m] = tot / k
    return table


def _shapley_from_table(table: np.ndarray, n: int) -> np.ndarray:
    """Classical Shapley values from a full 2^n utility table."""
    out = np.zeros(n, dtype=np.float64)
    w = np.array([1.0 / (n * comb(n - 1, s)) for s in range(n)])
    for i in range(n):
        bit = 1 << i
        rest = [b for b in range(n) if b != i]
        for sub in range(2 ** (n - 1)):
            m = 0
            s = 0
            for pos, b in enumerate(rest):
                if sub >> pos & 1:
                    m |= 1 << b
                    s += 1
            out[i] += w[s] * (table[m | bit] - table[m])
    return out


def brute_force_wknn_shapley(
    x_train, y_train, x_test, y_test, k, *, weights: str = "rbf"
) -> np.ndarray:
    """O(t n 2^n) oracle for the soft-label *weighted* KNN utility
    (repro.core.wknn). Weights are recomputed here in numpy with the same
    formulas so the oracle shares no code with the fast path."""
    n = x_train.shape[0]
    t = x_test.shape[0]
    orders = sorted_orders(x_train, x_test)
    d2 = (
        np.sum(x_test**2, -1)[:, None]
        - 2.0 * x_test @ x_train.T
        + np.sum(x_train**2, -1)[None, :]
    )
    d2 = np.maximum(d2.astype(np.float64), 0.0)
    if weights == "rbf":
        sigma2 = np.maximum(d2.mean(-1, keepdims=True), 1e-12)
        w = np.exp(-d2 / (2.0 * sigma2))
    elif weights == "inverse":
        w = 1.0 / (1.0 + np.sqrt(d2))
    elif weights == "uniform":
        w = np.ones_like(d2)
    else:
        raise ValueError(f"unknown weight kind {weights!r}")
    out = np.zeros(n, dtype=np.float64)
    for p in range(t):
        contrib = w[p] * (np.asarray(y_train) == y_test[p])
        table = weighted_knn_utility_table(orders[p], contrib, k)
        out += _shapley_from_table(table, n)
    return out / t


def _pair_interaction(
    table: np.ndarray, n: int, i: int, j: int, weights: np.ndarray
) -> float:
    """sum_S w[|S|] * (u(S+ij) - u(S+i) - u(S+j) + u(S)), S excluding i, j."""
    bit_i, bit_j = 1 << i, 1 << j
    rest = [b for b in range(n) if b != i and b != j]
    total = 0.0
    for sub in range(2 ** (n - 2)):
        m = 0
        s = 0
        for pos, b in enumerate(rest):
            if sub >> pos & 1:
                m |= 1 << b
                s += 1
        delta = (
            table[m | bit_i | bit_j]
            - table[m | bit_i]
            - table[m | bit_j]
            + table[m]
        )
        total += weights[s] * delta
    return total


def _interaction_matrix(
    x_train, y_train, x_test, y_test, k, weight_fn
) -> np.ndarray:
    n = x_train.shape[0]
    t = x_test.shape[0]
    orders = sorted_orders(x_train, x_test)
    phi = np.zeros((n, n), dtype=np.float64)
    weights_cache: dict[int, np.ndarray] = {}
    if n not in weights_cache:
        weights_cache[n] = np.array([weight_fn(n, s) for s in range(n - 1)])
    w = weights_cache[n]
    for p in range(t):
        match = np.asarray(y_train == y_test[p])
        table = knn_utility_table(orders[p], match, k)
        for i in range(n):
            for j in range(i + 1, n):
                phi[i, j] += _pair_interaction(table, n, i, j, w)
        # main terms: phi_ii = v({i}) - v(empty) = u({i})
        for i in range(n):
            phi[i, i] += table[1 << i]
    phi /= t
    return phi + np.triu(phi, 1).T


def brute_force_sti(x_train, y_train, x_test, y_test, k) -> np.ndarray:
    """Paper Eq. (3): STI pair interactions, O(t n^2 2^n)."""

    def w(n, s):
        return (2.0 / n) / comb(n - 1, s)

    return _interaction_matrix(x_train, y_train, x_test, y_test, k, w)


def brute_force_sii(x_train, y_train, x_test, y_test, k) -> np.ndarray:
    """Grabisch-Roubens SII: w_s = s!(n-s-2)!/(n-1)! = 1/((n-1) comb(n-2, s))."""

    def w(n, s):
        return 1.0 / ((n - 1) * comb(n - 2, s))

    return _interaction_matrix(x_train, y_train, x_test, y_test, k, w)


def brute_force_shapley(x_train, y_train, x_test, y_test, k) -> np.ndarray:
    """Classical single-point Shapley values of the KNN utility, O(t n 2^n)."""
    n = x_train.shape[0]
    t = x_test.shape[0]
    orders = sorted_orders(x_train, x_test)
    out = np.zeros(n, dtype=np.float64)
    for p in range(t):
        match = np.asarray(y_train == y_test[p])
        table = knn_utility_table(orders[p], match, k)
        out += _shapley_from_table(table, n)
    return out / t
