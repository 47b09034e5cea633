"""Interaction-matrix analytics (paper Sec. 3.2 / Sec. 4), in PyTorch.

Counterpart of `repro.core.analysis`:
  * efficiency check:  sum(Phi) == test accuracy (STI efficiency axiom),
    and that accuracy, v(N), on the device (`knn_test_accuracy`)
  * in-class vs out-of-class interaction summaries (Fig. 3)
  * mislabel detection (Fig. 5)
  * training-set summarization orderings from values
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = [
    "efficiency_gap",
    "knn_test_accuracy",
    "class_block_summary",
    "mislabel_scores",
    "summarize_keep_order",
    "k_invariance_correlation",
]

# rows of phi summed per pass by `efficiency_gap`: bounds its temporary to
# _GAP_ROWS x n instead of a second (n, n) matrix
_GAP_ROWS = 4096


def efficiency_gap(phi: torch.Tensor, test_accuracy) -> torch.Tensor:
    """|Sigma phi - a_test| (STI efficiency axiom), a float64 scalar.

    Sums the diagonal plus each UNORDERED pair once (the upper triangle),
    as `repro.core.analysis.efficiency_gap` does. The sum is taken in
    float64, a block of rows at a time, so a full-width (65536, 65536)
    matrix needs no second (n, n) copy."""
    n = phi.shape[0]
    once = torch.zeros((), dtype=torch.float64, device=phi.device)
    for r0 in range(0, n, _GAP_ROWS):
        block = torch.triu(phi[r0:r0 + _GAP_ROWS], diagonal=r0)
        once += torch.sum(block, dtype=torch.float64)
    return torch.abs(once - test_accuracy)


def knn_test_accuracy(x_train, y_train, x_test, y_test, k: int, *,
                      device="cuda") -> float:
    """v(N), the KNN utility of the whole train set that `efficiency_gap`
    is held against: the mean over the test points of the share of their
    k nearest train points (stable order, the lower index first on a tie)
    that carry the test label. Computed on `device` through
    `kernels.ops.pairwise_distance`, `_GAP_ROWS // 8` test rows at a
    time."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels.ops import pairwise_distance

    dev = resolve_device(device)
    x, y = x_train.to(dev), y_train.to(dev)
    kk, rows = min(k, int(x.shape[0])), _GAP_ROWS // 8
    hits = 0
    for s in range(0, int(x_test.shape[0]), rows):
        d2 = pairwise_distance(x_test[s:s + rows].to(dev), x)
        near = torch.sort(d2, dim=1, stable=True).indices[:, :kk]
        hits += int((y[near] == y_test[s:s + rows].to(dev)[:, None]).sum())
    return hits / k / int(x_test.shape[0])


class ClassBlockSummary(NamedTuple):
    in_class_mean: torch.Tensor       # (c,) mean off-diag interaction
    out_class_mean: torch.Tensor      # scalar mean across-class interaction
    diag_mean_per_class: torch.Tensor  # (c,) mean main term per class


def _onehot(labels: torch.Tensor, num_classes: int, like: torch.Tensor):
    return F.one_hot(labels.long().to(like.device), num_classes).to(like.dtype)


def class_block_summary(phi: torch.Tensor, labels: torch.Tensor,
                        num_classes: int) -> ClassBlockSummary:
    """Mean interaction inside vs across class blocks (paper Fig. 3)."""
    onehot = _onehot(labels, num_classes, phi)
    off = phi - torch.diag(torch.diag(phi))
    block = onehot.T @ off @ onehot
    counts = onehot.sum(0)
    pair_in = counts * (counts - 1)
    in_mean = torch.diag(block) / torch.clamp_min(pair_in, 1)
    total_off_pairs = phi.shape[0] * (phi.shape[0] - 1)
    out_pairs = total_off_pairs - pair_in.sum()
    out_mean = (block.sum() - torch.diag(block).sum()) / torch.clamp_min(
        out_pairs, 1)
    diag_mean = (onehot.T @ torch.diag(phi)) / torch.clamp_min(counts, 1)
    return ClassBlockSummary(in_mean, out_mean, diag_mean)


def mislabel_scores(phi: torch.Tensor, labels: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """Per-train-point mislabel suspicion (paper Fig. 5): mean interaction
    with own-class points minus mean with other-class points, minus the
    main term. Higher = more suspect. Taken `_GAP_ROWS` rows at a time,
    each row as the whole-matrix expression forms it, so a full-width
    (65536, 65536) matrix needs no (n, n) temporary."""
    n = phi.shape[0]
    onehot = _onehot(labels, num_classes, phi)
    out = torch.empty((n,), dtype=phi.dtype, device=phi.device)
    for r0 in range(0, n, _GAP_ROWS):
        rows = phi[r0:r0 + _GAP_ROWS]
        # diagonal(r0) of a row block is the global diagonal of its rows
        off = rows.clone()
        off.diagonal(r0).zero_()
        same_all = onehot[r0:r0 + rows.shape[0]] @ onehot.T
        same = same_all.clone()
        same.diagonal(r0).zero_()
        other = 1.0 - same_all
        other.diagonal(r0).zero_()
        own_mean = (off * same).sum(-1) / torch.clamp_min(same.sum(-1), 1)
        oth_mean = (off * other).sum(-1) / torch.clamp_min(other.sum(-1), 1)
        out[r0:r0 + rows.shape[0]] = (own_mean - oth_mean) - rows.diagonal(r0)
    return out


def summarize_keep_order(values: torch.Tensor) -> torch.Tensor:
    """Indices ordered most-valuable first (stable)."""
    return torch.sort(-values, stable=True).indices



def k_invariance_correlation(phi_a: torch.Tensor, phi_b: torch.Tensor
                             ) -> torch.Tensor:
    """Pearson correlation between two flattened interaction matrices
    (paper Sec. 3.2: > 0.99 across k in [3, 20]); an f32 scalar, summed
    as the JAX package sums it."""
    a = phi_a.reshape(-1).to(torch.float32)
    b = phi_b.reshape(-1).to(torch.float32)
    a = a - torch.mean(a)
    b = b - torch.mean(b)
    return torch.sum(a * b) / torch.sqrt(torch.sum(a * a) * torch.sum(b * b))
