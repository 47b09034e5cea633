"""Random-projection LSH: deterministic top-m candidate preselection.

Counterpart of `repro.kernels.ann`. The approximate valuation engine
(`engine="approx"`) replaces the O(n) distance row of the streamed
pipeline with a candidate stage: each test point is compared against
only the m training points an LSH index proposes, so the per-test cost
falls from O(n d) to O(L log n + L W d) with L tables and window W -- the
Jia et al. (arXiv 1908.08619) recipe for KNN-Shapley on "data sets
containing millions of data points". Nothing here reaches a hand-written
kernel: the stage is a handful of PyTorch operations on the device, as
the reference's is XLA, apart from the recall probe's exact rows, which
take the distance kernel (`distance_cuda`) on a card.

Index layout (`LSHTables`, a NamedTuple of tensors):

  * `proj` (L, b, d): the random Gaussian planes. PyTorch cannot draw
    `jax.random.normal`'s bits, so `build_tables` takes the planes
    explicitly: `draw_planes` draws them from a CPU
    `torch.Generator().manual_seed(seed)` (one seed, one index, on the
    CPU and on the card alike), and `tables_from_jax` carries a JAX
    index's planes and tables across for parity;
  * sign-bit codes: code(x) = sum_j 1[proj_j . x >= 0] << j, one int32 per
    (table, point);
  * `sorted_codes` (L, n) int32 / `sort_idx` (L, n) int64: each table's
    train codes sorted stably with the permutation that sorted them, so a
    query is one `searchsorted` plus a contiguous window of W neighbours
    in code space.

A query pools the L windows (L*W ids, duplicates included), computes EXACT
squared distances on the pool only (`candidate_sq_dists`), masks duplicate
ids to an infinite-distance sentinel, and keeps the m nearest by a stable
ascending sort (ties by pool position, as `lax.top_k` orders them), so
the candidate list is sorted by true distance and the recurrences see the
dense pipeline's sorted-coordinate contract, truncated.

The index also carries the train-set moments (`train_norms`,
`train_mean`, `mean_sq_norm`) that give the wknn rbf bandwidth -- a
FULL-row mean of d2 -- analytically in O(d) per test point
(`full_mean_sq_dist`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.distance import candidate_sq_dists, distance_cuda

__all__ = [
    "LSHTables",
    "draw_planes",
    "build_tables",
    "tables_from_jax",
    "lsh_codes",
    "candidate_pool",
    "topm_candidates",
    "matched_prefix_and_recall",
    "full_mean_sq_dist",
    "INVALID_D2",
]

# Squared-distance sentinel for duplicate / out-of-pool candidate slots:
# far above any real squared distance yet finite in f32.
INVALID_D2 = 1e30
# Anything at or above this is an invalid candidate slot.
_VALID_CUTOFF = 1e29


class LSHTables(NamedTuple):
    """Immutable LSH index over one training set.

    Fields: `proj` (L, b, d) f32 planes; `sorted_codes` (L, n) int32
    per-table sign-bit codes in ascending order; `sort_idx` (L, n) int64
    train ids aligned with `sorted_codes`; `train_norms` (n,) f32 squared
    row norms; `train_mean` (d,) f32 and `mean_sq_norm` () f32 train
    moments (analytic rbf bandwidth)."""

    proj: torch.Tensor
    sorted_codes: torch.Tensor
    sort_idx: torch.Tensor
    train_norms: torch.Tensor
    train_mean: torch.Tensor
    mean_sq_norm: torch.Tensor


def draw_planes(seed: int, n_tables: int, n_bits: int, d: int
                ) -> torch.Tensor:
    """(n_tables, n_bits, d) f32 standard-normal planes from a CPU
    `torch.Generator` seeded with `seed`: the same planes on every device,
    so one seed builds one index on the CPU and on a card."""
    if not 1 <= n_bits <= 30:
        raise ValueError(f"n_bits must be in [1, 30], got {n_bits}")
    if n_tables < 1:
        raise ValueError(f"n_tables must be >= 1, got {n_tables}")
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn((int(n_tables), int(n_bits), int(d)), generator=gen,
                       dtype=torch.float32)


def lsh_codes(proj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(L, b, d) planes, (p, d) points -> (L, p) int32 sign-bit codes.

    code[l, i] packs the b sign bits of proj[l] . x[i]; b <= 30 keeps the
    code positive in int32 so `searchsorted` order is unsigned order."""
    bits = torch.einsum("lbd,pd->lpb", proj.to(torch.float32),
                        x.to(torch.float32)) >= 0.0
    weights = torch.tensor([1 << j for j in range(proj.shape[1])],
                           dtype=torch.int32, device=x.device)
    return torch.sum(bits.to(torch.int32) * weights, dim=-1,
                     dtype=torch.int32)


def build_tables(x_train: torch.Tensor, proj: torch.Tensor) -> LSHTables:
    """The LSH index of an (n, d) training set under the explicit planes
    `proj` (L, b, d), on x_train's device. The same (x_train, proj) always
    yields the same tables, so a restored session rebuilds the index its
    checkpoint was written under (the checkpoint keeps the planes)."""
    x = x_train.to(torch.float32)
    if proj.ndim != 3 or proj.shape[2] != x.shape[1]:
        raise ValueError(
            f"planes must be (n_tables, n_bits, {x.shape[1]}), got "
            f"{tuple(proj.shape)}")
    if not 1 <= proj.shape[1] <= 30 or proj.shape[0] < 1:
        raise ValueError(
            f"planes must have n_tables >= 1 and n_bits in [1, 30], got "
            f"{tuple(proj.shape)}")
    proj = proj.to(device=x.device, dtype=torch.float32)
    codes = lsh_codes(proj, x)                                   # (L, n)
    sorted_codes, sort_idx = torch.sort(codes, dim=-1, stable=True)
    norms = torch.sum(x * x, dim=-1)
    return LSHTables(proj=proj, sorted_codes=sorted_codes.contiguous(),
                     sort_idx=sort_idx.contiguous(), train_norms=norms,
                     train_mean=torch.mean(x, dim=0),
                     mean_sq_norm=torch.mean(norms))


def tables_from_jax(tables, device="cuda") -> LSHTables:
    """A `repro.kernels.ann.LSHTables` (any object with its six fields,
    arrays convertible by numpy) -> the port's `LSHTables` on `device`
    (the card unless "cpu" is asked for), bit for bit: the way a parity
    test runs the port on JAX's planes."""
    dev = resolve_device(device)

    def arr(name, dtype):
        a = np.asarray(getattr(tables, name))
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    return LSHTables(
        proj=arr("proj", np.float32),
        sorted_codes=arr("sorted_codes", np.int32),
        sort_idx=arr("sort_idx", np.int64),
        train_norms=arr("train_norms", np.float32),
        train_mean=arr("train_mean", np.float32),
        mean_sq_norm=arr("mean_sq_norm", np.float32),
    )


def candidate_pool(tables: LSHTables, xb: torch.Tensor, window: int
                   ) -> torch.Tensor:
    """(tb, d) test batch -> (tb, L*window) int64 candidate ids (with
    duplicates): per table, binary-search the query code into the sorted
    code list (left side) and take the `window` train ids around it."""
    n_tables, n = tables.sort_idx.shape
    w = max(1, min(int(window), n))
    qcodes = lsh_codes(tables.proj, xb).contiguous()            # (L, tb)
    pos = torch.searchsorted(tables.sorted_codes, qcodes)       # (L, tb)
    start = torch.clamp(pos - w // 2, 0, n - w)
    cols = start[:, :, None] + torch.arange(w, device=xb.device)
    tb = xb.shape[0]
    ids = torch.gather(tables.sort_idx[:, None, :].expand(n_tables, tb, n),
                       2, cols)                                  # (L, tb, w)
    return ids.permute(1, 0, 2).reshape(tb, -1)


def _dedup_mask(pool: torch.Tensor) -> torch.Tensor:
    """(tb, P) candidate ids -> (tb, P) f32 mask with exactly one 1.0 per
    distinct id per row (the first occurrence in id-sorted order)."""
    sorted_ids, order = torch.sort(pool, dim=-1, stable=True)
    first = torch.cat([torch.ones_like(sorted_ids[:, :1], dtype=torch.bool),
                       sorted_ids[:, 1:] != sorted_ids[:, :-1]], dim=-1)
    keep = torch.zeros_like(first).scatter_(1, order, first)
    return keep.to(torch.float32)


def topm_candidates(xb: torch.Tensor, x_train: torch.Tensor,
                    tables: LSHTables, m: int, window: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The candidate stage: (tb, d) test batch -> `(cand, d2m, valid)`,
    each (tb, m):

      * `cand` int64 train ids of the m nearest pooled candidates, sorted
        ascending by EXACT squared distance (ties by pool position);
      * `d2m` f32 their exact squared distances (`INVALID_D2` on invalid
        slots);
      * `valid` f32 1.0 where the slot holds a real distinct candidate
        (the pool can carry fewer than m distinct ids).

    `lax.top_k(-d2, m)` of the reference puts the lower pool position
    first among equal distances, every invalid slot among them;
    `torch.topk` promises no order on ties, so this keeps the first m of
    a stable ascending sort."""
    pool = candidate_pool(tables, xb, window)                   # (tb, P)
    if pool.shape[-1] < m:
        raise ValueError(
            f"candidate pool {pool.shape[-1]} (= n_tables * window) is "
            f"smaller than top_m={m}; raise window or n_tables"
        )
    d2 = candidate_sq_dists(xb, x_train, pool,
                            train_norms=tables.train_norms)
    d2 = torch.where(_dedup_mask(pool) > 0, d2, INVALID_D2)
    d2s, idx = torch.sort(d2, dim=-1, stable=True)
    d2m, idx = d2s[:, :m], idx[:, :m]
    cand = torch.gather(pool, 1, idx)
    valid = (d2m < _VALID_CUTOFF).to(torch.float32)
    return cand, d2m, valid


def matched_prefix_and_recall(cand: torch.Tensor, xb: torch.Tensor,
                              x_train: torch.Tensor, kk: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Recall probe: the candidates against the EXACT top-kk neighbours.

    `cand` (s, m) candidate ids (ascending by true distance), `xb` (s, d)
    the probed test points: an exact (s, n) distance row is computed for
    them (`distance_cuda`: the kernel on a card, the plain expansion on
    the CPU), so keep s small. Returns `(prefix, recall)`, each (s,):
    `prefix` int32 length of the leading run where candidate ids equal
    the exact nearest-neighbour ids (capped at kk; what the certified
    bounds of `repro_torch.core.approx` consume), `recall` f32 fraction
    of the exact top-kk present anywhere in the candidate set."""
    d2 = distance_cuda(xb.to(torch.float32).contiguous(),
                       x_train.to(torch.float32).contiguous())
    true_ids = torch.sort(d2, dim=-1, stable=True).indices[:, :kk]
    head = cand[:, :kk]
    prefix = torch.sum(torch.cumprod((head == true_ids).to(torch.int32),
                                     dim=-1), dim=-1)
    hit = torch.any(true_ids[:, :, None] == cand[:, None, :], dim=-1)
    return prefix.to(torch.int32), torch.mean(hit.to(torch.float32), dim=-1)


def full_mean_sq_dist(xb: torch.Tensor, tables: LSHTables) -> torch.Tensor:
    """(tb, d) test batch -> (tb, 1) EXACT mean over all n train points of
    the squared distance, in O(d) per test point:

        mean_j ||x - x_j||^2 = ||x||^2 - 2 x . mean(x_train) + mean||x_j||^2

    the wknn rbf bandwidth of the dense pipeline without any of the n
    distances."""
    x = xb.to(torch.float32)
    mean_d2 = (torch.sum(x * x, dim=-1, keepdim=True)
               - 2.0 * (x @ tables.train_mean[:, None])
               + tables.mean_sq_norm)
    return torch.clamp_min(mean_d2, 0.0)
