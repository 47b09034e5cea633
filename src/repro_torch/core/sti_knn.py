"""STI-KNN: exact pair-interaction Shapley-Taylor values for KNN in O(t n^2).

PyTorch counterpart of `repro.core.sti_knn` (Algorithm 1 of "Optimizing Data
Shapley Interaction Calculation from O(2^n) to O(t n^2) for KNN models",
Belaid et al., 2023):

  * the paper's sequential recurrence (Alg. 1, lines 3-10) is computed as a
    closed-form reverse cumulative sum;
  * the per-test-point matrix is never materialized: for train points a, b
    with ranks r_p[a], r_p[b] under test point p (rank 0 = closest),
        phi_ab(u_p) = g_p[max(r_p[a], r_p[b])]          (a != b)
    so the final matrix is a streamed mean of outer-max gathers.

Notation (0-based, mirrors the paper's 1-based j = j0 + 1):
  u[j0]    = 1[label(alpha_{j0}) == y_test] / k   (sorted by distance)
  g[n-1]   = -2(n-k)/(n(n-1)) * u[n-1]                         (Eq. 6)
  g[j0-1]  = g[j0] + 1[j0 > k] * 2(j0-k)/((j0-1) j0) * (u[j0]-u[j0-1])
                                                               (Eq. 7)
  phi_{alpha_i, alpha_j} = g[j] for all i < j                  (Eq. 8)
  diagonal phi_ii = mean_p u_p(i)                              (Eq. 4)
If n <= k the valuation function is fully linear and every interaction is 0.

Layouts follow the JAX package: `g`, `ranks` and `order` are (t, n), the
accumulator is (n, n) f32 and the diagonal (n,) f32. Where the JAX code
returns a new accumulator (scan carry, donation), the port updates the
caller's tensor in place and returns it.
"""

from __future__ import annotations

import inspect
import warnings
from typing import Callable, Optional

import torch

from repro_torch.device import resolve_device, to_device

__all__ = [
    "superdiagonal_g",
    "superdiagonal_g_topm",
    "ranks_from_order",
    "ranks_from_distances",
    "pairwise_sq_dists",
    "sti_knn_interactions",
    "sti_knn_matrix_one_test",
    "register_fill_fn",
    "register_acc_fill_fn",
    "accumulate_fill",
    "resolve_fill",
    "register_rect_fill_fn",
    "register_rect_acc_fill_fn",
    "accumulate_rect_fill",
    "resolve_rect_fill",
    "InteractionMode",
]

InteractionMode = str  # "sti" | "sii"


def _recurrence_coeffs(
    n: int, k: int, mode: InteractionMode, dtype=torch.float32,
    device=None, n_total: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (last_coef, step_coef[j0]) for the g recurrence.

    g[n-1] = last_coef * u[n-1]
    g[j0-1] = g[j0] + step_coef[j0] * (u[j0] - u[j0-1])
    step_coef[j0] is zero unless j0 > k (paper condition j > k+1) and j0 >= 2.

    `step` is built on a `dtype` arange with the same guards as the JAX
    code and `last` is a Python double cast at the end, so both packages
    round every coefficient identically.
    """
    if n_total is None:
        n_total = n
    j0 = torch.arange(n, dtype=dtype, device=device)
    active = (j0 > k) & (j0 >= 2)
    if mode == "sti":
        last = -2.0 * (n_total - k) / (n_total * (n_total - 1.0))
        step = torch.where(
            active, 2.0 * (j0 - k) / torch.where(active, (j0 - 1.0) * j0, 1.0),
            0.0,
        )
    elif mode == "sii":
        last = -1.0 / (n_total - 1.0)
        step = torch.where(active, 1.0 / torch.where(active, j0 - 1.0, 1.0),
                           0.0)
    else:
        raise ValueError(f"unknown interaction mode: {mode!r}")
    if n_total <= k:  # valuation fully linear -> all pair interactions vanish
        last = 0.0
        step = torch.zeros_like(step)
    return torch.tensor(last, dtype=dtype, device=device), step


def superdiagonal_g(u_sorted: torch.Tensor, k: int, *,
                    mode: InteractionMode = "sti") -> torch.Tensor:
    """(..., n) sorted valuations u -> (..., n) g with g[j0] =
    phi_{alpha_{j0-1}, alpha_{j0}}; g[0] is unused (set to 0). For train
    indices a != b: phi_ab = g[max(rank_a, rank_b)]."""
    return _g_recurrence(u_sorted, k, u_sorted.shape[-1], mode)


def superdiagonal_g_topm(u_topm: torch.Tensor, k: int, n_total: int, *,
                         mode: InteractionMode = "sti") -> torch.Tensor:
    """Truncated-g estimator of `engine="approx"`: (..., m) valuations of
    the m CLOSEST of `n_total` train points (sorted, position 0 closest)
    -> (..., m) estimate of g. The exact recurrence runs over the m known
    entries; the step coefficients depend on the position only, so every
    term over the matched prefix is exact, while the anchor
    `last_coef(n_total) * u_topm[m-1]` stands in for the unobservable
    tail (what `repro_torch.core.approx.interaction_error_bound`
    certifies). With m == n_total this is `superdiagonal_g`."""
    return _g_recurrence(u_topm, k, n_total, mode)


def _g_recurrence(u: torch.Tensor, k: int, n_total: int,
                  mode: InteractionMode) -> torch.Tensor:
    """The g recurrence over the last axis of `u`, anchored with the
    `n_total`-point coefficient (the two functions above)."""
    n = u.shape[-1]
    if n < 2 or n_total < 2:
        return torch.zeros_like(u)
    last_coef, step_coef = _recurrence_coeffs(
        n, k, mode, u.dtype, u.device, n_total=n_total
    )
    du = u - torch.roll(u, 1, dims=-1)  # j0=0 junk, zeroed
    term = step_coef * du
    # R[j0] = sum_{m >= j0} term[m]; suffix[j0] = R[j0+1]
    rev_cumsum = torch.flip(torch.cumsum(torch.flip(term, [-1]), -1), [-1])
    suffix = torch.cat(
        [rev_cumsum[..., 1:], torch.zeros_like(rev_cumsum[..., :1])], dim=-1
    )
    g = last_coef * u[..., -1:] + suffix
    g[..., 0] = 0.0
    return g


def pairwise_sq_dists(x_test: torch.Tensor, x_train: torch.Tensor
                      ) -> torch.Tensor:
    """(t, d), (n, d) -> (t, n) squared L2 distances via the expansion
    ||a-b||^2 = ||a||^2 - 2 a.b + ||b||^2 (f32 accumulation; a float32
    `torch.matmul` uses no TF32 unless the caller turned it on)."""
    xt = x_test.to(torch.float32)
    xn = x_train.to(torch.float32)
    d2 = (
        torch.sum(xt * xt, -1, keepdim=True)
        - 2.0 * (xt @ xn.T)
        + torch.sum(xn * xn, -1)[None, :]
    )
    return torch.clamp_min(d2, 0.0)


def ranks_from_order(order: torch.Tensor) -> torch.Tensor:
    """(t, n) argsort permutation -> (t, n) int64 ranks (0 = closest), the
    inverse permutation of each row, by scatter."""
    order = order.long()
    t, n = order.shape
    src = torch.arange(n, device=order.device).expand(t, n)
    return torch.zeros_like(order).scatter_(1, order, src)


def ranks_from_distances(d2: torch.Tensor) -> torch.Tensor:
    """(t, n) distances -> (t, n) int64 ranks (0 = closest), stable ties."""
    return ranks_from_order(torch.sort(d2, dim=-1, stable=True).indices)


def _fill_xla(g: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Sum over test points of g_p[max(r_p[a], r_p[b])] -> (n, n).

    The correctness oracle (the JAX package's "xla" entry): materializes
    the full (t, n, n) gather, so peak memory is O(t n^2)."""
    t, n = g.shape
    r = ranks.long()
    m = torch.maximum(r[:, :, None], r[:, None, :]).reshape(t, n * n)
    return torch.gather(g.to(torch.float32), 1, m).reshape(t, n, n).sum(0)


def _scan_fill(one_fn: Callable, g, ranks, chunk: int, acc=None):
    """Stream `chunk` test points at a time into an (n, n) f32 accumulator.
    `acc` is updated in place (the JAX scan carry seeded with the caller's
    accumulator); None starts from zeros. JAX pads the last chunk with
    g == 0 rows; their contribution is exactly 0, so the port skips them."""
    t, n = g.shape
    chunk = max(1, min(int(chunk), t))
    g = g.to(torch.float32)
    r = ranks.long()
    if acc is None:
        acc = torch.zeros((n, n), dtype=torch.float32, device=g.device)
    for s in range(0, t, chunk):
        acc.add_(one_fn(g[s:s + chunk], r[s:s + chunk]).sum(0))
    return acc


def _chunked_one(gc: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """(c, n) g and int64 ranks -> (c, n, n) per-test-point matrices.

    The JAX form selects in sorted coordinates, M[i, j] = g[max(i, j)] =
    where(j >= i, g[j], g[i]), and permutes rows and columns by the ranks.
    The same select in train coordinates needs only g gathered at each
    point's rank: g[max(r_a, r_b)] = (r_a >= r_b) ? g[r_a] : g[r_b]."""
    gr = torch.gather(gc, 1, rc)
    return torch.where(rc[:, :, None] >= rc[:, None, :],
                       gr[:, :, None], gr[:, None, :])


def _onehot_one(gc: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """One-hot matmul form: with C[a, j] = 1[r_a <= j] and
    dg[j] = g[j] - g[j+1] (g[n] := 0), sum_j dg[j] C[a, j] C[b, j] =
    g[max(r_a, r_b)], so each test point is (C * dg) @ C^T."""
    c, n = gc.shape
    dg = gc - torch.cat([gc[:, 1:], torch.zeros_like(gc[:, :1])], dim=1)
    thresh = torch.arange(n, device=gc.device)
    cm = (rc[:, :, None] <= thresh[None, None, :]).to(torch.float32)
    return torch.bmm(cm * dg[:, None, :], cm.transpose(1, 2))


def _fill_chunked(g, ranks, *, chunk: int = 1):
    """Chunked fill: constant memory in t (peak O(chunk * n^2))."""
    return _scan_fill(_chunked_one, g, ranks, chunk)


def _fill_onehot(g, ranks, *, chunk: int = 1):
    """One-hot matmul fill: O(t n^3) operations, no gather."""
    return _scan_fill(_onehot_one, g, ranks, chunk)


def _acc_fill_chunked(acc, g, ranks, *, chunk: int = 1):
    """In-place form of the chunked fill: adds into `acc`, no second (n, n)
    accumulator."""
    return _scan_fill(_chunked_one, g, ranks, chunk, acc=acc)


def _acc_fill_onehot(acc, g, ranks, *, chunk: int = 1):
    """In-place form of the one-hot fill."""
    return _scan_fill(_onehot_one, g, ranks, chunk, acc=acc)


# Fill registry: every entry computes sum_p g[p, max(ranks[p,a], ranks[p,b])].
# "xla" is the O(t n^2)-memory oracle (named as in the JAX package);
# "chunked" and "onehot" stream in O(chunk n^2). The CUDA kernel registers
# itself as "cuda" when repro_torch.kernels is imported.
_FILL_FNS: dict[str, Callable] = {
    "xla": _fill_xla,
    "chunked": _fill_chunked,
    "onehot": _fill_onehot,
}

# Accumulate-fill registry: `fn(acc, g, ranks, **static) -> acc` adds
# fill(g, ranks) into `acc` IN PLACE and returns it. A name missing here
# falls back to `acc.add_(fill(...))` in `accumulate_fill`.
_ACC_FILL_FNS: dict[str, Callable] = {
    "chunked": _acc_fill_chunked,
    "onehot": _acc_fill_onehot,
}


def register_fill_fn(name: str, fn: Callable) -> None:
    """Register a fill implementation:
    `fn(g, ranks, **static_params) -> (n, n) f32`."""
    _FILL_FNS[name] = fn


def register_acc_fill_fn(name: str, fn: Callable) -> None:
    """Register the in-place accumulate form of fill `name`:
    `fn(acc, g, ranks, **static_params)` adds `_FILL_FNS[name](g, ranks)`
    into `acc` in place and returns `acc`."""
    _ACC_FILL_FNS[name] = fn


def accumulate_fill(acc, g, ranks, fill: str, fill_static: tuple = ()):
    """acc += fill(g, ranks) in place, via the registered accumulate form
    when one exists and `acc.add_` of the plain form otherwise.
    `fill_static` is the params tuple `resolve_fill` returns."""
    fn = _ACC_FILL_FNS.get(fill)
    if fn is not None:
        return fn(acc, g, ranks, **dict(fill_static))
    return acc.add_(_FILL_FNS[fill](g, ranks, **dict(fill_static)))


def _accepted_params(fn: Callable, params: dict) -> dict:
    """Subset of `params` that `fn(g, ranks, **...)` can accept (a fn with
    **kwargs accepts everything)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return dict(params)
    if any(p.kind is inspect.Parameter.VAR_KEYWORD
           for p in sig.parameters.values()):
        return dict(params)
    return {k: v for k, v in params.items() if k in sig.parameters}


def resolve_fill(
    fill: str,
    n: int,
    t: int,
    *,
    fill_params: Optional[dict] = None,
    backend: str = "cuda",
    autotune: bool = False,
) -> tuple[str, tuple]:
    """Resolve a fill request to (registry_name, hashable static params).

    "auto" takes `repro_torch.kernels.autotune.best_fill` for `backend`:
    the CUDA kernel on a card (its one candidate there); on the CPU the
    tuning cache's winner on a hit, a fresh tune with `autotune=True`,
    else chunked. Explicit `fill_params` are a hint: ones the winner
    does not accept are dropped under "auto" and rejected for an explicit
    fill name."""
    params = dict(fill_params or {})
    if fill == "auto":
        from repro_torch.kernels.autotune import best_fill  # lazy: no cycle

        name, tuned = best_fill(n, t, backend=backend, allow_tune=autotune)
        tuned.update(params)
        params = _accepted_params(_FILL_FNS[name], tuned)
        fill = name
    if fill not in _FILL_FNS:
        raise ValueError(
            f"unknown fill {fill!r}; registered: {sorted(_FILL_FNS)}"
        )
    bad = set(params) - set(_accepted_params(_FILL_FNS[fill], params))
    if bad:
        raise ValueError(f"fill {fill!r} does not accept params {sorted(bad)}")
    return fill, tuple(sorted(params.items()))


# ------------------------------------------------------- rectangular fills
# A RECT fill computes out[a, b] = sum_p g[p, max(r_rows[p, a], r_cols[p, b])]
# for INDEPENDENT row/column index bases over the same global rank space:
# the sharded engine's (n/D, n) row-block update is
# `r_rows = rect_row_view(ranks, i * n/D, n/D)`, `r_cols = ranks`. The
# square fills above are the r_rows == r_cols special case.
def _rect_one(gc: torch.Tensor, rrc: torch.Tensor, rcc: torch.Tensor
              ) -> torch.Tensor:
    """(c, n) g and (c, n_rows) / (c, n_cols) int64 ranks -> the
    (c, n_rows, n_cols) per-test-point blocks g[p, max(r_rows, r_cols)],
    by the compare-select identity on g gathered at each side's ranks."""
    gr, gcol = torch.gather(gc, 1, rrc), torch.gather(gc, 1, rcc)
    return torch.where(rrc[:, :, None] >= rcc[:, None, :],
                       gr[:, :, None], gcol[:, None, :])


def _rect_fill_xla(g, r_rows, r_cols) -> torch.Tensor:
    """Rectangular reference fill (the JAX package's "xla" entry):
    materializes the (t, n_rows, n_cols) gather. The correctness oracle of
    the streaming and CUDA rect variants."""
    t = g.shape[0]
    rr, rc = r_rows.long(), r_cols.long()
    m = torch.maximum(rr[:, :, None], rc[:, None, :]).reshape(t, -1)
    out = torch.gather(g.to(torch.float32), 1, m).sum(0)
    return out.reshape(rr.shape[1], rc.shape[1])


def _scan_rect_fill(g, r_rows, r_cols, chunk: int, acc=None):
    """Rect twin of `_scan_fill`: `chunk` test points at a time into an
    (n_rows, n_cols) accumulator, `acc` in place (None starts from
    zeros)."""
    t = g.shape[0]
    chunk = max(1, min(int(chunk), t))
    g = g.to(torch.float32)
    rr, rc = r_rows.long(), r_cols.long()
    if acc is None:
        acc = torch.zeros((rr.shape[1], rc.shape[1]), dtype=torch.float32,
                          device=g.device)
    for s in range(0, t, chunk):
        acc.add_(_rect_one(g[s:s + chunk], rr[s:s + chunk],
                           rc[s:s + chunk]).sum(0))
    return acc


def _rect_fill_chunked(g, r_rows, r_cols, *, chunk: int = 1):
    """Chunked rect fill: constant memory in t, peak
    O(chunk * n_rows * n_cols). The sharded engine's CPU default."""
    return _scan_rect_fill(g, r_rows, r_cols, chunk)


def _rect_acc_fill_chunked(acc, g, r_rows, r_cols, *, chunk: int = 1):
    """In-place form of the chunked rect fill: adds into the caller's
    (n_rows, n_cols) block."""
    return _scan_rect_fill(g, r_rows, r_cols, chunk, acc=acc)


# Rectangular fill registries, mirroring _FILL_FNS/_ACC_FILL_FNS:
# `fn(g, r_rows, r_cols, **static) -> (n_rows, n_cols)` and the in-place
# accumulate form `fn(acc, g, r_rows, r_cols, **static) -> acc`. The CUDA
# rect kernel registers as "cuda" when repro_torch.kernels is imported.
_RECT_FILL_FNS: dict[str, Callable] = {
    "xla": _rect_fill_xla,
    "chunked": _rect_fill_chunked,
}

_RECT_ACC_FILL_FNS: dict[str, Callable] = {
    "chunked": _rect_acc_fill_chunked,
}


def register_rect_fill_fn(name: str, fn: Callable) -> None:
    """Register a rectangular fill:
    `fn(g, r_rows, r_cols, **static_params) -> (n_rows, n_cols) f32`."""
    _RECT_FILL_FNS[name] = fn


def register_rect_acc_fill_fn(name: str, fn: Callable) -> None:
    """Register the in-place accumulate form of rect fill `name`:
    `fn(acc, g, r_rows, r_cols, **static_params)` adds
    `_RECT_FILL_FNS[name](g, r_rows, r_cols)` into `acc` in place and
    returns `acc`."""
    _RECT_ACC_FILL_FNS[name] = fn


def accumulate_rect_fill(acc, g, r_rows, r_cols, fill: str,
                         fill_static: tuple = ()):
    """acc += rect_fill(g, r_rows, r_cols) in place, via the registered
    accumulate form when one exists and `acc.add_` of the plain form
    otherwise. This is the sharded step's row-block update: acc is one
    shard's (n/D, n) block."""
    fn = _RECT_ACC_FILL_FNS.get(fill)
    if fn is not None:
        return fn(acc, g, r_rows, r_cols, **dict(fill_static))
    return acc.add_(_RECT_FILL_FNS[fill](g, r_rows, r_cols,
                                         **dict(fill_static)))


def resolve_rect_fill(
    fill: str,
    n_rows: int,
    n_cols: int,
    t: int,
    *,
    fill_params: Optional[dict] = None,
    backend: str = "cuda",
    autotune: bool = False,
) -> tuple[str, tuple]:
    """Resolve a rect fill request to (registry_name, hashable static
    params). "auto" takes `repro_torch.kernels.autotune.best_rect_fill`
    for the (n_rows, n_cols) block on `backend` (on a card the CUDA rect
    kernel, its one candidate there; on the CPU a cache hit, a fresh tune
    with `autotune=True`, else chunked). A SQUARE registry name with no rect twin (e.g. "onehot", restored from a
    single-device checkpoint) runs the chunked rect scan with a warning:
    the sharded engine keeps running. Explicit `fill_params` the winner
    does not accept are dropped under "auto" and rejected otherwise."""
    params = dict(fill_params or {})
    if fill == "auto":
        from repro_torch.kernels.autotune import best_rect_fill  # no cycle

        name, tuned = best_rect_fill(n_rows, n_cols, t, backend=backend,
                                     allow_tune=autotune)
        tuned.update(params)
        params = _accepted_params(_RECT_FILL_FNS[name], tuned)
        fill = name
    if fill not in _RECT_FILL_FNS:
        if fill not in _FILL_FNS:
            raise ValueError(
                f"unknown rect fill {fill!r}; registered: "
                f"{sorted(_RECT_FILL_FNS)}"
            )
        warnings.warn(
            f"fill {fill!r} has no rectangular variant; the sharded engine "
            f"runs the chunked rect scan instead",
            stacklevel=2,
        )
        fill = "chunked"
        params = _accepted_params(_RECT_FILL_FNS[fill], params)
    bad = set(params) - set(_accepted_params(_RECT_FILL_FNS[fill], params))
    if bad:
        raise ValueError(
            f"rect fill {fill!r} does not accept params {sorted(bad)}"
        )
    return fill, tuple(sorted(params.items()))


def _scan_body(acc, diag, xb, yb, x_train, y_train, k, mode, fill,
               fill_static):
    """One test batch of the scan engine, folded into acc/diag in place."""
    d2 = pairwise_sq_dists(xb, x_train)
    order = torch.sort(d2, dim=-1, stable=True).indices
    ranks = ranks_from_order(order)
    u = (y_train[order] == yb[:, None]).to(torch.float32) / k
    g = superdiagonal_g(u, k, mode=mode)
    accumulate_fill(acc, g, ranks, fill, fill_static)
    # u in train coordinates is u[p, ranks[p, i]] = 1[y_train[i] == y_p]/k
    diag.add_(torch.gather(u, 1, ranks).sum(0))


def sti_knn_interactions(
    x_train,
    y_train,
    x_test,
    y_test,
    k: int,
    *,
    mode: InteractionMode = "sti",
    test_batch: int = 256,
    fill: str = "auto",
    fill_params: Optional[dict] = None,
    autotune: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Full STI-KNN by the `scan` engine: (n, n) symmetric interaction
    matrix on `device`, diagonal = main terms.

    Test points stream in batches of `test_batch`; a trailing partial batch
    runs unpadded, as the JAX scan engine does. Inputs may be numpy arrays
    or tensors and are moved to `device`. `autotune=True` tunes the fill
    when "auto" finds no cached winner.
    """
    dev = resolve_device(device)
    x_train, x_test = to_device(x_train, dev), to_device(x_test, dev)
    y_train, y_test = to_device(y_train, dev), to_device(y_test, dev)
    if x_train.ndim != 2 or x_test.ndim != 2:
        raise ValueError("features must be (num_points, dim)")
    if k < 1:
        raise ValueError("k must be >= 1")
    t = x_test.shape[0]
    if t < 1:
        raise ValueError("need at least one test point")
    n = x_train.shape[0]
    tb = min(int(test_batch), t)
    fill_name, fill_static = resolve_fill(
        fill, n, tb, fill_params=fill_params, backend=dev.type,
        autotune=autotune,
    )
    acc = torch.zeros((n, n), dtype=torch.float32, device=dev)
    diag = torch.zeros((n,), dtype=torch.float32, device=dev)
    for start in range(0, t, tb):
        _scan_body(acc, diag, x_test[start:start + tb],
                   y_test[start:start + tb], x_train, y_train, int(k), mode,
                   fill_name, fill_static)
    phi = acc.div_(t)
    phi.diagonal().copy_(diag / t)
    return phi


def sti_knn_matrix_one_test(u_sorted: torch.Tensor, k: int, *,
                            mode: InteractionMode = "sti") -> torch.Tensor:
    """Paper Alg. 1 `STI-KNN-one-test` in sorted coordinates: the (n, n)
    pair-interaction matrix for a single test point, zero diagonal."""
    g = superdiagonal_g(u_sorted, k, mode=mode)
    n = u_sorted.shape[-1]
    idx = torch.arange(n, device=u_sorted.device)
    phi = g[torch.maximum(idx[:, None], idx[None, :])]
    phi.fill_diagonal_(0.0)
    return phi
