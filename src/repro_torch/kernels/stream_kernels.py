"""Accumulator specs and update kernels of the streaming valuation step.

Counterpart of `repro.kernels.stream_kernels`, single device. The part of
the streaming step that differs between valuation methods lives in two
small objects:

  * `AccumulatorSpec` -- the shape/dtype contract of a method's running
    state: an (n, n) f32 matrix plus an (n,) f32 diagonal for the
    interaction methods ("sti", "sii"), a single (n,) f32 vector for the
    point-value methods ("knn_shapley", "wknn", "loo"). It owns init, the
    checkpoint array names and the finalize (divide-by-t) rule.
  * `UpdateKernel` -- the per-method functions the generic step calls:
    `contrib(d2, order, match, mask) -> u` (the sorted-coordinate
    contribution with the validity mask folded in, so padded test rows
    contribute exactly zero) and `update(state, u, g, ranks, mask) ->
    state`, which updates the state tensors IN PLACE (the JAX step donates
    them instead).

The online service's train-set mutations refold CACHED (d2, order) pairs
under a liveness mask through the same closures (`compact_order`,
`make_refold_kernel`); removed and free train slots hold the
`SENTINEL_COORD` / `SENTINEL_LABEL` sentinels, rank last and contribute
zero.

Kernels are built by registered factories keyed by method name.
`axis=None` builds the single-device update; a
`repro_torch.distributed.sharding.ShardGroup` builds the sharded update,
whose arguments are per-shard lists (the local views of the JAX
`shard_map` body): a rectangular row-block fill after an all-gather of
the g/rank tables for the interaction methods, a reduce-scatter of the
(n,) partial for the diagonal and for the point vector. The fused
megakernel (`repro_torch.kernels.sti_megakernel`) does not gather through
`order`: it builds each method's tables on the sorted stream, from the
closures registered with `register_megakernel_tables` below.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.sti_knn import (
    accumulate_fill,
    accumulate_rect_fill,
    ranks_from_order,
    superdiagonal_g,
)

__all__ = [
    "AccumulatorSpec",
    "UpdateKernel",
    "INTERACTION_STATE",
    "POINT_STATE",
    "SENTINEL_COORD",
    "SENTINEL_LABEL",
    "SENTINEL_D2",
    "register_update_kernel",
    "make_update_kernel",
    "accumulator_spec",
    "stream_methods",
    "has_stream_kernel",
    "register_megakernel_tables",
    "make_megakernel_tables",
    "compact_order",
    "register_refold_builder",
    "make_refold_kernel",
    "approx_point_methods",
    "make_approx_values",
    "scatter_point_update",
]


# Soft-delete sentinels for fixed-capacity training sets (the online
# valuation service mutates the train set without changing any shape): a
# removed / never-filled slot keeps its position but gets coordinates
# SENTINEL_COORD and label SENTINEL_LABEL. The squared distance to a
# sentinel slot is ~d * 1e30 -- finite in f32 (1e30 << 3.4e38) yet far
# larger than any real distance, so sentinel slots sort to the tail of
# every neighbour ranking; the label never matches a real test label, so
# their contribution is exactly zero through every registered method.
# 1e15, not 1e30: the expansion-form distance squares the coordinate, and
# (1e30)^2 overflows f32 to inf, which the -2ab cross term then turns into
# inf - inf = NaN.
SENTINEL_COORD = 1e15
SENTINEL_LABEL = -1
# Any squared distance at or above this is treated as a sentinel column
# (real squared distances would need coordinates ~1e10 to reach it).
SENTINEL_D2 = 1e20


@dataclasses.dataclass(frozen=True)
class AccumulatorSpec:
    """Shape/dtype contract of one method family's running state.

    `names` are the checkpoint array names; `layouts` name each array's
    shape: "matrix" = (n, n), "vector" = (n,). Sharded over D shards, a
    matrix is held as D (n/D, n) row blocks and a vector as D (n/D,)
    rows, one list of blocks per array (`init_shards`, `place`)."""

    kind: str                    # "interaction" | "point"
    names: tuple[str, ...]
    layouts: tuple[str, ...]

    def shapes(self, n: int) -> tuple[tuple[int, ...], ...]:
        """Array shapes for an n-point training set, in `names` order."""
        return tuple(
            (n, n) if lay == "matrix" else (n,) for lay in self.layouts
        )

    def init(self, n: int, device) -> tuple[torch.Tensor, ...]:
        """Zero-initialized f32 state tuple on `device`."""
        return tuple(torch.zeros(s, dtype=torch.float32, device=device)
                     for s in self.shapes(n))

    def shard_shapes(self, n: int, shards: int
                     ) -> tuple[tuple[int, ...], ...]:
        """Per-shard array shapes over `shards` row shards: (n/D, n) for a
        matrix, (n/D,) for a vector (the JAX package's
        `partition_specs`)."""
        if n % shards:
            raise ValueError(
                f"n={n} must divide evenly into {shards} row shards"
            )
        return tuple((n // shards,) + shape[1:] for shape in self.shapes(n))

    def init_shards(self, n: int, group) -> tuple[list, ...]:
        """Zero f32 state over the shards of `group`: per array, a list of
        one block per shard on its device."""
        return tuple(
            [torch.zeros(shape, dtype=torch.float32, device=dev)
             for dev in group.devices]
            for shape in self.shard_shapes(n, group.size))

    def place(self, arrays, group) -> tuple[list, ...]:
        """Whole (n, n) / (n,) arrays -> their per-shard row blocks on the
        devices of `group` (the JAX package's `shardings` placement)."""
        from repro_torch.distributed.sharding import shard_rows

        return tuple(
            [block.contiguous() for block in
             shard_rows(a.to(torch.float32), group)]
            for a in arrays)

    def result_arrays(self, state: tuple, t: int) -> dict:
        """Finalize a state of t accumulated test points into the
        `ValuationResult` array kwargs: {"phi": acc / t with diag / t on
        the diagonal} for interaction state, {"point_values": vec / t} for
        vector state. The interaction division is IN PLACE on `acc` (at
        n = 65536 a copy would be a second 16 GiB), so that `state` is
        consumed."""
        if self.kind == "point":
            return {"point_values": state[0] / t}
        acc, diag = state
        phi = acc.div_(t)
        phi.diagonal().copy_(diag / t)
        return {"phi": phi}


INTERACTION_STATE = AccumulatorSpec(
    "interaction", ("acc", "diag"), ("matrix", "vector")
)
POINT_STATE = AccumulatorSpec("point", ("vec",), ("vector",))


@dataclasses.dataclass(frozen=True)
class UpdateKernel:
    """One method's bound streaming-step functions (built by a factory)."""

    method: str
    spec: AccumulatorSpec
    needs_g: bool                      # compute superdiagonal_g before update
    g_mode: Optional[str]              # "sti" | "sii" | None
    contrib: Callable
    update: Callable


_KERNEL_FACTORIES: dict[str, tuple[AccumulatorSpec, Callable]] = {}


def register_update_kernel(method: str, spec: AccumulatorSpec,
                           factory: Callable) -> None:
    """Register a streaming update kernel for `method`: its state contract
    `spec` and `factory(method, k, opts, fill, fill_static, axis) ->
    UpdateKernel`."""
    _KERNEL_FACTORIES[method] = (spec, factory)


def stream_methods() -> list[str]:
    """Sorted names of every method with a registered streaming kernel."""
    return sorted(_KERNEL_FACTORIES)


def has_stream_kernel(method: str) -> bool:
    """Whether `method` can run on the generic streaming engine."""
    return method in _KERNEL_FACTORIES


def _registered(method: str) -> tuple[AccumulatorSpec, Callable]:
    if method not in _KERNEL_FACTORIES:
        raise ValueError(
            f"no streaming kernel for method {method!r}; registered: "
            f"{stream_methods()}"
        )
    return _KERNEL_FACTORIES[method]


def make_update_kernel(
    method: str,
    k: int,
    *,
    opts: Optional[dict] = None,
    fill: Optional[str] = None,
    fill_static: tuple = (),
    axis=None,
) -> UpdateKernel:
    """Build the bound `UpdateKernel` for `method` with the resolved fill
    `fill` / `fill_static` (a RECTANGULAR registry entry when `axis` is
    given). `axis` is None for the single-device update or a `ShardGroup`
    for the sharded one, whose `update` takes per-shard lists."""
    return _registered(method)[1](
        method, int(k), dict(opts or {}), fill, fill_static, axis
    )


def accumulator_spec(method: str) -> AccumulatorSpec:
    """The registered `AccumulatorSpec` a method streams into."""
    return _registered(method)[0]


def _interaction_factory(mode: str) -> Callable:
    """Factory for the "sti"/"sii" pair-interaction kernels: (n, n) acc of
    off-diagonal sums + (n,) diag of main terms, via the fill registry of
    `repro_torch.core.sti_knn`."""

    def factory(method, k, opts, fill, fill_static, axis):
        def contrib(d2, order, match, mask):
            return match * (mask / k)[:, None]

        if axis is None:
            def update(state, u, g, ranks, mask):
                acc, diag = state
                accumulate_fill(acc, g, ranks, fill, fill_static)
                # u in train coordinates is u[p, ranks[p, i]] =
                # mask_p 1[y_i==y_p]/k: the diag term rides on the fill
                # stage's u, masked for free.
                diag.add_(torch.gather(u, 1, ranks).sum(0))
                return (acc, diag)
        else:
            def update(state, u, g, ranks, mask):
                from repro_torch.kernels.sti_fill import rect_row_view

                # per-shard lists: acc[i] (nl, n), diag[i] (nl,),
                # u/g/ranks[i] (tb/D, n)
                acc, diag = state
                g_all = axis.all_gather(g)
                r_all = axis.all_gather(ranks)
                for i in range(axis.size):
                    nl = acc[i].shape[0]
                    # shard i's (tb, nl) row window of the global ranks
                    r_rows = rect_row_view(r_all[i], i * nl, nl)
                    accumulate_rect_fill(acc[i], g_all[i], r_rows, r_all[i],
                                         fill, fill_static)
                # the diag update reduces over the test dim, so it needs
                # only a reduce-scatter of the (n,) partials -- O(n)
                # bytes, not the O(tb n) gather the fill needs whole
                parts = axis.reduce_scatter(
                    [torch.gather(u_i, 1, r_i).sum(0)
                     for u_i, r_i in zip(u, ranks)])
                for d_i, part in zip(diag, parts):
                    d_i.add_(part)
                return (acc, diag)

        return UpdateKernel(method, INTERACTION_STATE, True, mode,
                            contrib, update)

    return factory


# ------------------------------------------------------------ point values
def _match_contrib(d2, order, match, mask, k, opts):
    """Masked 0/1 label match in sorted coordinates (knn_shapley / loo)."""
    return match * mask[:, None]


def _wknn_contrib(d2, order, match, mask, k, opts):
    """Masked weighted contribution c_j = w_j * 1[y_j == y_test] in sorted
    coordinates -- the soft-label weighted KNN utility's per-point value."""
    from repro_torch.core.wknn import distance_weights

    w = distance_weights(d2, opts.get("weights", "rbf"))
    return torch.gather(w, 1, order) * match * mask[:, None]


def _shapley_point_values(u, ranks, k, opts):
    """(tb, n) per-test-point Shapley values in TRAIN coordinates via the
    Jia et al. reverse-cumsum recurrence -- linear in `u`, so the folded
    validity mask zeroes padded rows exactly. Shared by "knn_shapley"
    (u = 0/1 match) and "wknn" (u = weighted contribution)."""
    from repro_torch.core.knn_shapley import knn_shapley_from_sorted

    return torch.gather(knn_shapley_from_sorted(u, k), 1, ranks)


def _loo_window(u, k):
    """Sorted-coordinate leave-one-out deltas: removing sorted point j < k
    slides the (k+1)-th neighbour in, delta = (u[j] - u[k]) / k; points
    outside the window contribute zero."""
    n = u.shape[-1]
    nxt = u[..., k:k + 1] if n > k else torch.zeros_like(u[..., :1])
    in_window = (torch.arange(n, device=u.device) < k)[None, :]
    return torch.where(in_window, (u - nxt) / k, 0.0)


def _loo_point_values(u, ranks, k, opts):
    """(tb, n) leave-one-out deltas in TRAIN coordinates."""
    return torch.gather(_loo_window(u, k), 1, ranks)


def _point_factory(contrib_fn: Callable, values_fn: Callable) -> Callable:
    """Factory maker for vector-accumulator methods: `values_fn` maps the
    batch to (tb, n) per-train-point values in train coordinates; the
    update adds their test-dim sum into the (n,) vector in place
    (reduce-scattered onto the (n/D,) rows of each shard when sharded --
    the vector twin of the interaction diag update)."""

    def factory(method, k, opts, fill, fill_static, axis):
        def contrib(d2, order, match, mask):
            return contrib_fn(d2, order, match, mask, k, opts)

        def update(state, u, g, ranks, mask):
            if axis is None:
                state[0].add_(values_fn(u, ranks, k, opts).sum(0))
                return state
            parts = axis.reduce_scatter(
                [values_fn(u_i, r_i, k, opts).sum(0)
                 for u_i, r_i in zip(u, ranks)])
            for v_i, part in zip(state[0], parts):
                v_i.add_(part)
            return state

        return UpdateKernel(method, POINT_STATE, False, None,
                            contrib, update)

    return factory


# ------------------------------------------------- megakernel sorted tables
# The fused megakernel never gathers the train-coordinate (tb, n) arrays
# through `order`: its rank phase yields the batch in SORTED coordinates
# and the rank scatter happens at the accumulator. The closures below are
# the registered contrib/values closures restated on the sorted stream --
# legal because each is elementwise in the sorted axis, a recurrence over
# sorted positions, or (the wknn rbf bandwidth) a permutation-invariant
# row statistic. The plain megakernels run them; the CUDA kernel's table
# phase computes the same values (csrc/sti_megakernel.cu, `tables_row`).

_MEGAKERNEL_TABLES: dict[str, Callable] = {}


def register_megakernel_tables(method: str, factory: Callable) -> None:
    """Register `factory(k, opts) -> tables` building the method's
    sorted-coordinate megakernel tables. Interaction factories return
    `tables(d2_sorted, match_sorted, mask) -> (g, u)` ((tb, n) each, both
    in sorted coordinates); point factories return
    `tables(d2_sorted, match_sorted, mask) -> values` ((tb, n), value of
    the train point at each sorted position). The validity mask folds in
    here exactly as in `UpdateKernel.contrib`."""
    _MEGAKERNEL_TABLES[method] = factory


def make_megakernel_tables(method: str, k: int, *,
                           opts: Optional[dict] = None) -> Callable:
    """Resolve the sorted-coordinate table closure of `method` (see
    `register_megakernel_tables`). Raises KeyError for methods without a
    megakernel registration."""
    if method not in _MEGAKERNEL_TABLES:
        raise KeyError(
            f"method {method!r} has no megakernel tables; registered: "
            f"{sorted(_MEGAKERNEL_TABLES)}"
        )
    return _MEGAKERNEL_TABLES[method](int(k), dict(opts or {}))


def _interaction_megatables(mode: str) -> Callable:
    """sti/sii megakernel tables: the same u = match * mask/k contribution
    and `superdiagonal_g` recurrence as `_interaction_factory`, minus the
    train-coordinate gathers."""

    def factory(k, opts):
        def tables(d2s, match_s, mask):
            u = match_s * (mask / k)[:, None]
            return superdiagonal_g(u, k, mode=mode), u

        return tables

    return factory


def _shapley_megatables(weighted: bool) -> Callable:
    """knn_shapley/wknn megakernel tables: `knn_shapley_from_sorted` on the
    (optionally distance-weighted) sorted contribution. The weights are
    elementwise plus a permutation-invariant row statistic (the rbf sigma2
    row mean), so evaluating them on the SORTED distances matches the
    three-stage path to float-summation order."""

    def factory(k, opts):
        def tables(d2s, match_s, mask):
            from repro_torch.core.knn_shapley import knn_shapley_from_sorted

            if weighted:
                from repro_torch.core.wknn import distance_weights

                w = distance_weights(d2s, opts.get("weights", "rbf"))
                u = w * match_s * mask[:, None]
            else:
                u = match_s * mask[:, None]
            return knn_shapley_from_sorted(u, k)

        return tables

    return factory


def _loo_megatables(k, opts):
    """loo megakernel tables: the leave-one-out window delta on the sorted
    stream."""

    def tables(d2s, match_s, mask):
        return _loo_window(match_s * mask[:, None], k)

    return tables


# -------------------------------------------------------------- refold path
# Incremental train-set mutation (the online valuation service's
# add_points / remove_points) refolds CACHED per-batch intermediates -- the
# (tb, n) squared distances and stable argsort order of the distance stage
# -- against the current liveness mask, skipping the distance and the sort.
# The refold reuses each method's registered contrib/update closures (on a
# card an interaction refold runs the CUDA fill), so it is exact by
# construction: for a removal, compacting the cached order (live slots to
# the front, dead slots to the tail, each group in its relative order)
# reproduces bit for bit the live prefix a fresh stable argsort of the
# mutated train set would give, and every dead slot contributes zero
# through the sentinel label.


def compact_order(order: torch.Tensor, keep: torch.Tensor):
    """Compact a cached argsort order against a liveness mask.

    Args:
      order: (tb, n) stable argsort of cached squared distances (train
        indices, closest first; any integer dtype).
      keep: (n,) liveness per train slot (0 = removed/free, nonzero =
        live), indexed by train coordinate.

    Returns:
      (new_order, ranks): `new_order` (tb, n), order's dtype, with the
      live entries moved to the front and the dead entries to the tail,
      each group in its relative order -- what a stable argsort of the
      mutated distance row gives on the live prefix, because dead slots
      hold sentinel distances larger than any real one; `ranks` (int64)
      its inverse permutation. The move is a scatter of a permutation
      (every target position written once), so it is deterministic.
    """
    keep_s = keep[order.long()] > 0              # liveness, sorted coords
    live = torch.cumsum(keep_s.to(torch.int64), dim=-1)
    dead = torch.cumsum((~keep_s).to(torch.int64), dim=-1)
    n_live = live[..., -1:]
    pos = torch.where(keep_s, live - 1, n_live + dead - 1)
    new_order = torch.zeros_like(order).scatter_(1, pos, order)
    return new_order, ranks_from_order(new_order)


_REFOLD_BUILDERS: dict[str, Callable] = {}


def register_refold_builder(kind: str, builder: Callable) -> None:
    """Register the refold-step builder for one `AccumulatorSpec.kind`.

    `builder(kernel, k) -> refold` receives the method's bound
    `UpdateKernel` and returns
    `refold(state, d2, order, yb, mask, y_train, keep) -> state`, which
    folds one cached test batch into `state` (in place) under the
    liveness mask `keep`. Registered per spec kind: the per-method math
    rides in through the kernel's contrib/update closures.
    """
    _REFOLD_BUILDERS[kind] = builder


def make_refold_kernel(
    method: str,
    k: int,
    *,
    opts: Optional[dict] = None,
    fill: Optional[str] = None,
    fill_static: tuple = (),
) -> Callable:
    """Build `refold(state, d2, order, yb, mask, y_train, keep) -> state`
    for `method`: the incremental-mutation twin of the streaming step,
    driven from cached distance/order intermediates instead of raw test
    features. Single device (square fill registry); the service gathers a
    sharded session's state dense, refolds, and re-places it."""
    spec = accumulator_spec(method)
    builder = _REFOLD_BUILDERS.get(spec.kind)
    if builder is None:
        raise ValueError(
            f"no refold builder for accumulator kind {spec.kind!r}; "
            f"registered: {sorted(_REFOLD_BUILDERS)}"
        )
    kernel = make_update_kernel(
        method, int(k), opts=opts, fill=fill, fill_static=fill_static
    )
    return builder(kernel, int(k))


def _masked_refold_builder(kernel: UpdateKernel, k: int) -> Callable:
    """The generic refold body shared by both state contracts: compact the
    cached order, sentinel-mask dead distance columns (so row statistics
    like the wknn rbf bandwidth see exactly the reduced train set), then
    run the method's own contrib -> [g] -> update closures."""
    dead_d2 = SENTINEL_D2 * 1e10

    def refold(state, d2, order, yb, mask, y_train, keep):
        d2 = torch.where(keep[None, :] > 0, d2,
                         torch.tensor(dead_d2, dtype=d2.dtype,
                                      device=d2.device))
        new_order, ranks = compact_order(order, keep)
        order_l = new_order.long()
        match = (y_train[order_l] == yb[:, None]).to(torch.float32)
        u = kernel.contrib(d2, order_l, match, mask)
        g = (superdiagonal_g(u, k, mode=kernel.g_mode)
             if kernel.needs_g else None)
        return kernel.update(state, u, g, ranks, mask)

    return refold


register_refold_builder("interaction", _masked_refold_builder)
register_refold_builder("point", _masked_refold_builder)


# ------------------------------------------------------ approx (candidate)
# engine="approx" replaces the dense (tb, n) sorted pipeline with the
# (tb, m) CANDIDATE vectors of the LSH stage
# (`repro_torch.kernels.ann.topm_candidates`): candidates arrive sorted by
# exact distance, so candidate position IS the sorted coordinate and the
# recurrences below are the exact ones truncated to the top m -- the
# certified-error estimators of `repro_torch.core.approx`. Results land in
# the (n,) accumulator by one deterministic scatter per batch.


def approx_point_methods() -> tuple[str, ...]:
    """Point methods with a candidate-space (engine="approx") value path."""
    return ("knn_shapley", "wknn", "loo")


def make_approx_values(method: str, k: int, *, opts: Optional[dict] = None
                       ) -> Callable:
    """The candidate-space value closure of a point method:
    `values(d2m, match, valid, mask, sigma2) -> (tb, m)`, the value of each
    CANDIDATE at its candidate position, with `valid` (real distinct
    candidates) and `mask` (real test rows) folded in, so every dropped
    slot and padded row contributes zero. `sigma2` is the (tb, 1) analytic
    rbf bandwidth (`repro_torch.kernels.ann.full_mean_sq_dist`; ignored by
    the other weights). knn_shapley/wknn run the reverse-cumsum recurrence
    on the truncated vector; loo slides the (k+1)-th CANDIDATE in (exact
    once the matched prefix covers k+1)."""
    opts = dict(opts or {})
    k = int(k)
    if method == "knn_shapley":
        def values(d2m, match, valid, mask, sigma2):
            from repro_torch.core.knn_shapley import knn_shapley_from_sorted

            return knn_shapley_from_sorted(match * valid * mask[:, None], k)
    elif method == "wknn":
        kind = opts.get("weights", "rbf")

        def values(d2m, match, valid, mask, sigma2):
            from repro_torch.core.knn_shapley import knn_shapley_from_sorted
            from repro_torch.core.wknn import distance_weights

            w = distance_weights(d2m, kind, sigma2=sigma2)
            return knn_shapley_from_sorted(w * match * valid * mask[:, None],
                                           k)
    elif method == "loo":
        def values(d2m, match, valid, mask, sigma2):
            return _loo_window(match * valid * mask[:, None], k)
    else:
        raise ValueError(
            f"no approx candidate-space kernel for method {method!r}; "
            f"available: {approx_point_methods()}"
        )
    return values


def scatter_point_update(vec: torch.Tensor, cand: torch.Tensor,
                         vals: torch.Tensor, valid: torch.Tensor
                         ) -> torch.Tensor:
    """Add (tb, m) candidate-coordinate values into the (n,) accumulator in
    place, deterministically: the sparse O(tb m) twin of the dense point
    update. Invalid slots go to the dropped index n, as in the reference's
    `vec.at[idx].add(..., mode="drop")`.

    `index_add_` on a card adds with atomics in no fixed order, so the
    batch is reduced without them: the touched ids are compacted
    (`torch.unique`), each test row's values written into a (tb, ids)
    table (a row holds an id at most once: the candidates of a row are
    distinct), and the table summed down its rows by one reduction before
    it is added to the ids' values. The same inputs give the same bits on
    every run; the order of additions differs from the reference's
    sequential one in the last bits."""
    n = vec.shape[0]
    tb = cand.shape[0]
    ext = torch.cat([vec, vec.new_zeros(1)])
    idx = torch.where(valid > 0, cand, n)
    ids, inv = torch.unique(idx, sorted=True, return_inverse=True)
    table = vec.new_zeros((tb, ids.shape[0]))
    rows = torch.arange(tb, device=vec.device)[:, None].expand_as(inv)
    # the id-n column collects every row's invalid slots in any order; it
    # is dropped with ext[n] below
    table[rows, inv] = vals.to(vec.dtype)
    ext[ids] = ext[ids] + table.sum(dim=0)
    return vec.copy_(ext[:n])


register_update_kernel("sti", INTERACTION_STATE, _interaction_factory("sti"))
register_update_kernel("sii", INTERACTION_STATE, _interaction_factory("sii"))
register_update_kernel(
    "knn_shapley", POINT_STATE,
    _point_factory(_match_contrib, _shapley_point_values),
)
register_update_kernel(
    "wknn", POINT_STATE, _point_factory(_wknn_contrib, _shapley_point_values)
)
register_update_kernel(
    "loo", POINT_STATE, _point_factory(_match_contrib, _loo_point_values)
)
register_megakernel_tables("sti", _interaction_megatables("sti"))
register_megakernel_tables("sii", _interaction_megatables("sii"))
register_megakernel_tables("knn_shapley", _shapley_megatables(False))
register_megakernel_tables("wknn", _shapley_megatables(True))
register_megakernel_tables("loo", _loo_megatables)
