"""Method-generic streaming valuation pipeline: distance -> rank -> update.

Counterpart of `repro.kernels.sti_pipeline` (the single-device engines).
Per test batch, `_stream_body` runs the distance (the CUDA kernel on a
card, the plain expansion on the CPU), a stable sort, the rank inversion,
the method's masked contribution, `superdiagonal_g` for the interaction
methods, and the method's update kernel, which folds the batch into the
state IN PLACE -- the JAX step donates it instead: "sti"/"sii" update an
(n, n) accumulator and (n,) diagonal through the fill registry,
"knn_shapley"/"wknn"/"loo" a single (n,) vector. A ragged trailing batch
is padded to the batch shape by `pad_test_batch`; the mask zeroes its
contribution exactly. Each stage runs inside a named span of
`repro_torch.tracing` (`step.distance`, `step.rank`, `step.contrib`,
`step.g`, `step.update`), which a profiler's trace reads.

`fill="megakernel"` swaps the whole step for ONE launch of the fused
kernel (`repro_torch.kernels.sti_megakernel`): distance, stable sort,
tables and update in a single cooperative CUDA kernel on a card, its
plain version on the CPU.

    from repro_torch.kernels.sti_pipeline import fused_sti_knn_interactions
    phi = fused_sti_knn_interactions(x_train, y_train, x_test, y_test, k=5)

`prepare_stream_step` is the method-generic front door (tuple-state
contract) that `ValuationSession` drives; `stream_point_values` the
one-shot entry point of the point methods. `make_rank_step` /
`make_refold_step` / `prepare_refold_step` split the step for the online
service's mutations: the distance and stable sort once per logged batch
(cached), then a refold of the cache under the current liveness mask.

`make_sharded_step` / `make_sharded_point_step` / `prepare_sharded_step`
/ `prepare_sharded_stream_step` / `sharded_sti_knn_interactions` are the
sharded form over a `ShardGroup` of D shards
(`repro_torch.distributed.sharding`): each test batch is split into D
row slices, the state into D row blocks ((n/D, n) of the accumulator and
(n/D,) of the diagonal or point vector), and the step's arguments are
per-shard lists. Each shard runs
distance/rank/g on its slice; an all-gather of the small (tb, n) g/rank
tables then feeds a rectangular fill of every row block, and a
reduce-scatter of (n,) partials the diagonal or the point vector. The row
blocks are complete sums, so finalize only concatenates them.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.sti_knn import (
    InteractionMode,
    pairwise_sq_dists,
    ranks_from_order,
    resolve_fill,
    resolve_rect_fill,
    superdiagonal_g,
)
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels.stream_kernels import (
    INTERACTION_STATE,
    AccumulatorSpec,
    UpdateKernel,
    accumulator_spec,
    make_refold_kernel,
    make_update_kernel,
)
from repro_torch.tracing import span

__all__ = [
    "fused_sti_knn_interactions",
    "make_fused_step",
    "make_point_step",
    "prepare_fused_step",
    "prepare_stream_step",
    "stream_point_values",
    "pad_test_batch",
    "resolve_distance",
    "interaction_state_from_numpy",
    "make_sharded_step",
    "make_sharded_point_step",
    "prepare_sharded_step",
    "prepare_sharded_stream_step",
    "sharded_sti_knn_interactions",
    "make_approx_point_step",
    "make_approx_interaction_step",
    "ApproxPairAccumulator",
    "make_rank_step",
    "make_refold_step",
    "prepare_refold_step",
]

_DISTANCES = ("plain", "cuda")


def resolve_distance(
    distance: str, t: int, n: int, d: int, *, backend: str = "cuda",
    autotune: bool = False,
) -> str:
    """Resolve "auto" | "plain" | "cuda" to a distance implementation name.
    "auto" takes `autotune.best_distance` for `backend`: the CUDA kernel
    on a card, the plain expansion elsewhere (one candidate a backend,
    so neither the tuning cache nor `autotune=True` changes it)."""
    if distance == "auto":
        from repro_torch.kernels.autotune import best_distance

        distance, _ = best_distance(t, n, d, backend=backend,
                                    allow_tune=autotune)
    if distance not in _DISTANCES:
        raise ValueError(
            f"unknown distance impl: {distance!r}; known: {_DISTANCES}"
        )
    return distance


def _distance_fn(name: str) -> Callable:
    if name == "plain":
        return pairwise_sq_dists
    from repro_torch.kernels.distance import distance_cuda

    return distance_cuda


def _feature_dtype(*xs, fill: Optional[str] = None) -> torch.dtype:
    """The dtype the step takes for these feature sets: bfloat16 when all
    of them are bfloat16 and the step is the three-stage one, float32
    otherwise (float64, integer and float16 features are cast, as the JAX
    package's f32 default does; the megakernel reads f32 and rounds its
    cross term itself under compute_dtype="bfloat16")."""
    if fill != "megakernel" and all(
            isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
            for x in xs):
        return torch.bfloat16
    return torch.float32


def pad_test_batch(xb: torch.Tensor, yb: torch.Tensor, tb: int):
    """Pad a (possibly ragged) test batch to exactly `tb` rows and return
    `(xb, yb, mask)` with mask 1.0 on real points, 0.0 on padding (f32, on
    xb's device). g, the fill and the diagonal term are linear in the
    masked u, so padded points contribute exactly zero."""
    b = xb.shape[0]
    if b > tb:
        raise ValueError(f"batch of {b} test points exceeds test_batch={tb}")
    mask = torch.ones((tb,), dtype=torch.float32, device=xb.device)
    if b == tb:
        return xb, yb, mask
    mask[b:] = 0.0
    xp = torch.zeros((tb,) + tuple(xb.shape[1:]), dtype=xb.dtype,
                     device=xb.device)
    yp = torch.zeros((tb,), dtype=yb.dtype, device=yb.device)
    xp[:b] = xb
    yp[:b] = yb
    return xp, yp, mask


def _prologue(kernel: UpdateKernel, k: int, dist_fn: Callable) -> Callable:
    """The head of a step on one batch, everything before the update:

        prologue(xb, yb, mask, x_train, y_train) -> (u, g, ranks)

    distance -> stable sort/rank -> sorted label match -> method
    contribution (mask folded in) -> optional `superdiagonal_g`."""

    def prologue(xb, yb, mask, x_train, y_train):
        with span("step.distance"):
            d2 = dist_fn(xb, x_train)                            # (tb, n)
        with span("step.rank"):
            order = torch.sort(d2, dim=-1, stable=True).indices  # int64
            ranks = ranks_from_order(order)
        with span("step.contrib"):
            match = (y_train[order] == yb[:, None]).to(torch.float32)
            u = kernel.contrib(d2, order, match, mask)
        if not kernel.needs_g:
            return u, None, ranks
        with span("step.g"):
            g = superdiagonal_g(u, k, mode=kernel.g_mode)
        return u, g, ranks

    return prologue


def _stream_body(kernel: UpdateKernel, k: int, dist_fn: Callable,
                 sharded: bool = False) -> Callable:
    """The generic per-batch step body:

        body(state, xb, yb, mask, x_train, y_train) -> state

    `_prologue`, then the method's update kernel (in place on `state`).
    `sharded=True` (a kernel built with a `ShardGroup`) takes every
    argument as a per-shard list: each shard runs the prologue on its own
    test slice, and the update's collectives join them."""
    prologue = _prologue(kernel, k, dist_fn)

    def body(state, xb, yb, mask, x_train, y_train):
        u, g, ranks = prologue(xb, yb, mask, x_train, y_train)
        with span("step.update"):
            return kernel.update(state, u, g, ranks, mask)

    def sharded_body(state, xb, yb, mask, x_train, y_train):
        heads = [prologue(*args)
                 for args in zip(xb, yb, mask, x_train, y_train)]
        u, g, ranks = (list(col) for col in zip(*heads))
        with span("step.update"):
            return kernel.update(state, u, g, ranks, mask)

    return sharded_body if sharded else body


@functools.lru_cache(maxsize=None)
def make_fused_step(
    k: int,
    mode: InteractionMode = "sti",
    fill: str = "chunked",
    fill_static: tuple = (),
    distance: str = "plain",
) -> Callable:
    """Build the fused interaction step

        step(acc, diag, xb, yb, mask, x_train, y_train) -> (acc, diag)

    acc (n, n) f32 and diag (n,) f32 are updated in place and returned;
    xb/yb/mask is one (tb, d)/(tb,)/(tb,) test batch (`pad_test_batch`
    builds the mask). Cached per static configuration.

    `fill="megakernel"` returns the single-launch step of
    `sti_megakernel_cuda`, `fill_static` carrying its compute dtype (the
    `distance` name is then unused: the distance runs inside the
    kernel)."""
    if fill == "megakernel":
        from repro_torch.kernels.sti_megakernel import sti_megakernel_cuda

        params = dict(fill_static)

        def mega_step(acc, diag, xb, yb, mask, x_train, y_train):
            return sti_megakernel_cuda(acc, diag, xb, yb, mask, x_train,
                                       y_train, k=int(k), mode=mode, **params)

        return mega_step
    body = _stream_body(
        make_update_kernel(mode, k, fill=fill, fill_static=fill_static),
        int(k), _distance_fn(distance),
    )

    def step(acc, diag, xb, yb, mask, x_train, y_train):
        return body((acc, diag), xb, yb, mask, x_train, y_train)

    return step


@functools.lru_cache(maxsize=None)
def make_point_step(
    method: str,
    k: int,
    method_static: tuple = (),
    distance: str = "plain",
    fill: Optional[str] = None,
    fill_static: tuple = (),
) -> Callable:
    """Build the vector-state step of a point-value method ("knn_shapley",
    "wknn", "loo"):

        step(vec, xb, yb, mask, x_train, y_train) -> vec

    vec (n,) f32 accumulates the SUM of per-test-point values in place
    (finalize divides by t). `method_static` is the hashable method-option
    tuple, e.g. (("weights", "rbf"),) for wknn. `fill="megakernel"`
    returns the single-launch step of `point_megakernel_cuda` with
    `fill_static` carrying its compute dtype. Cached per configuration."""
    if fill == "megakernel":
        from repro_torch.kernels.sti_megakernel import point_megakernel_cuda

        params = dict(fill_static)
        opts = dict(method_static)

        def mega_step(vec, xb, yb, mask, x_train, y_train):
            return point_megakernel_cuda(vec, xb, yb, mask, x_train, y_train,
                                         method=method, k=int(k), opts=opts,
                                         **params)

        return mega_step
    body = _stream_body(
        make_update_kernel(method, k, opts=dict(method_static)),
        int(k), _distance_fn(distance),
    )

    def step(vec, xb, yb, mask, x_train, y_train):
        return body((vec,), xb, yb, mask, x_train, y_train)[0]

    return step


@functools.lru_cache(maxsize=None)
def make_rank_step(distance: str = "plain") -> Callable:
    """Stage A of the incremental-mutation path: the distance + stable sort
    prefix of the streaming step, split out so its outputs can be CACHED:

        rank(xb, x_train) -> (d2, order)

    d2 (tb, n) f32 squared distances, order (tb, n) int32 stable argsort
    (closest first; int32 as the JAX package's, whose orders the caches
    and parity tests compare). The online valuation service runs it once
    per cached test batch and replays mutations through
    `make_refold_step`, which skips both the distance and the sort. On a
    card `distance="cuda"` runs the CUDA distance kernel. `rank.distance`
    is its distance function alone: an element of d2 depends only on its
    test and train rows, so columns it computes for new train points are
    the bits a ranking of the whole set gives them."""
    dist_fn = _distance_fn(distance)

    def rank(xb, x_train):
        d2 = dist_fn(xb, x_train)
        order = torch.sort(d2, dim=-1, stable=True).indices
        return d2, order.to(torch.int32)

    rank.distance = dist_fn
    return rank


@functools.lru_cache(maxsize=None)
def make_refold_step(
    method: str,
    k: int,
    method_static: tuple = (),
    fill: str = "chunked",
    fill_static: tuple = (),
) -> Callable:
    """Stage B of the incremental-mutation path: the refold of one CACHED
    test batch under a train-slot liveness mask (tuple-state, in place):

        step(state, d2, order, yb, mask, y_train, keep) -> state

    `d2`/`order` come from `make_rank_step` (possibly captured against an
    older train-set snapshot); `keep` (n,) marks live slots. The body
    compacts the cached order against `keep` and runs the method's
    registered contrib/[g]/update closures
    (`stream_kernels.make_refold_kernel`), so a remove_points refold is
    EXACTLY the state a full recompute against the mutated train set
    gives, without the distance or sort stages. On a card an interaction
    refold with `fill="cuda"` runs the CUDA fill."""
    if accumulator_spec(method).kind == "interaction":
        body = make_refold_kernel(
            method, int(k), fill=fill, fill_static=fill_static
        )
    else:
        body = make_refold_kernel(method, int(k), opts=dict(method_static))

    def step(state, d2, order, yb, mask, y_train, keep):
        return tuple(body(state, d2, order, yb, mask, y_train, keep))

    return step


def prepare_refold_step(
    method: str,
    n: int,
    d: int,
    k: int,
    *,
    test_batch: int = 256,
    fill: str = "auto",
    fill_params: Optional[dict] = None,
    distance: str = "auto",
    autotune: bool = False,
    method_opts: Optional[dict] = None,
    device="cuda",
) -> tuple[Callable, Callable, dict, AccumulatorSpec]:
    """Resolve the incremental-mutation pair for `method` on `device` and
    return `(refold_step, rank_step, resolved, spec)` (see
    `make_rank_step` / `make_refold_step`). Resolution mirrors
    `prepare_stream_step` -- the same square fill registry for interaction
    methods, the same distance registry -- so the refold replays bit for
    bit what the live three-stage step folds. Single device: a sharded
    session's state is gathered dense, refolded, and re-placed."""
    spec = accumulator_spec(method)
    backend = resolve_device(device).type
    tb = max(1, int(test_batch))
    dist_name = resolve_distance(distance, tb, n, d, backend=backend,
                                 autotune=autotune)
    if spec.kind == "interaction":
        fill_name, fill_static = resolve_fill(
            fill, n, tb, fill_params=fill_params, backend=backend,
            autotune=autotune,
        )
        refold = make_refold_step(method, int(k), (), fill_name,
                                  fill_static)
        resolved = {"fill": fill_name, "distance": dist_name}
    else:
        refold = make_refold_step(method, int(k),
                                  _method_static(method_opts))
        resolved = {"fill": None, "distance": dist_name}
    return refold, make_rank_step(dist_name), resolved, spec


def _method_static(method_opts: Optional[dict]) -> tuple:
    """Method options as the hashable static tuple the step caches key
    on."""
    return tuple(sorted((method_opts or {}).items()))


def _tuple_state(inner: Callable) -> Callable:
    """Adapt an unpacked-state step (acc, diag, ...) to the uniform
    tuple-state contract `step(state, *args) -> state`."""

    def step(state, *args):
        return tuple(inner(*state, *args))

    return step


def _vector_state(inner: Callable) -> Callable:
    """Adapt a bare-vector step (vec, ...) to the tuple-state contract."""

    def step(state, *args):
        return (inner(state[0], *args),)

    return step


def _resolve_megakernel(fill: str, fill_params: Optional[dict],
                        step_key: Optional[tuple] = None,
                        autotune: bool = False) -> Optional[tuple]:
    """The megakernel's static-param tuple when a step should run as the
    fused kernel, else None for the three-stage step. `fill="megakernel"`
    forces it. `fill="auto"` with a `step_key` (method, n, d, k, tb,
    backend) consults the step-level tuning cache
    (`autotune.best_megastep`, platform-keyed; `autotune=True` tunes on a
    miss): the megakernel runs only where a tuned run measured it faster
    than the three-stage step, and a miss keeps the three-stage step. The
    sharded steps pass no key, so "auto" never picks it there."""
    from repro_torch.kernels.sti_megakernel import megakernel_static

    if fill == "megakernel":
        return megakernel_static(fill_params)
    if fill != "auto" or step_key is None:
        return None
    from repro_torch.kernels.autotune import best_megastep

    method, n, d, k, tb, backend = step_key
    name, params = best_megastep(n, tb, d, k, method=method,
                                 backend=backend, allow_tune=autotune)
    if name != "megakernel":
        return None
    return megakernel_static({**params, **(fill_params or {})})


def prepare_fused_step(
    n: int,
    d: int,
    k: int,
    *,
    mode: InteractionMode = "sti",
    test_batch: int = 256,
    fill: str = "auto",
    fill_params: Optional[dict] = None,
    distance: str = "auto",
    autotune: bool = False,
    device="cuda",
) -> tuple[Callable, dict]:
    """Resolve fill/distance for an (n, d) train set streamed in batches of
    `test_batch` on `device` and return `(step, resolved)` (see
    `make_fused_step`), `resolved` naming the concrete {"fill",
    "distance"} implementations; {"fill": "megakernel", "distance":
    "fused"} for the fused kernel, whose distance runs inside it (forced
    by `fill="megakernel"`, or picked by "auto" where the step-level
    tuning cache says it wins). `autotune=True` tunes what "auto" finds
    missing from the cache."""
    backend = resolve_device(device).type
    tb = max(1, int(test_batch))
    mega = _resolve_megakernel(fill, fill_params,
                               (mode, n, d, int(k), tb, backend), autotune)
    if mega is not None:
        step = make_fused_step(int(k), mode, "megakernel", mega)
        return step, {"fill": "megakernel", "distance": "fused"}
    fill_name, fill_static = resolve_fill(
        fill, n, tb, fill_params=fill_params, backend=backend,
        autotune=autotune,
    )
    dist_name = resolve_distance(distance, tb, n, d, backend=backend,
                                 autotune=autotune)
    step = make_fused_step(int(k), mode, fill_name, fill_static, dist_name)
    return step, {"fill": fill_name, "distance": dist_name}


def prepare_stream_step(
    method: str,
    n: int,
    d: int,
    k: int,
    *,
    test_batch: int = 256,
    fill: str = "auto",
    fill_params: Optional[dict] = None,
    distance: str = "auto",
    autotune: bool = False,
    method_opts: Optional[dict] = None,
    device="cuda",
) -> tuple[Callable, dict, AccumulatorSpec]:
    """Method-generic form of `prepare_fused_step`: return `(step,
    resolved, spec)` for ANY registered streaming method, with the uniform
    tuple-state contract

        step(state, xb, yb, mask, x_train, y_train) -> state

    where `state` is `spec.init(n, device)`-shaped ((acc, diag) or
    (vec,)). Point methods have no fill stage (resolved["fill"] is None)
    except `fill="megakernel"` (or an "auto" whose step-level tuning
    cache entry for the method names it), which routes any method through
    its fused kernel. `method_opts` carries method statics such as the
    wknn weight kind. This is the per-batch unit `ValuationSession`
    drives."""
    spec = accumulator_spec(method)
    tb = max(1, int(test_batch))
    if spec.kind == "interaction":
        inner, resolved = prepare_fused_step(
            n, d, k, mode=method, test_batch=tb, fill=fill,
            fill_params=fill_params, distance=distance, autotune=autotune,
            device=device,
        )
        return _tuple_state(inner), dict(resolved), spec
    backend = resolve_device(device).type
    mega = _resolve_megakernel(fill, fill_params,
                               (method, n, d, int(k), tb, backend), autotune)
    if mega is not None:
        inner = make_point_step(method, int(k), _method_static(method_opts),
                                fill="megakernel", fill_static=mega)
        return (_vector_state(inner),
                {"fill": "megakernel", "distance": "fused"}, spec)
    dist_name = resolve_distance(distance, tb, n, d, backend=backend,
                                 autotune=autotune)
    inner = make_point_step(method, int(k), _method_static(method_opts),
                            dist_name)
    return _vector_state(inner), {"fill": None, "distance": dist_name}, spec


def _prepare_operands(x_train, y_train, x_test, k, dev, fill):
    """Shared argument checks of the one-shot entry points -> (x_train on dev,
    y_train on dev, feature dtype, t)."""
    fdt = _feature_dtype(x_train, x_test, fill=fill)
    x_train = to_device(x_train, dev, fdt).contiguous()
    y_train = to_device(y_train, dev)
    if x_train.ndim != 2 or x_test.ndim != 2:
        raise ValueError("features must be (num_points, dim)")
    if k < 1:
        raise ValueError("k must be >= 1")
    t = int(x_test.shape[0])
    if t < 1:
        raise ValueError("need at least one test point")
    return x_train, y_train, fdt, t


def _stream(step, state, x_test, y_test, tb, dev, fdt, x_train, y_train):
    """Fold the test set into `state` in padded batches of `tb`, moving
    each batch to `dev` as it is consumed."""
    t = int(x_test.shape[0])
    for start in range(0, t, tb):
        xb, yb, mask = pad_test_batch(
            to_device(x_test[start:start + tb], dev, fdt).contiguous(),
            to_device(y_test[start:start + tb], dev),
            tb,
        )
        state = step(state, xb, yb, mask, x_train, y_train)
    return state


def stream_point_values(
    method: str,
    x_train,
    y_train,
    x_test,
    y_test,
    k: int,
    *,
    test_batch: int = 512,
    fill: Optional[str] = None,
    fill_params: Optional[dict] = None,
    distance: str = "plain",
    method_opts: Optional[dict] = None,
    device="cuda",
) -> torch.Tensor:
    """(n,) per-point values of `method` ("knn_shapley" | "wknn" | "loo"),
    averaged over the test set, on `device`, via the streaming pipeline:
    ceil(t / test_batch) in-place steps, the ragged trailing batch padded
    with a zero validity mask. `distance` defaults to "plain" (the
    counterpart of the reference's deterministic "xla"); "cuda" or "auto"
    takes the CUDA distance kernel on a card. `fill="megakernel"` routes
    every step through the fused kernel."""
    spec = accumulator_spec(method)
    if spec.kind != "point":
        raise ValueError(
            f"method {method!r} streams {spec.kind} state, not point "
            f"values; use fused_sti_knn_interactions / a ValuationSession "
            f"for interaction methods"
        )
    dev = resolve_device(device)
    x_train, y_train, fdt, t = _prepare_operands(
        x_train, y_train, x_test, k, dev, fill)
    n, d = x_train.shape
    tb = max(1, min(int(test_batch), t))
    step, _, spec = prepare_stream_step(
        method, n, d, k, test_batch=tb, fill=fill or "auto",
        fill_params=fill_params, distance=distance, method_opts=method_opts,
        device=dev,
    )
    state = _stream(step, spec.init(n, dev), x_test, y_test, tb, dev, fdt,
                    x_train, y_train)
    return spec.result_arrays(state, t)["point_values"]


def interaction_state_from_numpy(acc, diag, device="cuda"
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """A mid-stream (acc, diag) state taken as numpy arrays -- for example
    from the JAX fused step -> the port's f32 state tensors on `device`,
    ready for further in-place steps."""
    dev = resolve_device(device)
    acc = torch.from_numpy(np.array(acc, dtype=np.float32, copy=True))
    diag = torch.from_numpy(np.array(diag, dtype=np.float32, copy=True))
    n = diag.shape[0]
    if acc.shape != (n, n):
        raise ValueError(
            f"acc must be ({n}, {n}) to match diag, got {tuple(acc.shape)}"
        )
    return acc.to(dev).contiguous(), diag.to(dev).contiguous()


def fused_sti_knn_interactions(
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
    distance: str = "auto",
    autotune: bool = False,
    device="cuda",
) -> torch.Tensor:
    """STI-KNN via the fused streaming pipeline: the (n, n) matrix on
    `device`, diagonal = main terms.

    Streams ceil(t / test_batch) steps; a trailing partial batch is padded
    with a zero validity mask. Each batch is moved to `device` as it is
    consumed, so the test set may stay on the host. Features are cast to
    the dtype `_feature_dtype` names and made contiguous on the way.
    Finalize divides the accumulator in place."""
    dev = resolve_device(device)
    x_train, y_train, fdt, t = _prepare_operands(
        x_train, y_train, x_test, k, dev, fill)
    n, d = x_train.shape
    tb = max(1, min(int(test_batch), t))
    step, _ = prepare_fused_step(
        n, d, k, mode=mode, test_batch=tb, fill=fill, fill_params=fill_params,
        distance=distance, autotune=autotune, device=dev,
    )
    state = _stream(_tuple_state(step), INTERACTION_STATE.init(n, dev),
                    x_test, y_test, tb, dev, fdt, x_train, y_train)
    return INTERACTION_STATE.result_arrays(state, t)["phi"]


# ------------------------------------------------------------------- approx
# engine="approx": the steps below swap the dense (tb, n) distance row for
# the LSH candidate stage (`repro_torch.kernels.ann.topm_candidates`), run
# the per-method recurrences on the (tb, m) candidate vectors (sorted by
# exact distance, so candidate position == sorted coordinate), and land
# the results sparsely: a deterministic scatter for the (n,) point
# vectors, flattened COO triplets for the interaction pairs, merged on the
# host by `ApproxPairAccumulator`, so n = 10^6 stores only pairs that ever
# co-occur in a candidate set. Each step also runs the recall probe on its
# first `probe` rows; the measured matched prefix feeds the certified
# bounds of `repro_torch.core.approx`. Every operation here is plain
# PyTorch on the device (the reference's are XLA, no Pallas kernel);
# the probe's exact rows take the distance kernel on a card.


def _probe_stats(probe: int, probe_k: int) -> Callable:
    """Bind the in-step recall probe: `run(cand, xb, x_train)` returns the
    (min(probe, tb),) matched-prefix and recall rows of
    `repro_torch.kernels.ann.matched_prefix_and_recall` (empty tensors
    when probing is off). Probing the FIRST rows is sound because
    `pad_test_batch` puts the real test points first."""
    from repro_torch.kernels.ann import matched_prefix_and_recall

    def run(cand, xb, x_train):
        s = min(int(probe), cand.shape[0])
        if s <= 0:
            return (torch.zeros((0,), dtype=torch.int32, device=xb.device),
                    torch.zeros((0,), dtype=torch.float32, device=xb.device))
        return matched_prefix_and_recall(cand[:s], xb[:s], x_train,
                                         int(probe_k))

    return run


@functools.lru_cache(maxsize=None)
def make_approx_point_step(method: str, k: int, n: int, m: int, window: int,
                           probe: int = 0, probe_k: int = 0,
                           method_static: tuple = ()) -> Callable:
    """The approx step of a point-value method:

        step(vec, xb, yb, mask, x_train, y_train, tables)
            -> (vec, prefix, recall)

    vec (n,) f32 accumulates the scattered candidate values in place;
    `tables` is the `LSHTables` the session built once per train set. Per
    batch: top-m candidates -> label match -> candidate-space recurrence
    (`stream_kernels.make_approx_values`) -> deterministic O(tb m)
    scatter, plus the `probe`-row recall probe. Cached per static
    configuration."""
    from repro_torch.kernels.ann import full_mean_sq_dist, topm_candidates
    from repro_torch.kernels.stream_kernels import (
        make_approx_values, scatter_point_update)

    values_fn = make_approx_values(method, k, opts=dict(method_static))
    probe_fn = _probe_stats(probe, probe_k)
    m, window = int(m), int(window)

    def step(vec, xb, yb, mask, x_train, y_train, tables):
        cand, d2m, valid = topm_candidates(xb, x_train, tables, m, window)
        match = (y_train[cand] == yb[:, None]).to(torch.float32)
        sigma2 = full_mean_sq_dist(xb, tables)
        vals = values_fn(d2m, match, valid, mask, sigma2)
        scatter_point_update(vec, cand, vals, valid)
        prefix, recall = probe_fn(cand, xb, x_train)
        return vec, prefix, recall

    return step


@functools.lru_cache(maxsize=None)
def make_approx_interaction_step(mode: InteractionMode, k: int, n: int,
                                 m: int, window: int, probe: int = 0,
                                 probe_k: int = 0) -> Callable:
    """The approx step of "sti"/"sii":

        step(diag, xb, yb, mask, x_train, y_train, tables)
            -> (diag, rows, cols, vals, prefix, recall)

    The DIAGONAL (paper Eq. 4: the mean of u, a label comparison) is
    accumulated exactly and densely into diag in place, by the same
    (tb, n) reduction as the exact step, so it keeps the exact engine's
    bits. The off-diagonal pairs run the truncated recurrence
    (`superdiagonal_g_topm`) on the (tb, m) candidate vector and come back
    as flattened (tb m^2,) COO triplets: pair value g[max(pos_a, pos_b)]
    over candidate positions, padded rows, invalid slots and the diagonal
    redirected to row index n (the host accumulator drops them). Peak
    step memory is O(tb m^2 + tb n). Cached per static configuration."""
    from repro_torch.core.sti_knn import superdiagonal_g_topm
    from repro_torch.kernels.ann import topm_candidates

    probe_fn = _probe_stats(probe, probe_k)
    n, m, window = int(n), int(m), int(window)

    def step(diag, xb, yb, mask, x_train, y_train, tables):
        cand, d2m, valid = topm_candidates(xb, x_train, tables, m, window)
        match = (y_train[cand] == yb[:, None]).to(torch.float32)
        u = match * valid * (mask / k)[:, None]
        g = superdiagonal_g_topm(u, k, n, mode=mode)             # (tb, m)
        pos = torch.arange(m, device=xb.device)
        gm = g[:, torch.maximum(pos[:, None], pos[None, :])]     # (tb, m, m)
        ok = ((valid[:, :, None] > 0) & (valid[:, None, :] > 0)
              & (pos[:, None] != pos[None, :])[None, :, :]
              & (mask > 0)[:, None, None])
        rows = torch.where(ok, cand[:, :, None], n)
        cols = torch.where(ok, cand[:, None, :], n)
        vals = torch.where(ok, gm, 0.0)
        # the exact dense diagonal: the mean-of-u main terms need only the
        # labels; u in train coordinates, as the exact step gathers it
        dm = (y_train[None, :] == yb[:, None]).to(torch.float32)
        diag.add_((dm * (mask / k)[:, None]).sum(0))
        prefix, recall = probe_fn(cand, xb, x_train)
        return (diag, rows.reshape(-1), cols.reshape(-1), vals.reshape(-1),
                prefix, recall)

    return step


class ApproxPairAccumulator:
    """Host-side deterministic COO accumulator of approx interactions.

    Each approx interaction step emits (tb m^2,) flattened (row, col, val)
    triplets; this class merges them into a sorted unique key list (key =
    row * n + col, int64) with `np.unique` + `np.add.at` -- a sequential,
    order-stable reduction, so two identical runs (and a checkpoint /
    restore) give bit-identical sparse states. Memory is O(pairs that ever
    co-occur in a candidate set): STI at n = 10^6 never holds an (n, n)
    accumulator until `to_dense`."""

    def __init__(self, n: int):
        """Empty accumulator for an n-point training set."""
        self.n = int(n)
        self._keys = np.zeros((0,), np.int64)
        self._vals = np.zeros((0,), np.float32)

    @property
    def nnz(self) -> int:
        """Number of distinct off-diagonal pairs stored so far."""
        return int(self._keys.shape[0])

    def add(self, rows, cols, vals) -> None:
        """Merge one step's flattened triplets (numpy arrays or tensors);
        entries with row >= n (the step's invalid/diagonal redirect) are
        dropped."""
        rows, cols, vals = (np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                       else a) for a in (rows, cols, vals))
        vals = vals.astype(np.float32, copy=False)
        keep = rows < self.n
        new = rows[keep].astype(np.int64) * self.n + cols[keep].astype(
            np.int64)
        keys = np.concatenate([self._keys, new])
        allv = np.concatenate([self._vals, vals[keep]])
        uniq, inv = np.unique(keys, return_inverse=True)
        acc = np.zeros(uniq.shape[0], np.float32)
        np.add.at(acc, inv.reshape(-1), allv)
        self._keys, self._vals = uniq, acc

    def state(self) -> tuple:
        """(keys, vals) checkpoint arrays (sorted int64 keys, f32 sums)."""
        return self._keys.copy(), self._vals.copy()

    def load(self, keys, vals) -> None:
        """Restore from `state()` arrays (checkpoint resume)."""
        self._keys = np.asarray(keys, np.int64).copy()
        self._vals = np.asarray(vals, np.float32).copy()

    def to_dense(self, diag: torch.Tensor, t: int) -> torch.Tensor:
        """The (n, n) f32 interaction matrix on diag's device: off-diagonal
        sums / t at their keys and the exactly accumulated diag / t on the
        main diagonal (the finalize rule of `AccumulatorSpec.
        result_arrays`). The division is the same IEEE f32 division as the
        reference's numpy one, so the bits agree."""
        dev = diag.device
        phi = torch.zeros((self.n, self.n), dtype=torch.float32, device=dev)
        keys = torch.from_numpy(self._keys).to(dev)
        phi.view(-1)[keys] = torch.from_numpy(self._vals).to(dev) / t
        phi.diagonal().copy_(diag / t)
        return phi


# ------------------------------------------------------------------ sharded
@functools.lru_cache(maxsize=None)
def make_sharded_step(
    group,
    k: int,
    mode: InteractionMode = "sti",
    fill: str = "chunked",
    fill_static: tuple = (),
    distance: str = "plain",
) -> Callable:
    """Build the sharded interaction step over the D shards of `group`
    (a `repro_torch.distributed.sharding.ShardGroup`):

        step(acc, diag, xb, yb, mask, x_train, y_train) -> (acc, diag)

    with every argument a per-shard list: acc[i] is shard i's (n/D, n) row
    block and diag[i] its (n/D,) rows, both updated in place; xb/yb/mask[i]
    its (tb/D, ...) slice of the test batch (tb a multiple of D;
    `prepare_sharded_step` rounds it up and the mask absorbs the padding);
    x_train/y_train[i] the train set on its device. Per step:

      1. distance/rank/g on each shard's (tb/D, n) test slice;
      2. an all-gather of the small (tb, n) g/rank tables and a
         reduce-scatter of the (n,) diag partials (the only collectives,
         O(tb n) bytes, never O(n^2));
      3. a rectangular fill of each row block with ALL tb test points
         through the rect fill registry (`fill`/`fill_static` name a
         rectangular variant: the CUDA rect kernel on a card, the chunked
         scan on the CPU).

    `fill="megakernel"` instead all-gathers the (tb, d) test batch and
    runs ONE launch of the fused kernel per shard on its row block, with
    `row_offset = i * n/D`: each shard re-ranks the whole batch, and the
    collectives carry O(tb d) bytes instead of O(tb n). Cached per static
    configuration."""
    if fill == "megakernel":
        from repro_torch.kernels.sti_megakernel import sti_megakernel_cuda

        params = dict(fill_static)

        def mega_step(acc, diag, xb, yb, mask, x_train, y_train):
            xb_all = group.all_gather(xb)
            yb_all = group.all_gather(yb)
            mask_all = group.all_gather(mask)
            for i in range(group.size):
                nl = acc[i].shape[0]
                sti_megakernel_cuda(
                    acc[i], diag[i], xb_all[i], yb_all[i], mask_all[i],
                    x_train[i], y_train[i], k=int(k), mode=mode,
                    row_offset=i * nl, **params)
            return acc, diag

        return mega_step
    body = _stream_body(
        make_update_kernel(mode, k, fill=fill, fill_static=fill_static,
                           axis=group),
        int(k), _distance_fn(distance), sharded=True,
    )

    def step(acc, diag, xb, yb, mask, x_train, y_train):
        return body((acc, diag), xb, yb, mask, x_train, y_train)

    return step


@functools.lru_cache(maxsize=None)
def make_sharded_point_step(
    group,
    method: str,
    k: int,
    method_static: tuple = (),
    distance: str = "plain",
    fill: Optional[str] = None,
    fill_static: tuple = (),
) -> Callable:
    """Sharded form of `make_point_step` over the shards of `group`:

        step(vec, xb, yb, mask, x_train, y_train) -> vec

    with vec[i] shard i's (n/D,) rows, updated in place, and the other
    arguments per-shard lists as in `make_sharded_step`. Each shard
    computes values on its (tb/D, n) test slice; ONE reduce-scatter of
    the (n,) partials lands block i on shard i. No O(n^2) state and no
    O(tb n) gather: point methods need no cross-shard rank tables.

    `fill="megakernel"` all-gathers the (tb, d) test batch and runs one
    launch of the fused point kernel per shard on its (n/D,) rows with
    `row_offset = i * n/D`; the reduce-scatter disappears because every
    shard folds the whole batch."""
    if fill == "megakernel":
        from repro_torch.kernels.sti_megakernel import point_megakernel_cuda

        params = dict(fill_static)
        opts = dict(method_static)

        def mega_step(vec, xb, yb, mask, x_train, y_train):
            xb_all = group.all_gather(xb)
            yb_all = group.all_gather(yb)
            mask_all = group.all_gather(mask)
            for i in range(group.size):
                nl = vec[i].shape[0]
                point_megakernel_cuda(
                    vec[i], xb_all[i], yb_all[i], mask_all[i], x_train[i],
                    y_train[i], method=method, k=int(k), opts=opts,
                    row_offset=i * nl, **params)
            return vec

        return mega_step
    body = _stream_body(
        make_update_kernel(method, k, opts=dict(method_static), axis=group),
        int(k), _distance_fn(distance), sharded=True,
    )

    def step(vec, xb, yb, mask, x_train, y_train):
        return body((vec,), xb, yb, mask, x_train, y_train)[0]

    return step


def _shard_group(n: int, shards: Optional[int], devices):
    """The `ShardGroup` of a sharded run: over `devices` when given (every
    entry one shard, repeats allowed), else over the first
    `shard_count(n, shards)` local cards. Raises unless n divides into
    the shard count."""
    from repro_torch.distributed.sharding import (
        ShardGroup, shard_count, valuation_devices)

    if devices is None:
        devices = valuation_devices(shard_count(n, shards))
    group = ShardGroup(tuple(resolve_device(d) for d in devices))
    if n % group.size:
        raise ValueError(
            f"n={n} must divide evenly into {group.size} row shards "
            f"(the per-shard blocks are exactly (n/D, n))"
        )
    return group


def prepare_sharded_step(
    n: int,
    d: int,
    k: int,
    *,
    devices=None,
    shards: Optional[int] = None,
    mode: InteractionMode = "sti",
    test_batch: int = 256,
    fill: str = "auto",
    fill_params: Optional[dict] = None,
    distance: str = "auto",
    autotune: bool = False,
) -> tuple[Callable, dict, object]:
    """Resolve the shard group, fill and distance of the sharded engine and
    return `(step, resolved, group)`. `resolved` names the concrete
    implementations plus {"shards", "test_batch"}: test_batch rounded UP
    to a multiple of the shard count, so every shard gets an equal test
    slice (the mask absorbs the difference).

    The row-block update resolves against the RECTANGULAR fill registry
    (`core.sti_knn.resolve_rect_fill`) at the per-shard (n/D, n) block
    shape, and is reported under a `rect_` name ("rect_cuda",
    "rect_chunked"); "megakernel" keeps its own name."""
    group = _shard_group(n, shards, devices)
    num = group.size
    backend = group.devices[0].type
    tb = -(-max(1, int(test_batch)) // num) * num
    mega = _resolve_megakernel(fill, fill_params)
    if mega is not None:
        step = make_sharded_step(group, int(k), mode, "megakernel", mega)
        return step, {"fill": "megakernel", "fill_params": dict(mega),
                      "distance": "fused", "shards": num,
                      "test_batch": tb}, group
    # the fill sees the (n/D, n) row block and ALL tb gathered test
    # points; the distance stage runs on (tb/D, n) slices
    fill_name, fill_static = resolve_rect_fill(
        fill, n // num, n, tb, fill_params=fill_params, backend=backend,
        autotune=autotune)
    dist_name = resolve_distance(distance, tb // num, n, d, backend=backend,
                                 autotune=autotune)
    step = make_sharded_step(group, int(k), mode, fill_name, fill_static,
                             dist_name)
    resolved = {
        # rect_ prefix: the name lives in the rectangular fill registry,
        # not the square one (a session restore re-resolves such names)
        "fill": f"rect_{fill_name}",
        "fill_params": dict(fill_static),
        "distance": dist_name,
        "shards": num,
        "test_batch": tb,
    }
    return step, resolved, group


def prepare_sharded_stream_step(
    method: str,
    n: int,
    d: int,
    k: int,
    *,
    devices=None,
    shards: Optional[int] = None,
    test_batch: int = 256,
    fill: str = "auto",
    fill_params: Optional[dict] = None,
    distance: str = "auto",
    autotune: bool = False,
    method_opts: Optional[dict] = None,
) -> tuple[Callable, dict, object, AccumulatorSpec]:
    """Method-generic form of `prepare_sharded_step`: `(step, resolved,
    group, spec)` with the tuple-state contract of `prepare_stream_step`,
    where each state entry is a per-shard list of row blocks
    (`spec.init_shards`). Interaction methods route through the
    rectangular fill registry; point methods build the reduce-scatter
    vector step and report resolved["fill"] = None (or "megakernel")."""
    spec = accumulator_spec(method)
    if spec.kind == "interaction":
        inner, resolved, group = prepare_sharded_step(
            n, d, k, devices=devices, shards=shards, mode=method,
            test_batch=test_batch, fill=fill, fill_params=fill_params,
            distance=distance, autotune=autotune,
        )
        return _tuple_state(inner), resolved, group, spec
    group = _shard_group(n, shards, devices)
    num = group.size
    tb = -(-max(1, int(test_batch)) // num) * num
    mega = _resolve_megakernel(fill, fill_params)
    if mega is not None:
        inner = make_sharded_point_step(
            group, method, int(k), _method_static(method_opts),
            fill="megakernel", fill_static=mega)
        return (_vector_state(inner),
                {"fill": "megakernel", "distance": "fused", "shards": num,
                 "test_batch": tb}, group, spec)
    dist_name = resolve_distance(distance, tb // num, n, d,
                                 backend=group.devices[0].type,
                                 autotune=autotune)
    inner = make_sharded_point_step(group, method, int(k),
                                    _method_static(method_opts), dist_name)
    return (_vector_state(inner),
            {"fill": None, "distance": dist_name, "shards": num,
             "test_batch": tb}, group, spec)


def sharded_sti_knn_interactions(
    x_train,
    y_train,
    x_test,
    y_test,
    k: int,
    *,
    mode: InteractionMode = "sti",
    test_batch: int = 256,
    shards: Optional[int] = None,
    devices=None,
    fill: str = "auto",
    fill_params: Optional[dict] = None,
    distance: str = "auto",
    autotune: bool = False,
    device="cuda",
    return_info: bool = False,
):
    """STI-KNN on the sharded pipeline; the result contract of
    `sti_knn_interactions`, phi on the first shard's device. Falls back
    to the single-device step on `device` when only one shard is usable
    (one card, shards=1, or a one-entry device list); `device` is unused
    when `devices` is given. With
    `return_info=True` returns `(phi, info)`, info naming the resolved
    implementations, the shard count and the test batch.

    A thin wrapper: it drives a `ShardedValuationSession` over the whole
    test set, so placement, padding and finalize live in the session."""
    if k < 1:
        raise ValueError("k must be >= 1")
    t = int(x_test.shape[0])
    if t < 1:
        raise ValueError("need at least one test point")
    if x_test.ndim != 2:
        raise ValueError("features must be (num_points, dim)")
    from repro_torch.core.session import ShardedValuationSession

    sess = ShardedValuationSession(
        x_train, y_train, shards=shards, devices=devices, k=k, mode=mode,
        test_batch=max(1, min(int(test_batch), t)), fill=fill,
        fill_params=fill_params, distance=distance, autotune=autotune,
        device=device,
    )
    phi = sess.update(x_test, y_test).finalize().phi
    if return_info:
        info = dict(sess._resolved)
        info.setdefault("shards", sess.shards)
        info.setdefault("test_batch", sess.test_batch)
        return phi, info
    return phi
