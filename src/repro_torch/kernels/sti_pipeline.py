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
contribution exactly.

`fill="megakernel"` swaps the whole step for ONE launch of the fused
kernel (`repro_torch.kernels.sti_megakernel`): distance, stable sort,
tables and update in a single cooperative CUDA kernel on a card, its
plain version on the CPU.

    from repro_torch.kernels.sti_pipeline import fused_sti_knn_interactions
    phi = fused_sti_knn_interactions(x_train, y_train, x_test, y_test, k=5)

`prepare_stream_step` is the method-generic front door (tuple-state
contract) that `ValuationSession` drives; `stream_point_values` the
one-shot entry point of the point methods.
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
    superdiagonal_g,
)
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels.stream_kernels import (
    INTERACTION_STATE,
    AccumulatorSpec,
    UpdateKernel,
    accumulator_spec,
    make_update_kernel,
)

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
]

_DISTANCES = ("plain", "cuda")


def resolve_distance(
    distance: str, t: int, n: int, d: int, *, backend: str = "cuda"
) -> str:
    """Resolve "auto" | "plain" | "cuda" to a distance implementation name.
    "auto" takes the heuristic of `autotune.best_distance` for
    `backend`."""
    if distance == "auto":
        from repro_torch.kernels.autotune import best_distance

        distance, _ = best_distance(t, n, d, backend=backend)
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


def _stream_body(kernel: UpdateKernel, k: int, dist_fn: Callable) -> Callable:
    """The generic per-batch step body:

        body(state, xb, yb, mask, x_train, y_train) -> state

    distance -> stable sort/rank -> sorted label match -> method
    contribution (mask folded in) -> optional `superdiagonal_g` -> the
    method's update kernel (in place on `state`)."""

    def body(state, xb, yb, mask, x_train, y_train):
        d2 = dist_fn(xb, x_train)                                # (tb, n)
        order = torch.sort(d2, dim=-1, stable=True).indices      # int64
        ranks = ranks_from_order(order)
        match = (y_train[order] == yb[:, None]).to(torch.float32)
        u = kernel.contrib(d2, order, match, mask)
        g = (superdiagonal_g(u, k, mode=kernel.g_mode)
             if kernel.needs_g else None)
        return kernel.update(state, u, g, ranks, mask)

    return body


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


def _resolve_megakernel(fill: str, fill_params: Optional[dict]
                        ) -> Optional[tuple]:
    """The megakernel's static-param tuple when a step should run as the
    fused kernel, else None for the three-stage step. Only
    `fill="megakernel"` selects it: the JAX package's "auto" takes it only
    on a hit in its step-level tuning cache, and the port has no tuning
    cache, so "auto" keeps the three-stage step."""
    if fill != "megakernel":
        return None
    from repro_torch.kernels.sti_megakernel import megakernel_static

    return megakernel_static(fill_params)


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
    device="cuda",
) -> tuple[Callable, dict]:
    """Resolve fill/distance for an (n, d) train set streamed in batches of
    `test_batch` on `device` and return `(step, resolved)` (see
    `make_fused_step`), `resolved` naming the concrete {"fill",
    "distance"} implementations; {"fill": "megakernel", "distance":
    "fused"} for the fused kernel, whose distance runs inside it."""
    backend = resolve_device(device).type
    tb = max(1, int(test_batch))
    mega = _resolve_megakernel(fill, fill_params)
    if mega is not None:
        step = make_fused_step(int(k), mode, "megakernel", mega)
        return step, {"fill": "megakernel", "distance": "fused"}
    fill_name, fill_static = resolve_fill(
        fill, n, tb, fill_params=fill_params, backend=backend
    )
    dist_name = resolve_distance(distance, tb, n, d, backend=backend)
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
    method_opts: Optional[dict] = None,
    device="cuda",
) -> tuple[Callable, dict, AccumulatorSpec]:
    """Method-generic form of `prepare_fused_step`: return `(step,
    resolved, spec)` for ANY registered streaming method, with the uniform
    tuple-state contract

        step(state, xb, yb, mask, x_train, y_train) -> state

    where `state` is `spec.init(n, device)`-shaped ((acc, diag) or
    (vec,)). Point methods have no fill stage (resolved["fill"] is None)
    except `fill="megakernel"`, which routes any method through its fused
    kernel. `method_opts` carries method statics such as the wknn weight
    kind. This is the per-batch unit `ValuationSession` drives."""
    spec = accumulator_spec(method)
    tb = max(1, int(test_batch))
    if spec.kind == "interaction":
        inner, resolved = prepare_fused_step(
            n, d, k, mode=method, test_batch=tb, fill=fill,
            fill_params=fill_params, distance=distance, device=device,
        )
        return _tuple_state(inner), dict(resolved), spec
    mega = _resolve_megakernel(fill, fill_params)
    if mega is not None:
        inner = make_point_step(method, int(k), _method_static(method_opts),
                                fill="megakernel", fill_static=mega)
        return (_vector_state(inner),
                {"fill": "megakernel", "distance": "fused"}, spec)
    backend = resolve_device(device).type
    dist_name = resolve_distance(distance, tb, n, d, backend=backend)
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
        distance=distance, device=dev,
    )
    state = _stream(_tuple_state(step), INTERACTION_STATE.init(n, dev),
                    x_test, y_test, tb, dev, fdt, x_train, y_train)
    return INTERACTION_STATE.result_arrays(state, t)["phi"]
