"""The fused streaming valuation step: distance -> rank -> g -> fill.

Counterpart of `repro.kernels.sti_pipeline` (the single-device interaction
engine). Per test batch, `_stream_body` runs the distance (the CUDA kernel
on a card, the plain expansion on the CPU), a stable sort, the rank
inversion, the masked contribution u = match * mask / k,
`superdiagonal_g`, and the method's update kernel, which folds the fill
and the diagonal term into the (n, n) / (n,) accumulators IN PLACE -- the
JAX step donates them instead. A ragged trailing batch is padded to the
batch shape by `pad_test_batch`; the mask zeroes its u, and so its g,
exactly.

    from repro_torch.kernels.sti_pipeline import fused_sti_knn_interactions
    phi = fused_sti_knn_interactions(x_train, y_train, x_test, y_test, k=5)
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
    UpdateKernel,
    make_update_kernel,
)

__all__ = [
    "fused_sti_knn_interactions",
    "make_fused_step",
    "prepare_fused_step",
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


def _feature_dtype(*xs) -> torch.dtype:
    """The dtype the distance kernel takes for these feature sets: bfloat16
    when all of them are bfloat16, float32 otherwise (float64, integer
    and float16 features are cast, as the JAX package's f32 default
    does)."""
    if all(isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
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
    builds the mask). Cached per static configuration."""
    body = _stream_body(
        make_update_kernel(mode, k, fill=fill, fill_static=fill_static),
        int(k), _distance_fn(distance),
    )

    def step(acc, diag, xb, yb, mask, x_train, y_train):
        return body((acc, diag), xb, yb, mask, x_train, y_train)

    return step


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
    "distance"} implementations."""
    backend = resolve_device(device).type
    tb = max(1, int(test_batch))
    fill_name, fill_static = resolve_fill(
        fill, n, tb, fill_params=fill_params, backend=backend
    )
    dist_name = resolve_distance(distance, tb, n, d, backend=backend)
    step = make_fused_step(int(k), mode, fill_name, fill_static, dist_name)
    return step, {"fill": fill_name, "distance": dist_name}


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
    float32 (bfloat16 stays bfloat16) and made contiguous on the way.
    Finalize divides the accumulator in place."""
    dev = resolve_device(device)
    fdt = _feature_dtype(x_train, x_test)
    x_train = to_device(x_train, dev, fdt).contiguous()
    y_train = to_device(y_train, dev)
    if x_train.ndim != 2 or x_test.ndim != 2:
        raise ValueError("features must be (num_points, dim)")
    if k < 1:
        raise ValueError("k must be >= 1")
    n, d = x_train.shape
    t = int(x_test.shape[0])
    if t < 1:
        raise ValueError("need at least one test point")
    tb = max(1, min(int(test_batch), t))
    step, _ = prepare_fused_step(
        n, d, k, mode=mode, test_batch=tb, fill=fill, fill_params=fill_params,
        distance=distance, device=dev,
    )
    state = INTERACTION_STATE.init(n, dev)
    for start in range(0, t, tb):
        xb, yb, mask = pad_test_batch(
            to_device(x_test[start:start + tb], dev, fdt).contiguous(),
            to_device(y_test[start:start + tb], dev),
            tb,
        )
        state = step(*state, xb, yb, mask, x_train, y_train)
    return INTERACTION_STATE.result_arrays(state, t)["phi"]
