"""Accumulator specs and update kernels of the streaming valuation step.

Counterpart of `repro.kernels.stream_kernels`, for the interaction methods
("sti", "sii") on one device. The part of the streaming step that differs
between valuation methods lives in two small objects:

  * `AccumulatorSpec` -- the shape/dtype contract of a method's running
    state: an (n, n) f32 matrix plus an (n,) f32 diagonal for the
    interaction methods. It owns init and the finalize (divide-by-t) rule.
  * `UpdateKernel` -- the per-method functions the generic step calls:
    `contrib(d2, order, match, mask) -> u` (the sorted-coordinate
    contribution with the validity mask folded in, so padded test rows
    contribute exactly zero) and `update(state, u, g, ranks, mask) ->
    state`, which updates the state tensors IN PLACE (the JAX step donates
    them instead).

Kernels are built by registered factories keyed by method name. The point
methods and the sharded (`axis`) variant come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.sti_knn import accumulate_fill

__all__ = [
    "AccumulatorSpec",
    "UpdateKernel",
    "INTERACTION_STATE",
    "register_update_kernel",
    "make_update_kernel",
    "accumulator_spec",
]


@dataclasses.dataclass(frozen=True)
class AccumulatorSpec:
    """Shape/dtype contract of one method family's running state.

    `names` are the checkpoint array names; `layouts` name each array's
    shape: "matrix" = (n, n), "vector" = (n,)."""

    kind: str                    # "interaction" (point: a later slice)
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

    def result_arrays(self, state: tuple, t: int) -> dict:
        """Finalize a state of t accumulated test points into the
        `ValuationResult` array kwargs, {"phi": acc / t with diag / t on
        the diagonal}. The division is IN PLACE on `acc` (at n = 65536 a
        copy would be a second 16 GiB), so `state` is consumed."""
        acc, diag = state
        phi = acc.div_(t)
        phi.diagonal().copy_(diag / t)
        return {"phi": phi}


INTERACTION_STATE = AccumulatorSpec(
    "interaction", ("acc", "diag"), ("matrix", "vector")
)


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


def _registered(method: str) -> tuple[AccumulatorSpec, Callable]:
    if method not in _KERNEL_FACTORIES:
        raise ValueError(
            f"no streaming kernel for method {method!r}; registered: "
            f"{sorted(_KERNEL_FACTORIES)}"
        )
    return _KERNEL_FACTORIES[method]


def make_update_kernel(
    method: str,
    k: int,
    *,
    opts: Optional[dict] = None,
    fill: Optional[str] = None,
    fill_static: tuple = (),
    axis: Optional[str] = None,
) -> UpdateKernel:
    """Build the bound `UpdateKernel` for `method` with the resolved fill
    `fill` / `fill_static`. `axis` must be None in this slice."""
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
        if axis is not None:
            raise NotImplementedError(
                "the sharded interaction update is not ported yet"
            )

        def contrib(d2, order, match, mask):
            return match * (mask / k)[:, None]

        def update(state, u, g, ranks, mask):
            acc, diag = state
            accumulate_fill(acc, g, ranks, fill, fill_static)
            # u in train coordinates is u[p, ranks[p, i]] =
            # mask_p 1[y_i==y_p]/k: the diag term rides on the fill
            # stage's u, masked for free.
            diag.add_(torch.gather(u, 1, ranks).sum(0))
            return (acc, diag)

        return UpdateKernel(method, INTERACTION_STATE, True, mode,
                            contrib, update)

    return factory


register_update_kernel("sti", INTERACTION_STATE, _interaction_factory("sti"))
register_update_kernel("sii", INTERACTION_STATE, _interaction_factory("sii"))
