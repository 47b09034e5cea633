"""Valuation method registry: one protocol, many algorithms, one artifact.

Counterpart of `repro.core.methods` for the methods ported so far:

    method = get_method("sti")
    result = method(x_train, y_train, x_test, y_test, k=5, engine="fused",
                    device="cuda")
    result.values(); result.mislabel_scores(y_train, 2); result.save(path)

The `ENGINES` table maps every method to its ported engines (first entry
= default):

  "sti" / "sii":
    fused   streaming distance -> rank -> g -> fill pipeline, accumulators
            updated in place (the CUDA distance and fill kernels on a card)
    scan    the simple batch loop of `sti_knn_interactions`

Every entry point takes `device=` ("cuda" by default; "cpu" must be asked
for) and raises when a CUDA device is asked for and absent.
"""

from __future__ import annotations

import time
from typing import Optional, Protocol, runtime_checkable

import torch

from repro_torch.core.results import ValuationResult
from repro_torch.device import resolve_device

__all__ = [
    "ValuationMethod",
    "register_method",
    "get_method",
    "list_methods",
    "ENGINES",
]

ENGINES: dict[str, tuple[str, ...]] = {
    "sti": ("fused", "scan"),
    "sii": ("fused", "scan"),
}


@runtime_checkable
class ValuationMethod(Protocol):
    """A named valuation algorithm: arrays in, `ValuationResult` out."""

    name: str

    def __call__(self, x_train, y_train, x_test, y_test, *,
                 k: int = 5, **opts) -> ValuationResult: ...


_METHODS: dict[str, ValuationMethod] = {}


def register_method(name: str, method: ValuationMethod) -> None:
    """Register a valuation method: `method(x_train, y_train, x_test,
    y_test, *, k, **opts)` must return a `ValuationResult`."""
    _METHODS[name] = method


def get_method(name: str) -> ValuationMethod:
    """Resolve a registered valuation method by name; raises ValueError
    naming the registered methods and their engines on a miss."""
    if name not in _METHODS:
        raise ValueError(
            f"unknown valuation method {name!r}; registered: "
            f"{sorted(_METHODS)} (engines per method: "
            f"{ {m: ENGINES[m] for m in sorted(_METHODS) if m in ENGINES} })"
        )
    return _METHODS[name]


def list_methods() -> list[str]:
    """Sorted names of every registered valuation method."""
    return sorted(_METHODS)


def _base_meta(x_train, x_test, k: int, dev: torch.device) -> dict:
    return {
        "k": int(k),
        "n": int(x_train.shape[0]),
        "t": int(x_test.shape[0]),
        "d": int(x_train.shape[1]) if x_train.ndim == 2 else None,
        "backend": dev.type,
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
    }


class _InteractionMethod:
    """"sti" / "sii": the paper's O(t n^2) pair-interaction matrix."""

    accepted_options = frozenset({
        "engine", "test_batch", "fill", "fill_params", "distance", "device",
    })

    def __init__(self, name: str, mode: str):
        self.name = name
        self.mode = mode

    def __call__(self, x_train, y_train, x_test, y_test, *, k: int = 5,
                 engine: str = "fused", test_batch: int = 256,
                 fill: str = "auto", fill_params: Optional[dict] = None,
                 distance: str = "auto", device="cuda") -> ValuationResult:
        if engine not in ENGINES[self.name]:
            raise ValueError(
                f"unknown engine {engine!r} for method {self.name!r}; "
                f"valid engines: {ENGINES[self.name]}"
            )
        dev = resolve_device(device)
        meta = _base_meta(x_train, x_test, k, dev)
        meta.update(method=self.name, mode=self.mode, engine=engine,
                    streamed=engine == "fused")
        tb = max(1, min(int(test_batch), int(x_test.shape[0])))
        t0 = time.perf_counter()
        if engine == "fused":
            from repro_torch.kernels.sti_pipeline import (
                fused_sti_knn_interactions, prepare_fused_step)

            _, resolved = prepare_fused_step(
                x_train.shape[0], x_train.shape[1], k, mode=self.mode,
                test_batch=tb, fill=fill, fill_params=fill_params,
                distance=distance, device=dev,
            )
            phi = fused_sti_knn_interactions(
                x_train, y_train, x_test, y_test, k, mode=self.mode,
                test_batch=test_batch, fill=fill, fill_params=fill_params,
                distance=distance, device=dev,
            )
            meta.update(test_batch=test_batch, **resolved)
        else:  # scan
            from repro_torch.core.sti_knn import (
                resolve_fill, sti_knn_interactions)

            phi = sti_knn_interactions(
                x_train, y_train, x_test, y_test, k, mode=self.mode,
                test_batch=test_batch, fill=fill, fill_params=fill_params,
                device=dev,
            )
            meta.update(
                fill=resolve_fill(fill, x_train.shape[0], tb,
                                  fill_params=fill_params,
                                  backend=dev.type)[0],
                test_batch=test_batch,
            )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        meta["elapsed_s"] = round(time.perf_counter() - t0, 4)
        meta["resolved_fill"] = meta.get("fill")
        return ValuationResult(method=self.name, phi=phi, meta=meta)


register_method("sti", _InteractionMethod("sti", mode="sti"))
register_method("sii", _InteractionMethod("sii", mode="sii"))
