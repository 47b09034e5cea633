"""High-level data-valuation API: `DataValuator`.

Counterpart of `repro.core.valuation.DataValuator`, a thin wrapper over
the valuation method registry (`repro_torch.core.methods`): `run()`
returns the full `ValuationResult`, the legacy accessors
(`interaction_matrix`, `shapley_values`, `loo`) return bare tensors, and
`session()` opens a streaming session -- a `ShardedValuationSession` when
the valuator's engine is "sharded", an `ApproxValuationSession` when it
is "approx" -- and `autotune()` pre-tunes the fill and distance into the
tuning cache. New code should use
`get_method(name)(...)` and the sessions directly.

`make_sti_step_fn` and `distributed_sti_step` are the unit of work of a
production step: the whole test set in one call, partial sums not yet
divided by t, on one device or spread over a ("data", "model") device
grid.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core.methods import ENGINES, get_method
from repro_torch.core.results import ValuationResult
from repro_torch.core.session import ValuationSession
from repro_torch.device import resolve_device, to_device

__all__ = ["DataValuator", "make_sti_step_fn", "distributed_sti_step"]


@dataclass
class DataValuator:
    """Valuation front-end over the method registry.

    Args:
      k: KNN parameter.
      embed_fn: optional feature extractor applied to raw inputs before the
        KNN (the paper's pre-trained-backbone pattern). None = identity.
      mode: name of a registered valuation method; "sti" and "sii" produce
        interaction matrices.
      test_batch, fill: defaults passed to every run and session.
      engine: an engine of the method's `ENGINES` row; None = the method's
        own default. "sharded" makes `session()` open a
        `ShardedValuationSession`, "approx" an `ApproxValuationSession`.
      device: where runs and sessions go ("cuda" unless "cpu" is asked
        for).
    """

    k: int = 5
    embed_fn: Optional[Callable] = None
    mode: str = "sti"
    test_batch: int = 256
    fill: str = "auto"
    engine: Optional[str] = None
    device: str = "cuda"

    def __post_init__(self):
        # fail at construction: unknown method / engine names give the
        # registered alternatives up front
        get_method(self.mode)
        engines = ENGINES.get(self.mode)
        if (self.engine is not None and engines is not None
                and self.engine not in engines):
            raise ValueError(
                f"unknown engine {self.engine!r} for method {self.mode!r}; "
                f"choose from {engines}"
            )
        if self.k < 1:
            raise ValueError("k must be >= 1")

    def _embed(self, x):
        return x if self.embed_fn is None else self.embed_fn(x)

    def run(self, x_train, y_train, x_test, y_test, *,
            method: Optional[str] = None, **opts) -> ValuationResult:
        """Run a registered method (default: this valuator's `mode`) on the
        embedded features and return the full `ValuationResult`."""
        m = get_method(method or self.mode)
        accepted = getattr(m, "accepted_options", frozenset())
        defaults = {"fill": self.fill, "test_batch": self.test_batch,
                    "device": self.device}
        if self.engine is not None:
            defaults["engine"] = self.engine
        for name, value in defaults.items():
            if name not in accepted:
                continue
            if name == "engine":
                # the valuator's engine is a default, not a mandate: an
                # interaction engine must not leak into a point method
                # (and vice versa) when run(method=...) crosses families
                engines = ENGINES.get(getattr(m, "name", method or self.mode))
                if engines is not None and value not in engines:
                    continue
            opts.setdefault(name, value)
        return m(
            self._embed(x_train), y_train, self._embed(x_test), y_test,
            k=self.k, **opts,
        )

    def session(self, x_train, y_train, **opts) -> ValuationSession:
        """Open a streaming `ValuationSession` against this training set
        (a `ShardedValuationSession` when this valuator's engine is
        "sharded" -- pass `shards=` or `devices=` to pin the shards)."""
        opts.setdefault("k", self.k)
        opts.setdefault("mode", self.mode)
        opts.setdefault("test_batch", self.test_batch)
        opts.setdefault("fill", self.fill)
        opts.setdefault("embed_fn", self.embed_fn)
        if self.engine == "sharded":
            from repro_torch.core.session import ShardedValuationSession

            if "devices" not in opts:
                opts.setdefault("device", self.device)
            return ShardedValuationSession(x_train, y_train, **opts)
        if "shards" in opts or "devices" in opts:
            raise ValueError(
                "shards= and devices= require DataValuator(engine='sharded')"
            )
        opts.setdefault("device", self.device)
        if self.engine == "approx":
            from repro_torch.core.session import ApproxValuationSession

            return ApproxValuationSession(x_train, y_train, **opts)
        return ValuationSession(x_train, y_train, **opts)

    def interaction_matrix(self, x_train, y_train, x_test, y_test, *,
                           autotune: bool = False):
        """The (n, n) interaction matrix of this valuator's method
        (`autotune=True` tunes what "auto" finds missing from the tuning
        cache first)."""
        return self.run(x_train, y_train, x_test, y_test, autotune=autotune
                        ).interaction_matrix()

    def autotune(self, n: int, t: int, d: Optional[int] = None
                 ) -> tuple[str, dict]:
        """Pre-tune the fill (and, given the feature dim `d`, the distance)
        for an (n, t) problem on this valuator's device; the winners
        persist in the tuning cache (`repro_torch.kernels.autotune`), so
        later "auto" runs in any process pick them up. Pass the per-call
        test batch as `t` when streaming. Returns the fill winner."""
        from repro_torch.device import resolve_device
        from repro_torch.kernels.autotune import (
            autotune_distance, autotune_fill)

        backend = resolve_device(self.device).type
        if d is not None:
            autotune_distance(t, n, d, backend=backend)
        return autotune_fill(n, t, backend=backend)

    def shapley_values(self, x_train, y_train, x_test, y_test):
        """KNN-Shapley values of the train points."""
        return self.run(
            x_train, y_train, x_test, y_test, method="knn_shapley"
        ).values()

    def loo(self, x_train, y_train, x_test, y_test):
        """Leave-one-out values of the train points."""
        return self.run(x_train, y_train, x_test, y_test,
                        method="loo").values()


def _sti_step_local(x_train, y_train, x_test, y_test, k: int, mode: str):
    """One fully batched STI-KNN accumulation step, no streaming: the
    distance kernel, a stable sort, ranks, u and g, then the square fill
    kernel on a zeroed (n, n) accumulator (the reference takes a vmap over
    a (t, n, n) gather). Tensors on one device.

    Returns (phi_sum (n, n) f32, diag_sum (n,) f32), NOT yet divided by t,
    so partial results from test shards combine by addition."""
    from repro_torch.core.sti_knn import ranks_from_order, superdiagonal_g
    from repro_torch.kernels.distance import distance_cuda
    from repro_torch.kernels.sti_fill import sti_fill_acc_cuda

    d2 = distance_cuda(x_test, x_train)
    order = torch.sort(d2, dim=-1, stable=True).indices
    ranks = ranks_from_order(order)
    u = (y_train[order] == y_test[:, None]).to(torch.float32) / k
    g = superdiagonal_g(u, k, mode=mode)
    n = x_train.shape[0]
    phi_sum = sti_fill_acc_cuda(
        torch.zeros((n, n), dtype=torch.float32, device=x_train.device),
        g, ranks)
    diag_sum = torch.sum(
        (y_train[None, :] == y_test[:, None]).to(torch.float32) / k, 0)
    return phi_sum, diag_sum


def _features(dev, *arrays):
    """(x_train, y_train, x_test, y_test) on `dev`, features f32 and
    contiguous."""
    x_train, y_train, x_test, y_test = arrays
    return (to_device(x_train, dev, torch.float32).contiguous(),
            to_device(y_train, dev),
            to_device(x_test, dev, torch.float32).contiguous(),
            to_device(y_test, dev))


def make_sti_step_fn(k: int, mode: str = "sti", device="cuda") -> Callable:
    """The valuation step as one call on `device`:
    step(x_train, y_train, x_test, y_test) -> (phi_sum, diag_sum), the
    sums of `_sti_step_local` over the whole test set (a production caller
    runs it per test shard and adds the results)."""
    dev = resolve_device(device)

    def step(x_train, y_train, x_test, y_test):
        return _sti_step_local(*_features(dev, x_train, y_train, x_test,
                                          y_test), int(k), mode)

    return step


def distributed_sti_step(grid, k: int, mode: str = "sti") -> Callable:
    """The step of `make_sti_step_fn` spread over a ("data", "model")
    `DeviceGrid` (`repro_torch.distributed.sharding`): the test points
    split over the data shards, phi in column blocks over the model shards
    (`launch.specs.sti_cell`, one distance and one rect fill launch per
    cell). step(x_train, y_train, x_test, y_test) -> (phi_sum, diag_sum),
    gathered on the grid's first device, not yet divided by t. Where every
    model shard of data row 0 lives on that device the cells sum straight
    into the row blocks of the gathered phi, so it is never held twice.
    Raises unless t splits over the data shards and n over the model
    shards."""
    from repro_torch.configs.sti_knn_paper import STIConfig
    from repro_torch.launch.specs import sti_cell

    def step(x_train, y_train, x_test, y_test):
        dev0 = grid.devices[0]
        x_train, y_train, x_test, y_test = _features(
            dev0, x_train, y_train, x_test, y_test)
        (n, d), t = x_train.shape, x_test.shape[0]
        scfg = STIConfig(n_train=n, feat_dim=d, k=int(k), test_chunk=t,
                         mode=mode)
        cell = sti_cell(scfg, grid)[0]
        m = grid.shape[1]
        if all(grid.device(0, j) == dev0 for j in range(m)):
            phi = torch.zeros((n, n), dtype=torch.float32, device=dev0)
            _, diag = cell(x_train, y_train, x_test, y_test,
                           out=list(torch.split(phi, n // m)))
            return phi, diag
        acc, diag = cell(x_train, y_train, x_test, y_test)
        # phi is symmetric: the gathered column blocks are the row blocks
        return torch.cat([a.T.to(dev0) for a in acc]), diag

    return step
