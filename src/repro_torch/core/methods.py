"""Valuation method registry: one protocol, many algorithms, one artifact.

Counterpart of `repro.core.methods` for the methods and engines ported so
far:

    method = get_method("sti")
    result = method(x_train, y_train, x_test, y_test, k=5, engine="fused",
                    device="cuda")
    result.values(); result.mislabel_scores(y_train, 2); result.save(path)

The `ENGINES` table maps every method to its ported engines (first entry
= default):

  "sti" / "sii":
    fused     streaming distance -> rank -> g -> fill pipeline,
              accumulators updated in place (the CUDA distance and fill
              kernels on a card; `fill="megakernel"` runs each step as
              one launch of the fused kernel)
    scan      the simple batch loop of `sti_knn_interactions`
    distributed
              the production cell (`launch.specs.sti_cell`) over a
              ("data", "model") device grid: test points split over the
              data shards, phi column blocks over the model shards, one
              distance and one rect fill launch per cell, one sum over
              the data shards (`mesh=`, default `make_local_mesh(device)`)
    sharded   the fused pipeline over D shards, (n/D, n) row blocks of
              the accumulator filled by the CUDA rect kernel on a card
              (`fill="megakernel"`: one fused launch per shard a step)
    approx    LSH top-m candidate preselection and a sparse COO pair
              accumulator (`ApproxValuationSession`; certified error knob
              top_m / recall_target, measured recall and bound in meta)
  "knn_shapley" / "wknn" / "loo" (per-point values):
    streamed  the streaming pipeline via a `ValuationSession` (default)
    eager     direct call of the public function (same step, no session)
    sharded   a `ShardedValuationSession`, (n/D,) vector rows per shard
    approx    LSH top-m candidates and O(m) deterministic scatters, the
              same certified error reporting
    oracle    O(2^n) brute-force subset enumeration, for parity tests
              only, guarded to n <= 16 ("knn_shapley" / "wknn")

The sharded engine takes `shards=` (default: every local card, clamped to
a divisor of n) or `devices=`, one device per shard, repeats allowed (so
`devices=["cuda"] * 4` runs four shards on one card); one usable shard
falls back to the single-device step. Either option without
`engine="sharded"` raises, as does `mesh=` without
`engine="distributed"` and as do the approx options (`top_m`, `seed`,
`recall_target`, `approx_params`) without `engine="approx"`. The
distributed engine refuses `fill`, `fill_params`, `distance`,
`test_batch` and `autotune` (its cells always run the distance and rect
fill kernels), and a `device=` that is not its grid's first device.
`autotune=True` tunes what "auto" finds missing from the tuning cache
(`repro_torch.kernels.autotune`). Every entry point takes `device=`
("cuda" by default; "cpu" must be asked for) and raises when a CUDA
device is asked for and absent.
"""

from __future__ import annotations

import inspect
import time
import warnings
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.results import ValuationResult
from repro_torch.device import resolve_device

__all__ = [
    "ValuationMethod",
    "register_method",
    "get_method",
    "list_methods",
    "ENGINES",
    "valid_engines",
    "INTERACTION_ENGINES",  # deprecated alias for ENGINES["sti"]
]

ENGINES: dict[str, tuple[str, ...]] = {
    "sti": ("fused", "scan", "distributed", "sharded", "approx"),
    "sii": ("fused", "scan", "distributed", "sharded", "approx"),
    "knn_shapley": ("streamed", "eager", "sharded", "approx", "oracle"),
    "wknn": ("streamed", "eager", "sharded", "approx", "oracle"),
    "loo": ("streamed", "eager", "sharded", "approx"),
}

# result-meta keys the approx engine reports, copied from the session's
# finalize meta into the registry result
_APPROX_META_KEYS = (
    "top_m", "approx_exact", "recall_estimate", "matched_prefix",
    "error_bound", "pairs_stored", "n_tables", "n_bits", "window",
    "recall_target", "recall_target_met", "probe_k", "probed_rows",
)
# the knobs `engine="approx"` accepts at the registry level
_APPROX_OPTIONS = ("top_m", "seed", "recall_target", "approx_params")

# the O(2^n) oracles enumerate every subset: parity tests only
_ORACLE_MAX_N = 16


def valid_engines(name: str) -> Optional[tuple[str, ...]]:
    """Supported engines for method `name` (first = default), or None when
    the method is not in the ENGINES table (custom registrations)."""
    return ENGINES.get(name)


def __getattr__(name: str):
    """Module-level deprecation shim: `INTERACTION_ENGINES` predates the
    method-aware ENGINES table and now aliases ENGINES["sti"]."""
    if name == "INTERACTION_ENGINES":
        warnings.warn(
            "INTERACTION_ENGINES is deprecated; use "
            "repro_torch.core.methods.ENGINES[method] (or "
            "valid_engines(method))",
            DeprecationWarning,
            stacklevel=2,
        )
        return ENGINES["sti"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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


def _engine_error(method: str, engine: str) -> ValueError:
    return ValueError(
        f"unknown engine {engine!r} for method {method!r}; valid engines: "
        f"{ENGINES.get(method, ())}"
    )


def _check_shard_options(engine: str, shards, devices) -> None:
    """shards= / devices= only with the sharded engine: running on one
    device would silently defeat the n^2/D memory split asked for."""
    if (shards is not None or devices is not None) and engine != "sharded":
        raise ValueError(
            f"shards= and devices= are only meaningful with "
            f"engine='sharded' (got engine={engine!r})"
        )


def _check_approx_options(engine: str, approx: dict) -> None:
    """The approx knobs only with the approx engine: never silently drop a
    knob that changes the result's error story."""
    if approx and engine != "approx":
        raise ValueError(
            f"options {sorted(approx)} are only meaningful with "
            f"engine='approx' (got engine={engine!r})"
        )


def _check_distributed_options(engine: str, mesh, device, **options) -> None:
    """mesh= only with the distributed engine, and that engine takes none
    of the single-device pipeline's knobs (its cells always run the
    distance and rect fill kernels): a knob it would ignore raises.
    `options` maps each knob to (value, default). A device= beside mesh=
    must name the grid's first device; the default "cuda" defers to it."""
    if mesh is not None and engine != "distributed":
        raise ValueError(
            f"mesh= is only meaningful with engine='distributed' (got "
            f"engine={engine!r})")
    if engine != "distributed":
        return
    given = sorted(nm for nm, (v, default) in options.items()
                   if v != default)
    if given:
        raise ValueError(f"options {given} do not apply to "
                         f"engine='distributed'")
    if mesh is not None and not (isinstance(device, str)
                                 and device == "cuda"):
        dev, first = resolve_device(device), mesh.devices[0]
        if dev.type != first.type or dev.index not in (None, first.index):
            raise ValueError(f"device={str(device)!r} is not the grid's "
                             f"first device {first}")


def _run_approx(x_train, y_train, x_test, y_test, approx: dict, **kw):
    """Drive an `ApproxValuationSession` over the whole test set; returns
    (result, session)."""
    from repro_torch.core.session import ApproxValuationSession

    akw = dict(approx.get("approx_params") or {})
    akw.update({nm: v for nm, v in approx.items() if nm != "approx_params"})
    sess = ApproxValuationSession(x_train, y_train, **kw, **akw)
    return sess.update(x_test, y_test).finalize(), sess


def _keyword_options(fn: Callable) -> frozenset:
    """Names of the keyword-only options `fn` accepts."""
    return frozenset(
        p.name for p in inspect.signature(fn).parameters.values()
        if p.kind is inspect.Parameter.KEYWORD_ONLY
    )


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
        "shards", "devices", "mesh", "autotune", *_APPROX_OPTIONS,
    })

    def __init__(self, name: str, mode: str):
        self.name = name
        self.mode = mode

    def __call__(self, x_train, y_train, x_test, y_test, *, k: int = 5,
                 engine: str = "fused", test_batch: int = 256,
                 fill: str = "auto", fill_params: Optional[dict] = None,
                 distance: str = "auto", device="cuda",
                 shards: Optional[int] = None, devices=None, mesh=None,
                 autotune: bool = False, top_m: Optional[int] = None,
                 seed: Optional[int] = None,
                 recall_target: Optional[float] = None,
                 approx_params: Optional[dict] = None) -> ValuationResult:
        if engine not in ENGINES[self.name]:
            raise _engine_error(self.name, engine)
        _check_shard_options(engine, shards, devices)
        _check_distributed_options(
            engine, mesh, device, fill=(fill, "auto"),
            fill_params=(fill_params, None), distance=(distance, "auto"),
            test_batch=(test_batch, 256), autotune=(autotune, False))
        approx = {nm: v for nm, v in dict(
            top_m=top_m, seed=seed, recall_target=recall_target,
            approx_params=approx_params).items() if v is not None}
        _check_approx_options(engine, approx)
        if devices is not None:
            device = devices[0]
        if engine == "distributed" and mesh is None:
            from repro_torch.launch.mesh import make_local_mesh

            mesh = make_local_mesh(device)
        if mesh is not None:
            device = mesh.devices[0]
        dev = resolve_device(device)
        meta = _base_meta(x_train, x_test, k, dev)
        meta.update(method=self.name, mode=self.mode, engine=engine,
                    streamed=engine in ("fused", "sharded", "approx"))
        tb = max(1, min(int(test_batch), int(x_test.shape[0])))
        t0 = time.perf_counter()
        if engine == "fused":
            from repro_torch.kernels.sti_pipeline import (
                fused_sti_knn_interactions, prepare_fused_step)

            _, resolved = prepare_fused_step(
                x_train.shape[0], x_train.shape[1], k, mode=self.mode,
                test_batch=tb, fill=fill, fill_params=fill_params,
                distance=distance, autotune=autotune, device=dev,
            )
            phi = fused_sti_knn_interactions(
                x_train, y_train, x_test, y_test, k, mode=self.mode,
                test_batch=test_batch, fill=fill, fill_params=fill_params,
                distance=distance, device=dev,
            )
            meta.update(test_batch=test_batch, **resolved)
        elif engine == "sharded":
            from repro_torch.kernels.sti_pipeline import (
                sharded_sti_knn_interactions)

            phi, resolved = sharded_sti_knn_interactions(
                x_train, y_train, x_test, y_test, k, mode=self.mode,
                test_batch=test_batch, shards=shards, devices=devices,
                fill=fill, fill_params=fill_params, distance=distance,
                autotune=autotune, device=dev, return_info=True,
            )
            meta.update(resolved)
        elif engine == "approx":
            res, sess = _run_approx(
                x_train, y_train, x_test, y_test, approx, k=k,
                mode=self.mode, test_batch=tb, fill=fill,
                fill_params=fill_params, distance=distance,
                autotune=autotune, device=dev)
            phi = res.phi
            meta.update(test_batch=tb, fill=sess._resolved.get("fill"),
                        distance=sess._resolved.get("distance"))
            meta.update({nm: res.meta[nm] for nm in _APPROX_META_KEYS
                         if nm in res.meta})
        elif engine == "distributed":
            phi, mesh_shape = _distributed_interactions(
                x_train, y_train, x_test, y_test, k, self.mode, mesh)
            meta.update(mesh=mesh_shape)
        else:  # scan
            from repro_torch.core.sti_knn import (
                resolve_fill, sti_knn_interactions)

            phi = sti_knn_interactions(
                x_train, y_train, x_test, y_test, k, mode=self.mode,
                test_batch=test_batch, fill=fill, fill_params=fill_params,
                autotune=autotune, device=dev,
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


def _distributed_interactions(x_train, y_train, x_test, y_test, k, mode,
                              mesh):
    """Run the production cell (`launch.specs.sti_cell`) on `mesh`, a
    `DeviceGrid` (the caller's default: `make_local_mesh(device)`). Test
    points split over "data",
    phi over "model" column blocks; one sum over the data shards combines
    the partials. Finalize: acc / t, with diag / t on the diagonal, in
    place on the gathered phi. Returns (phi, {"data": D, "model": M})."""
    from repro_torch.core.valuation import distributed_sti_step

    t = int(x_test.shape[0])
    phi, diag = distributed_sti_step(mesh, k, mode)(x_train, y_train,
                                                    x_test, y_test)
    phi.div_(t)
    phi.diagonal().copy_(diag / t)
    return phi, mesh.axis_sizes


class _PointValueMethod:
    """Per-point value methods ("knn_shapley", "wknn", "loo"): dispatch
    over the ported engines (ENGINES[name], first = default). "streamed"
    drives a `ValuationSession(mode=name)`, "eager" calls the public
    function, "sharded" drives a `ShardedValuationSession` ((n/D,) vector
    rows per shard), "approx" an `ApproxValuationSession` (LSH top-m
    candidates, certified error meta), "oracle" runs the registered
    O(2^n) brute force (n <= 16).
    The distance defaults to "plain" on every engine, as the reference's
    point engines default to its deterministic "xla" distance; pass
    distance="auto" or "cuda" for the CUDA kernel."""

    def __init__(self, name: str, fn: Callable,
                 oracle: Optional[Callable] = None):
        self.name = name
        self._fn = fn
        self._oracle = oracle
        self._eager_kw = _keyword_options(fn)
        self.accepted_options = self._eager_kw | {
            "engine", "test_batch", "distance", "device", "shards",
            "devices", "autotune", *_APPROX_OPTIONS}

    def __call__(self, x_train, y_train, x_test, y_test, *, k: int = 5,
                 engine: Optional[str] = None, **opts) -> ValuationResult:
        bad = set(opts) - self.accepted_options
        if bad:
            raise ValueError(
                f"method {self.name!r} does not accept options "
                f"{sorted(bad)}; accepted: {sorted(self.accepted_options)}"
            )
        engines = ENGINES[self.name]
        engine = engine or engines[0]
        if engine not in engines:
            raise _engine_error(self.name, engine)
        shards, devices = opts.pop("shards", None), opts.pop("devices", None)
        _check_shard_options(engine, shards, devices)
        device = opts.pop("device", "cuda")
        dev = resolve_device(device if devices is None else devices[0])
        approx = {nm: opts.pop(nm) for nm in _APPROX_OPTIONS if nm in opts}
        _check_approx_options(engine, approx)
        # execution options passed EXPLICITLY go to the engine that runs,
        # and an engine that cannot honour them rejects them
        explicit = {nm: opts.pop(nm) for nm in
                    ("test_batch", "distance", "autotune") if nm in opts}
        test_batch = int(explicit.get("test_batch", 512))
        kw = dict(opts)   # method statics, e.g. weights
        meta = _base_meta(x_train, x_test, k, dev)
        meta.update(
            method=self.name, engine=engine,
            streamed=engine in ("streamed", "sharded", "approx"),
            resolved_fill=None,
            **{k_: v for k_, v in {**kw, **explicit}.items()
               if isinstance(v, (str, int, float))},
        )
        t0 = time.perf_counter()
        if engine == "oracle":
            if explicit:
                raise ValueError(
                    f"options {sorted(explicit)} do not apply to "
                    f"engine='oracle' (brute-force subset enumeration)"
                )
            values = self._run_oracle(x_train, y_train, x_test, y_test, k,
                                      kw).to(dev)
        elif engine == "eager":
            unsupported = set(explicit) - self._eager_kw
            if unsupported:
                raise ValueError(
                    f"options {sorted(unsupported)} are not supported by "
                    f"engine='eager' for method {self.name!r}"
                )
            values = self._fn(x_train, y_train, x_test, y_test, k,
                              device=dev, **dict(kw, **explicit))
        elif engine == "approx":
            t = int(x_test.shape[0])
            res, sess = _run_approx(
                x_train, y_train, x_test, y_test, approx, k=k,
                mode=self.name, test_batch=max(1, min(test_batch, t)),
                distance=explicit.get("distance", "plain"),
                autotune=bool(explicit.get("autotune", False)),
                method_opts=kw or None, device=dev)
            values = res.point_values
            meta.update({nm: res.meta[nm] for nm in _APPROX_META_KEYS
                         if nm in res.meta})
            meta.update({nm: v for nm, v in sess._resolved.items()
                         if nm in ("distance", "test_batch")})
        else:  # streamed | sharded
            from repro_torch.core.session import (
                ShardedValuationSession, ValuationSession)

            t = int(x_test.shape[0])
            skw = dict(k=k, mode=self.name,
                       test_batch=max(1, min(test_batch, t)),
                       distance=explicit.get("distance", "plain"),
                       autotune=bool(explicit.get("autotune", False)),
                       method_opts=kw or None, device=dev)
            if engine == "sharded":
                sess = ShardedValuationSession(
                    x_train, y_train, shards=shards, devices=devices, **skw)
            else:
                sess = ValuationSession(x_train, y_train, **skw)
            values = sess.update(x_test, y_test).finalize().point_values
            meta.update({nm: v for nm, v in sess._resolved.items()
                         if nm in ("distance", "shards", "test_batch")})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        meta["elapsed_s"] = round(time.perf_counter() - t0, 4)
        return ValuationResult(method=self.name, point_values=values,
                               meta=meta)

    def _run_oracle(self, x_train, y_train, x_test, y_test, k, kw):
        """The registered O(2^n) brute force on host numpy arrays, capped
        at n <= 16 so a misdirected call cannot enumerate 2^1000
        subsets."""
        if self._oracle is None:
            raise _engine_error(self.name, "oracle")
        n = int(x_train.shape[0])
        if n > _ORACLE_MAX_N:
            raise ValueError(
                f"engine='oracle' enumerates 2^n subsets and is for parity "
                f"tests only: n={n} > {_ORACLE_MAX_N}; use the default "
                f"engine (exact, no subset enumeration)"
            )
        okw = {nm: v for nm, v in kw.items()
               if nm in _keyword_options(self._oracle)}
        arrays = [x.cpu().numpy() if isinstance(x, torch.Tensor)
                  else np.asarray(x)
                  for x in (x_train, y_train, x_test, y_test)]
        return torch.from_numpy(np.asarray(
            self._oracle(*arrays, int(k), **okw), dtype=np.float32))


def _register_builtins() -> None:
    from repro_torch.core.knn_shapley import knn_shapley_values
    from repro_torch.core.loo import loo_values
    from repro_torch.core.sti_baseline import (
        brute_force_shapley, brute_force_wknn_shapley)
    from repro_torch.core.wknn import wknn_shapley_values

    register_method("sti", _InteractionMethod("sti", mode="sti"))
    register_method("sii", _InteractionMethod("sii", mode="sii"))
    register_method(
        "knn_shapley",
        _PointValueMethod("knn_shapley", knn_shapley_values,
                          oracle=brute_force_shapley),
    )
    register_method("loo", _PointValueMethod("loo", loo_values))
    register_method(
        "wknn",
        _PointValueMethod("wknn", wknn_shapley_values,
                          oracle=brute_force_wknn_shapley),
    )


_register_builtins()
