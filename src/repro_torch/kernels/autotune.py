"""Persistent autotuner of the port's fills, distance, LSH index and step.

Counterpart of `repro.kernels.autotune`. Times candidate implementations
on synthetic data shaped like the caller's problem and caches the winner
in a JSON file keyed by (kind, backend, device platform, device count,
bucketed sizes). "auto" consults the cache on every resolve: a hit
serves the tuned winner, a miss falls back to the backend heuristic
(`default_*`: the CUDA kernels on a card, the plain versions on the CPU)
unless the caller opts into tuning (`autotune=True`), so the first tuned
run pays the measurement once and every later process reuses it. With an
empty cache every "auto" resolves exactly as the heuristic does.

On a card the fill, rect fill and distance have one candidate each, the
CUDA kernel: the plain versions are the CPU's only choice and are never
offered, served or timed there, so "auto" never falls back to them. A
tuner with one candidate has nothing to measure and writes nothing. Every
error of a timed candidate propagates: a tune never leaves a candidate
out and stores what survived. The whole-step tuner offers the megakernel
in f32 only (bf16 compute is asked for through `fill_params`, never
chosen by "auto") and keeps "stages" unless the megakernel's slowest
timing round beats the stages' fastest.

Cache location: $REPRO_TORCH_AUTOTUNE_CACHE, else
~/.cache/repro_torch/autotune.json -- the port's own file, beside the JAX
package's ($REPRO_AUTOTUNE_CACHE, ~/.cache/repro/autotune.json): a JAX
winner such as "pallas" names nothing in the port's registries. The
platform segment of every key is the device KIND (`device_platform`:
"cpu", or the card's name as a slug such as "nvidiah10080gbhbm3"), so a
winner timed on the CPU is never served to a CUDA process, nor one timed
on one card model to another. Sizes are bucketed to the next power of
two, and the fills and the step are timed on a sample of at most 16 test
rows (their cost is linear in t).
"""

from __future__ import annotations

import functools
import json
import os
import tempfile
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "cache_path",
    "clear_cache",
    "device_platform",
    "default_fill",
    "fill_candidates",
    "autotune_fill",
    "lookup_fill",
    "best_fill",
    "default_rect_fill",
    "rect_fill_candidates",
    "autotune_rect_fill",
    "lookup_rect_fill",
    "best_rect_fill",
    "distance_candidates",
    "autotune_distance",
    "best_distance",
    "default_ann",
    "ann_candidates",
    "autotune_ann",
    "best_ann",
    "megakernel_candidates",
    "autotune_megastep",
    "lookup_megastep",
    "best_megastep",
]

_LOCK = threading.Lock()
# Fill and step timing is linear in t: measure on at most this many test
# rows and transfer the winner to the full t.
_SAMPLE_T = 16

# Cache schema version, as the JAX package's: v2 keys carry the device
# platform segment. `_load` discards any file with another stamp (a v1
# file, or a future one): the cache is self-healing, dropped winners just
# re-tune or fall back to the heuristic.
_SCHEMA = 2
_SCHEMA_KEY = "__schema__"
_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"


def cache_path(path: Optional[str] = None) -> str:
    """Resolve the cache file path: explicit arg >
    $REPRO_TORCH_AUTOTUNE_CACHE > ~/.cache/repro_torch/autotune.json."""
    if path is not None:
        return path
    env = os.environ.get(_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


# "auto" resolves on every valuation call: memoize the parsed cache per
# (path, mtime) so the hot path does one os.stat, not a JSON parse.
# Writers in other processes bump the mtime and invalidate naturally.
_MEMO: dict[str, tuple[int, dict]] = {}


def _load(path: Optional[str]) -> dict:
    p = cache_path(path)
    try:
        mtime = os.stat(p).st_mtime_ns
    except OSError:
        _MEMO.pop(p, None)
        return {}
    hit = _MEMO.get(p)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    try:
        with open(p) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {}
    if not isinstance(data, dict) or data.get(_SCHEMA_KEY) != _SCHEMA:
        data = {}
    else:
        data = {k: v for k, v in data.items() if k != _SCHEMA_KEY}
    _MEMO[p] = (mtime, data)
    return data


def _save(path: Optional[str], data: dict) -> None:
    """Write `data` (stamped with the schema) atomically: a temporary file
    in the same directory renamed over the cache."""
    p = cache_path(path)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p) or ".", suffix=".tmp")
    data = dict(data)
    data[_SCHEMA_KEY] = _SCHEMA
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, p)
        _MEMO[p] = (os.stat(p).st_mtime_ns,
                    {k: v for k, v in data.items() if k != _SCHEMA_KEY})
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _store(path: Optional[str], key: str, entry: dict) -> None:
    with _LOCK:
        # copy: never mutate the memo's dict before the save succeeded
        data = dict(_load(path))
        data[key] = entry
        _save(path, data)


def clear_cache(path: Optional[str] = None) -> None:
    """Delete the cache file (and its memo); the next resolve falls back to
    the backend heuristic until re-tuned."""
    _MEMO.pop(cache_path(path), None)
    try:
        os.unlink(cache_path(path))
    except OSError:
        pass


def _bucket(x: int) -> int:
    """Next power of two >= x (>= 1): nearby sizes share a cache entry."""
    return 1 << max(0, int(np.ceil(np.log2(max(1, x)))))


@functools.lru_cache(maxsize=None)
def device_platform(backend: str = "cuda") -> str:
    """Short device-KIND slug for cache keys: "cpu" off the card, else the
    lowercased alphanumerics of `torch.cuda.get_device_name()` (e.g.
    "nvidiah10080gbhbm3"; "cuda" when no card is attached). The backend
    string alone cannot tell card models apart."""
    if backend != "cuda":
        return "cpu"
    if not torch.cuda.is_available():  # no card attached: the backend name
        return "cuda"
    slug = "".join(ch for ch in torch.cuda.get_device_name().lower()
                   if ch.isalnum())
    return slug or "unknown"


def _key(kind: str, backend: str, n: int, t: int,
         devices: Optional[int] = None, rows: Optional[int] = None) -> str:
    """Cache key: kind, backend, platform slug, visible device count
    (`dev{D}`), an optional `rows{R}` segment (the rect fill's row-block
    height) and the bucketed n and t."""
    if devices is None:
        devices = torch.cuda.device_count() if backend == "cuda" else 1
    r = "" if rows is None else f"rows{_bucket(rows)}:"
    plat = device_platform(backend)
    return f"{kind}:{backend}:{plat}:dev{int(devices)}:{r}n{_bucket(n)}:" \
           f"t{_bucket(t)}"


def _device(backend: str) -> torch.device:
    from repro_torch.device import resolve_device

    return resolve_device("cuda" if backend == "cuda" else "cpu")


def _time_call(fn: Callable, backend: str, reps: int = 2) -> float:
    """Mean microseconds per call of `fn()` after one warmup call, ending
    each measurement in a device synchronize on a card."""
    def sync():
        if backend == "cuda":
            torch.cuda.synchronize()

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e6


def _timed(timings: dict, label: str, fn: Callable, backend: str,
           reps: int) -> None:
    """Time one candidate into `timings`. Its errors propagate (the chunked
    candidates are already cut to `_temp_budget`); the card's cached
    blocks are released after it either way."""
    try:
        timings[label] = _time_call(fn, backend, reps)
    finally:
        if backend == "cuda":
            torch.cuda.empty_cache()


def _temp_budget(backend: str) -> int:
    """Bytes a chunked candidate's temporaries may take: 1 GiB of host
    memory (chunked candidates run only off the card)."""
    return 1 << 30


# a chunked fill step holds a (chunk, rows, n) bool compare, its f32
# select and the f32 sum over the chunk: 9 bytes an element
_CHUNK_BYTES = 9


def _chunks(rows: int, n: int, t: int, backend: str) -> list[int]:
    budget = _temp_budget(backend)
    return [c for c in (1, 2, 4, 8)
            if c <= max(1, t) and c * rows * n * _CHUNK_BYTES <= budget]


def _parse(label: str) -> tuple[str, dict]:
    name, params = label.split(" ", 1)
    return name, json.loads(params)


def _winner(timings: dict) -> tuple[str, dict]:
    return _parse(min(timings, key=timings.get))


def _label(name: str, params: dict) -> str:
    return f"{name} {json.dumps(params, sort_keys=True)}"


def _synthetic_fill_problem(n: int, ts: int, dev: torch.device):
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(ts, n)).astype(np.float32))
    ranks = torch.from_numpy(
        np.stack([rng.permutation(n) for _ in range(ts)]).astype(np.int64))
    return g.to(dev), ranks.to(dev)


# ----------------------------------------------------------------- fill ----
def default_fill(backend: str) -> tuple[str, dict]:
    """Backend heuristic on a cache miss: the CUDA kernel on "cuda", the
    chunked fill (chunk=1) elsewhere."""
    if backend == "cuda":
        return "cuda", {}
    return "chunked", {"chunk": 1}


def fill_candidates(n: int, t: int, backend: str) -> list[tuple[str, dict]]:
    """Candidate (registry_name, static_params) of the port's fill
    registry: the CUDA kernel alone on a card; elsewhere the chunked scan
    at every chunk whose (chunk, n, n) temporary fits `_temp_budget`."""
    if backend == "cuda":
        return [("cuda", {})]
    return [("chunked", {"chunk": c}) for c in _chunks(n, n, t, backend)]


def _fill_registry(square: bool = True) -> dict:
    import repro_torch.kernels.ops  # noqa: F401  (registers "cuda")
    from repro_torch.core import sti_knn

    return sti_knn._FILL_FNS if square else sti_knn._RECT_FILL_FNS


def _serves(name: str, backend: str, registry: dict) -> bool:
    """Whether a cached winner may run on `backend`: a registered name,
    the CUDA kernel on a card and only off the card anything else."""
    return name in registry and (name == "cuda") == (backend == "cuda")


def autotune_fill(n: int, t: int, *, backend: str = "cuda", reps: int = 2,
                  path: Optional[str] = None, verbose: bool = False
                  ) -> tuple[str, dict]:
    """Time every fill candidate at this (n, t, backend) on a t-sample;
    persist and return the winner."""
    fills = _fill_registry()
    ts = int(min(max(1, t), _SAMPLE_T))
    dev = _device(backend)
    cands = fill_candidates(n, ts, backend)
    if len(cands) == 1:  # nothing to choose between: nothing stored
        return cands[0]
    g, ranks = _synthetic_fill_problem(n, ts, dev)
    timings: dict[str, float] = {}
    for name, params in cands:
        _timed(timings, _label(name, params),
               lambda: fills[name](g, ranks, **params), backend, reps)
        if verbose and _label(name, params) in timings:
            print(f"autotune fill n={n} t={t} {name} {params}: "
                  f"{timings[_label(name, params)]:.0f}us")
    del g, ranks
    name, params = _winner(timings)
    _store(path, _key("fill", backend, n, t), {
        "fill": name, "params": params, "us": timings[_label(name, params)],
        "sample_t": ts, "candidates": timings})
    return name, params


def lookup_fill(n: int, t: int, *, backend: str = "cuda",
                path: Optional[str] = None) -> Optional[tuple[str, dict]]:
    """Cached square-fill winner for this (n, t, backend), or None."""
    entry = _load(path).get(_key("fill", backend, n, t))
    if not isinstance(entry, dict) or "fill" not in entry:
        return None
    return str(entry["fill"]), dict(entry.get("params") or {})


def best_fill(n: int, t: int, *, backend: str = "cuda",
              allow_tune: bool = False, path: Optional[str] = None
              ) -> tuple[str, dict]:
    """The fill for an (n, n) accumulator fed (t, n) batches on `backend`:
    cache hit > (optional) fresh tune > backend heuristic."""
    hit = lookup_fill(n, t, backend=backend, path=path)
    if hit is not None and _serves(hit[0], backend, _fill_registry()):
        return hit
    if allow_tune:
        return autotune_fill(n, t, backend=backend, path=path)
    return default_fill(backend)


# -------------------------------------------------------------- rect fill --
# the sharded engine's row-block fill takes the same heuristic: the CUDA
# rect kernel on "cuda", the chunked rect scan (chunk=1) elsewhere
default_rect_fill = default_fill


def rect_fill_candidates(rows: int, n: int, t: int, backend: str
                         ) -> list[tuple[str, dict]]:
    """Candidate (rect_registry_name, static_params) for the sharded
    engine's (rows, n) row-block fill: the CUDA rect kernel alone on a
    card; elsewhere the chunked rect scan at every chunk that fits
    `_temp_budget`."""
    if backend == "cuda":
        return [("cuda", {})]
    return [("chunked", {"chunk": c}) for c in _chunks(rows, n, t, backend)]


def autotune_rect_fill(rows: int, n: int, t: int, *, backend: str = "cuda",
                       reps: int = 2, path: Optional[str] = None,
                       verbose: bool = False) -> tuple[str, dict]:
    """Time every rect fill candidate at this (rows, n, t, backend) on the
    first `rows` of a synthetic rank table; persist the winner under the
    `rows{R}`-segmented key."""
    fills = _fill_registry(square=False)
    ts = int(min(max(1, t), _SAMPLE_T))
    dev = _device(backend)
    cands = rect_fill_candidates(rows, n, ts, backend)
    if len(cands) == 1:  # nothing to choose between: nothing stored
        return cands[0]
    g, ranks = _synthetic_fill_problem(n, ts, dev)
    r_rows = ranks[:, :max(1, min(rows, n))]
    timings: dict[str, float] = {}
    for name, params in cands:
        _timed(timings, _label(name, params),
               lambda: fills[name](g, r_rows, ranks, **params), backend,
               reps)
        if verbose and _label(name, params) in timings:
            print(f"autotune rect fill rows={rows} n={n} t={t} {name} "
                  f"{params}: {timings[_label(name, params)]:.0f}us")
    del g, ranks, r_rows
    name, params = _winner(timings)
    _store(path, _key("rectfill", backend, n, t, rows=rows), {
        "fill": name, "params": params, "us": timings[_label(name, params)],
        "sample_t": ts, "candidates": timings})
    return name, params


def lookup_rect_fill(rows: int, n: int, t: int, *, backend: str = "cuda",
                     path: Optional[str] = None
                     ) -> Optional[tuple[str, dict]]:
    """Cached rect-fill winner for this (rows, n, t, backend), or None."""
    entry = _load(path).get(_key("rectfill", backend, n, t, rows=rows))
    if not isinstance(entry, dict) or "fill" not in entry:
        return None
    return str(entry["fill"]), dict(entry.get("params") or {})


def best_rect_fill(rows: int, n: int, t: int, *, backend: str = "cuda",
                   allow_tune: bool = False, path: Optional[str] = None
                   ) -> tuple[str, dict]:
    """The rect fill of a (rows, n) row block on `backend`: cache hit >
    (optional) fresh tune > backend heuristic."""
    hit = lookup_rect_fill(rows, n, t, backend=backend, path=path)
    if hit is not None and _serves(hit[0], backend,
                                   _fill_registry(square=False)):
        return hit
    if allow_tune:
        return autotune_rect_fill(rows, n, t, backend=backend, path=path)
    return default_rect_fill(backend)


# ------------------------------------------------------------- distance ----
def distance_candidates(backend: str) -> list[tuple[str, dict]]:
    """Candidate distance implementations: the CUDA kernel on a card, the
    plain expansion elsewhere -- one a backend, so there is nothing to
    time."""
    if backend == "cuda":
        return [("cuda", {})]
    return [("plain", {})]


def autotune_distance(t: int, n: int, d: int, *, backend: str = "cuda",
                      reps: int = 2, path: Optional[str] = None
                      ) -> tuple[str, dict]:
    """The distance of (t, d) x (n, d) on `backend`, after checking that
    the backend is there. With one candidate nothing is timed or stored;
    the arguments are the reference tuner's."""
    _device(backend)
    return distance_candidates(backend)[0]


def best_distance(t: int, n: int, d: int, *, backend: str = "cuda",
                  allow_tune: bool = False, path: Optional[str] = None
                  ) -> tuple[str, dict]:
    """The distance for (t, d) x (n, d) on `backend`: the CUDA kernel on a
    card, the plain expansion elsewhere. No cache entry is read: one
    candidate a backend leaves nothing for a tune to decide."""
    return distance_candidates(backend)[0]


# ------------------------------------------------------------------ ann ----
# engine="approx" LSH index shapes trade SPEED against RECALL: the tuner
# picks the fastest (n_tables, window) whose measured recall@16 on
# synthetic data clears the floor, else the highest-recall one.
_ANN_RECALL_FLOOR = 0.95
_ANN_RECALL_K = 16


def default_ann(n: int, m: int) -> tuple[int, int]:
    """Heuristic (n_tables, window) for an untuned approx run: 4 tables
    with windows sized so the pool covers 2x top_m (clamped to n)."""
    n_tables = 4
    window = max(16, min(int(n), -(-2 * int(m) // n_tables)))
    return n_tables, window


def ann_candidates(n: int, m: int) -> list[tuple[int, int]]:
    """Candidate (n_tables, window) grid: table counts {4, 8} crossed with
    pool multipliers {2, 4} of top_m."""
    cands: list[tuple[int, int]] = []
    for n_tables in (4, 8):
        for mult in (2, 4):
            window = max(16, min(int(n), -(-mult * int(m) // n_tables)))
            if (n_tables, window) not in cands:
                cands.append((n_tables, window))
    return cands


def _ann_key(n: int, t: int, d: int, m: int, backend: str) -> str:
    return _key(f"ann_m{_bucket(int(m))}_d{d}", backend, n, t)


def autotune_ann(n: int, t: int, d: int, m: int, *, backend: str = "cuda",
                 reps: int = 2, path: Optional[str] = None
                 ) -> tuple[int, int]:
    """Time and recall-measure the (n_tables, window) grid on synthetic
    Gaussian data shaped (n, d) / (min(t, 64), d), with planes from
    `draw_planes(0, ...)` and 16 bits; persist the fastest candidate whose
    recall@16 clears 0.95. Where none does, the heuristic `default_ann`
    is persisted with `floor_met` false: recalls far below the floor on
    data without neighbourhood structure rank no shape (the reference
    persists the highest-recall one)."""
    from repro_torch.kernels.ann import (
        build_tables, draw_planes, matched_prefix_and_recall,
        topm_candidates)

    dev = _device(backend)
    rng = np.random.default_rng(0)
    ts = min(int(t), 64)
    xn = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    xt = torch.from_numpy(rng.normal(size=(ts, d)).astype(np.float32)).to(
        dev)
    probe_k = min(_ANN_RECALL_K, int(m))
    results: dict[str, dict] = {}
    for n_tables, window in ann_candidates(n, m):
        tables = build_tables(xn, draw_planes(0, n_tables, 16, d))
        timings: dict[str, float] = {}
        _timed(timings, "us", lambda: topm_candidates(xt, xn, tables, int(m),
                                                      window), backend, reps)
        cand, _, _ = topm_candidates(xt, xn, tables, int(m), window)
        _, recall = matched_prefix_and_recall(cand, xt, xn, probe_k)
        results[f"{n_tables}x{window}"] = {
            "n_tables": n_tables, "window": window, "us": timings["us"],
            "recall": float(torch.mean(recall))}
    del xn, xt
    good = {k_: v for k_, v in results.items()
            if v["recall"] >= _ANN_RECALL_FLOOR}
    winner = (min(good, key=lambda k_: good[k_]["us"]) if good else
              "{}x{}".format(*default_ann(n, m)))
    entry = dict(results[winner], candidates=results, sample_t=ts,
                 floor_met=bool(good))
    _store(path, _ann_key(n, t, d, m, backend), entry)
    return int(entry["n_tables"]), int(entry["window"])


def best_ann(n: int, t: int, d: int, m: int, *, backend: str = "cuda",
             allow_tune: bool = False, path: Optional[str] = None
             ) -> tuple[int, int]:
    """The approx engine's (n_tables, window) at (n, t, d, top_m): cache
    hit > (optional) fresh tune > heuristic."""
    entry = _load(path).get(_ann_key(n, t, d, m, backend))
    if isinstance(entry, dict) and "n_tables" in entry and "window" in entry:
        return int(entry["n_tables"]), int(entry["window"])
    if allow_tune:
        return autotune_ann(n, t, d, m, backend=backend, path=path)
    return default_ann(n, m)


# ------------------------------------------------------------ megakernel ----
# The fused megakernel replaces a whole step, not one stage, so its tuner
# times COMPLETE steps: the best three-stage step (the cached or heuristic
# fill and distance) against the megakernel, per method, and records which
# STEP wins. `fill="auto"` consults `lookup_megastep`; the untuned default
# is "stages" everywhere, and a tune keeps it unless the megakernel wins by
# more than the spread of repeated timings.
_ROUNDS = 3


def megakernel_candidates(n: int, t: int, backend: str) -> list[dict]:
    """Candidate megakernel params: f32 compute on every backend. The bf16
    cross term changes the values, so "auto" never picks it; a caller asks
    for it with `fill="megakernel"` and `fill_params`."""
    return [{"compute_dtype": "float32"}]


def _clear_winner(rounds: dict, default: str) -> tuple[str, dict]:
    """The lowest-median candidate among those whose slowest round beats
    the fastest round of `default`; `default` when none does, since a
    verdict inside the spread of repeated timings is noise."""
    clear = [lbl for lbl, r in rounds.items()
             if lbl != default and max(r) < min(rounds[default])]
    if not clear:
        return _parse(default)
    return _parse(min(clear, key=lambda lbl: float(np.median(rounds[lbl]))))


def _megastep_key(n: int, t: int, d: int, method: str, backend: str) -> str:
    return _key(f"megastep_{method}_d{d}", backend, n, t)


def autotune_megastep(n: int, d: int, k: int, t: int, *,
                      method: str = "sti", backend: str = "cuda",
                      reps: int = 2, path: Optional[str] = None,
                      verbose: bool = False) -> tuple[str, dict]:
    """Time the three-stage step of `method` against every megakernel
    candidate on a synthetic (t-sample, n, d) problem, `_ROUNDS` rounds of
    `reps` calls each; persist which step wins ("stages" or "megakernel",
    by `_clear_winner`) and its params."""
    from repro_torch.kernels.sti_pipeline import (
        make_fused_step, make_point_step)
    from repro_torch.kernels.stream_kernels import accumulator_spec

    dev = _device(backend)
    ts = int(min(max(1, t), _SAMPLE_T))
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(a).to(dev)

    xs = put(rng.normal(size=(n, d)).astype(np.float32))
    ys = put(rng.integers(0, 2, size=(n,)).astype(np.int32))
    xb = put(rng.normal(size=(ts, d)).astype(np.float32))
    yb = put(rng.integers(0, 2, size=(ts,)).astype(np.int32))
    mask = torch.ones((ts,), dtype=torch.float32, device=dev)
    interaction = accumulator_spec(method).kind == "interaction"
    state = accumulator_spec(method).init(n, dev)
    dist, _ = best_distance(t, n, d, backend=backend, path=path)

    def build(fill, static):
        if interaction:
            if fill is None:
                fill, params = best_fill(n, t, backend=backend, path=path)
                static = tuple(sorted(params.items()))
            return make_fused_step(int(k), method, fill, static, dist)
        return make_point_step(method, int(k), (), dist, fill, static)

    rounds: dict[str, list[float]] = {}
    steps = [("stages", {}, build(None, ()))] + [
        ("megakernel", p, build("megakernel", tuple(sorted(p.items()))))
        for p in megakernel_candidates(n, ts, backend)]
    for name, params, step in steps:
        label = _label(name, params)
        rounds[label] = [
            _time_call(lambda: step(*state, xb, yb, mask, xs, ys), backend,
                       reps) for _ in range(_ROUNDS)]
        if verbose:
            print(f"autotune megastep {method} n={n} t={t} {name} {params}:"
                  f" rounds {', '.join(f'{u:.0f}' for u in rounds[label])}"
                  f" us")
    del state, xs, xb
    timings = {lbl: float(np.median(r)) for lbl, r in rounds.items()}
    name, params = _clear_winner(rounds, _label("stages", {}))
    _store(path, _megastep_key(n, t, d, method, backend), {
        "step": name, "params": params, "us": timings[_label(name, params)],
        "sample_t": ts, "candidates": timings, "rounds": rounds})
    return name, params


def lookup_megastep(n: int, t: int, d: int, *, method: str = "sti",
                    backend: str = "cuda", path: Optional[str] = None
                    ) -> Optional[tuple[str, dict]]:
    """Cached step winner ("stages"/"megakernel", params) of `method` at
    (n, t, d, backend), or None."""
    entry = _load(path).get(_megastep_key(n, t, d, method, backend))
    if not isinstance(entry, dict) or entry.get("step") not in (
            "stages", "megakernel"):
        return None
    params = dict(entry.get("params") or {})
    if params.get("compute_dtype", "float32") != "float32":
        return None  # a precision no tune offers (bf16 compute): a miss
    return str(entry["step"]), params


def best_megastep(n: int, t: int, d: int, k: int, *, method: str = "sti",
                  backend: str = "cuda", allow_tune: bool = False,
                  path: Optional[str] = None) -> tuple[str, dict]:
    """Cache hit > (optional) fresh tune > "stages": the megakernel takes
    over a `fill="auto"` run only after a measurement on this platform
    said it should."""
    hit = lookup_megastep(n, t, d, method=method, backend=backend, path=path)
    if hit is not None:
        return hit
    if allow_tune:
        return autotune_megastep(n, d, k, t, method=method, backend=backend,
                                 path=path)
    return "stages", {}
