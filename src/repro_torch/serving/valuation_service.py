"""Valuation as a service: fault-tolerant online sessions over a MUTABLE
training set, with admission control and graceful degradation.

Counterpart of `repro.serving.valuation_service`. `ValuationService` hosts
one `ResilientValuationSession` behind a small request API. Request kinds:

  * ``value_query``    -- fold a batch of test points into the running state;
  * ``add_points``     -- add train points (incremental state update);
  * ``remove_points``  -- remove train points by id (incremental, EXACT);
  * ``get_values``     -- current values for the LIVE train points (cached);
  * ``health``         -- served immediately, never queued.

Every request passes an `AdmissionController`: a bounded FIFO queue that
LOAD-SHEDS when full (status ``"shed"``) and expires requests whose
deadline passed before service (status ``"expired"``). Consecutive queued
``value_query`` requests are COALESCED into shared `test_batch` chunks of
the session's padded step.

Train-set mutations use the fixed-capacity sentinel scheme
(`stream_kernels.SENTINEL_COORD`/`SENTINEL_LABEL`): the step and the state
keep their shapes forever; removed/free slots rank last and contribute
exactly zero. A mutation refolds the batch log through the two-stage
incremental pipeline (`sti_pipeline.make_rank_step` caches (d2, order) per
batch on the host; `make_refold_step` replays only the fold under the new
liveness mask, on a card through the CUDA fill) and `rebase()`s the
session -- ``remove_points`` therefore matches a full recompute
BIT-EXACTLY without re-running distances or sorts. When the incremental
path fails the service falls back to a FULL RECOMPUTE from the log, so a
mutation is answered either way. The refolded state stays on the device
and is rebased from tensors (the reference stages it on the host); the
rank caches are host-resident, as in the reference.

Availability: the wrapped resilient session absorbs retries, rollbacks and
(sharded) device-loss degradation; if it still dies, `_recover_full`
rebuilds the state from the service's own batch log and the request is
answered. `health()` reports ``"degraded"`` (never an error) after any
degradation or full recovery.

Replay contract (exactly-once): after a crash, build the service with
``resume=True`` over the same constructor arguments and re-submit the
request stream in the original submit/drain pattern -- already-folded
chunks are skipped by sequence number and the final state is bit-identical
to an uninterrupted run (disable deadlines when replaying: wall-clock
expiry is not deterministic).
"""

from __future__ import annotations

import tempfile
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import _host_copy
from repro_torch.core.resilient import ResilientValuationSession, _counter
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import HealthLog, StepGuard
from repro_torch.kernels.stream_kernels import SENTINEL_COORD, SENTINEL_LABEL
from repro_torch.kernels.sti_pipeline import prepare_refold_step

__all__ = ["Request", "Response", "AdmissionController", "ValuationService"]


def _host(x, dtype) -> np.ndarray:  # sync-point: client arrays staged
    """An owned host numpy copy of a client array (numpy or tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=dtype, copy=True)


@dataclass(frozen=True)
class Request:
    """One admitted unit of work: kind + host-staged payload + deadline."""

    rid: int
    kind: str
    payload: dict
    arrived_s: float
    expires_s: float  # absolute monotonic deadline (inf = none)


@dataclass(frozen=True)
class Response:
    """Terminal answer to a request.

    `status` is one of ``"ok"`` (served), ``"shed"`` (queue full at
    submit), ``"expired"`` (deadline passed before service),
    ``"rejected"`` (client error: unknown ids, capacity exceeded, ...) or
    ``"error"`` (unexpected server-side failure -- the chaos drill asserts
    none occur). `payload` carries the kind-specific result.
    """

    rid: int
    kind: str
    status: str
    payload: dict
    latency_s: float

    @property
    def ok(self) -> bool:
        """True iff the request was served successfully."""
        return self.status == "ok"


class AdmissionController:
    """Bounded FIFO admission queue with load shedding.

    `offer` returns False -- and counts a shed -- when the queue is at
    `queue_limit`; the service answers such requests immediately with
    status ``"shed"``. Expiry is judged at SERVICE time by the service
    loop, not at submit: an admitted request may still expire waiting in
    the queue.
    """

    def __init__(self, queue_limit: int = 64,
                 clock: Callable[[], float] = time.monotonic):
        self.queue_limit = max(1, int(queue_limit))
        self._clock = clock
        self._q: deque[Request] = deque()
        self.stats = {"admitted": 0, "shed": 0, "expired": 0}

    def offer(self, req: Request) -> bool:
        """Admit `req` FIFO; False (and a shed count) when at the limit."""
        if len(self._q) >= self.queue_limit:
            self.stats["shed"] += 1
            return False
        self._q.append(req)
        self.stats["admitted"] += 1
        return True

    def take(self) -> Optional[Request]:
        """Pop the oldest queued request (None when idle)."""
        return self._q.popleft() if self._q else None

    def peek(self) -> Optional[Request]:
        """The oldest queued request without removing it (coalescing)."""
        return self._q[0] if self._q else None

    @property
    def depth(self) -> int:
        """Current queue occupancy."""
        return len(self._q)


@dataclass
class _BatchRec:
    """One folded test chunk: padded host copies + optional rank caches."""

    xs: np.ndarray                    # (tb, d) padded
    ys: np.ndarray                    # (tb,) padded
    mask: np.ndarray                  # (tb,) 1.0 on real rows
    b: int                            # real rows
    d2: Optional[np.ndarray] = None   # (tb, cap) cached distances
    order: Optional[np.ndarray] = None  # (tb, cap) cached stable argsort


class ValuationService:
    """Long-lived online valuation service (see module docstring).

    Key construction knobs beyond the wrapped session's:

      * capacity -- total train slots; extra slots start free (sentinel)
        and are claimed by ``add_points``. Defaults to the initial n.
      * queue_limit / default_deadline_s -- admission control; per-request
        ``deadline_s`` at `submit` overrides the default.
      * step_deadline_s / max_retries / backoff_s / seed -- the StepGuard
        budget, applied per fold attempt inside the session AND per
        mutation refold at the service level.
      * cache_policy -- "lazy" (default: rank caches are materialized at
        the first mutation), "eager" (at fold time), or "off" (every
        mutation is a full recompute -- the baseline).
      * max_cached_batches -- bound the (tb, capacity) rank caches to the
        newest N batches; older batches re-rank during a mutation.
      * resume -- restore from `ckpt_dir`'s newest verified checkpoint and
        expect the client to replay its request stream (exactly-once).
      * device / sharded / shards / devices -- where the session runs:
        one device (default "cuda"), or sharded over `devices` (one per
        shard) or `shards` local cards. Mutation refolds run on `device`
        (the first of `devices`).
      * injector -- `FaultInjector` passed through to the session
        (chaos drills); None in production.

    The service is single-threaded by design: `submit` enqueues, `drain`
    serves.
    """

    _KINDS = ("value_query", "add_points", "remove_points", "get_values")

    def __init__(self, x_train, y_train, *, method: str = "sti", k: int = 5,
                 capacity: Optional[int] = None, test_batch: int = 64,
                 sharded: bool = False, shards: Optional[int] = None,
                 devices=None,
                 ckpt_dir=None, ckpt_every: int = 8, ckpt_keep: int = 4,
                 async_checkpoint: bool = True, resume: bool = False,
                 queue_limit: int = 64,
                 default_deadline_s: float = float("inf"),
                 step_deadline_s: float = float("inf"),
                 max_retries: int = 3, backoff_s: float = 0.01,
                 seed: int = 0, min_shards: int = 1,
                 cache_policy: str = "lazy",
                 max_cached_batches: Optional[int] = None,
                 fill: str = "auto", distance: str = "auto",
                 method_opts: Optional[dict] = None,
                 injector=None, device="cuda",
                 clock: Callable[[], float] = time.monotonic):
        x = _host(x_train, np.float32)  # host ground truth
        y = _host(y_train, np.int32)
        if x.ndim != 2 or y.shape[0] != x.shape[0]:
            raise ValueError("train set must be x (n, d), y (n,)")
        n, dim = x.shape
        cap = n if capacity is None else int(capacity)
        if cap < n:
            raise ValueError(f"capacity {cap} < initial train size {n}")
        if cache_policy not in ("lazy", "eager", "off"):
            raise ValueError(f"unknown cache_policy {cache_policy!r}")
        self.method = method
        self.k = int(k)
        self.capacity = cap
        self.d = int(dim)
        self.test_batch = max(1, int(test_batch))
        self.cache_policy = cache_policy
        self.max_cached_batches = max_cached_batches
        self.default_deadline_s = float(default_deadline_s)
        self._clock = clock
        self.device = resolve_device(devices[0] if devices else device)

        # fixed-capacity ground truth: live rows 0..n-1, sentinel elsewhere
        self._x = np.full((cap, dim), SENTINEL_COORD, np.float32)
        self._y = np.full((cap,), SENTINEL_LABEL, np.int32)
        self._x[:n] = x
        self._y[:n] = y
        self._keep = np.zeros((cap,), np.float32)
        self._keep[:n] = 1.0
        self._ids = np.full((cap,), -1, np.int64)
        self._ids[:n] = np.arange(n)
        self._slot_of = {int(i): s for s, i in enumerate(range(n))}
        self._free = list(range(n, cap))
        self._next_id = n
        self._version = 0

        self._tmpdir = None
        if ckpt_dir is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="valsvc-")
            ckpt_dir = self._tmpdir.name
        self.ckpt_dir = ckpt_dir
        guard_opts = dict(deadline_s=step_deadline_s,
                          max_retries=max_retries, backoff_s=backoff_s)
        place = (dict(devices=list(devices)) if devices is not None
                 else dict(device=self.device))
        self._session = None
        if resume:
            try:
                self._session = ResilientValuationSession.restore(
                    ckpt_dir, self._x, self._y, injector=injector,
                    keep=ckpt_keep, async_checkpoint=async_checkpoint,
                    seed=seed, min_shards=min_shards, **place,
                    **guard_opts)
            except FileNotFoundError:
                self._session = None  # nothing to resume: fresh start
        if self._session is None:
            self._session = ResilientValuationSession(
                self._x, self._y, ckpt_dir=ckpt_dir, mode=method, k=self.k,
                ckpt_every=ckpt_every, keep=ckpt_keep,
                async_checkpoint=async_checkpoint, sharded=sharded,
                shards=shards, seed=seed, min_shards=min_shards,
                injector=injector, test_batch=self.test_batch,
                fill=fill, distance=distance, method_opts=method_opts,
                **place, **guard_opts)

        # incremental-mutation pipeline (always single-device: mutations
        # refold densely, and rebase re-places on the shards)
        refold_fill = fill if not (sharded or devices) else "auto"
        self._refold, self._rank, self._refold_resolved, self._spec = (
            prepare_refold_step(
                method, cap, dim, self.k, test_batch=self.test_batch,
                fill=refold_fill, distance=distance,
                method_opts=method_opts, device=self.device))
        self._colfn = self._rank.distance

        self._admission = AdmissionController(queue_limit, clock=clock)
        self._log: list[_BatchRec] = []
        self._results: dict[tuple, dict] = {}
        self._responses: OrderedDict[int, Response] = OrderedDict()
        self._rid = 0
        self._lat = HealthLog(window=512)
        self._stats = {
            "queries": 0, "mutations": 0, "coalesced": 0, "cache_hits": 0,
            "full_recoveries": 0, "fallback_recomputes": 0,
            "mutation_retries": 0,
        }
        # counts into the stats dict, not through a bound method: the
        # service holds no reference cycle, so `del` frees its state
        self._guard = StepGuard(
            seed=seed + 1, on_retry=_counter(self._stats, "mutation_retries"),
            **guard_opts)

    # ------------------------------------------------------------ accessors
    @property
    def n_live(self) -> int:
        """Live (non-removed, non-free) train points."""
        return int(np.sum(self._keep > 0.0))

    @property
    def t_seen(self) -> int:
        """Test points folded into the current state."""
        return int(self._session.t_seen)

    @property
    def version(self) -> int:
        """Train-set version: bumped by every successful mutation."""
        return self._version

    # ------------------------------------------------------------ admission
    def submit(self, kind: str, *, deadline_s: Optional[float] = None,
               **payload) -> int:
        """Enqueue a request; returns its id for `poll` after `drain`.

        A queue at `queue_limit` answers immediately with status
        ``"shed"`` (the id still resolves via `poll`). Malformed payloads
        raise ValueError at submit time -- this is an in-process API, the
        caller IS the client.
        """
        if kind not in self._KINDS:
            raise ValueError(
                f"unknown request kind {kind!r}; choose from {self._KINDS}")
        rid = self._rid
        self._rid += 1
        dl = self.default_deadline_s if deadline_s is None else float(
            deadline_s)
        now = self._clock()
        req = Request(rid=rid, kind=kind,
                      payload=self._stage(kind, payload),
                      arrived_s=now,
                      expires_s=now + dl if np.isfinite(dl) else float("inf"))
        if not self._admission.offer(req):
            self._finish(Response(
                rid, kind, "shed",
                {"reason": f"admission queue at limit "
                           f"{self._admission.queue_limit}"}, 0.0))
        return rid

    def _stage(self, kind: str, payload: dict) -> dict:
        # request staging copies client arrays to the host, so the queue
        # owns its data (clients may reuse their buffers)
        if kind in ("value_query", "add_points"):
            x = _host(payload["x"], np.float32)
            y = _host(payload["y"], np.int32)
            if x.ndim == 1:
                x = x[None, :]
                y = np.reshape(y, (1,))
            if x.ndim != 2 or x.shape[1] != self.d or y.shape != (
                    x.shape[0],):
                raise ValueError(
                    f"payload must be x (b, {self.d}), y (b,); got "
                    f"x {x.shape}, y {y.shape}")
            return {"x": x, "y": y}
        if kind == "remove_points":
            return {"ids": [int(i)
                            for i in np.atleast_1d(payload["ids"])]}
        return {}

    def poll(self, rid: int) -> Optional[Response]:
        """The Response for `rid`, or None while it is still queued."""
        return self._responses.get(rid)

    def _finish(self, resp: Response) -> Response:
        self._responses[resp.rid] = resp
        while len(self._responses) > 4096:
            self._responses.popitem(last=False)
        return resp

    def _expired(self, req: Request) -> bool:
        return self._clock() > req.expires_s

    def _expire(self, req: Request) -> Response:
        self._admission.stats["expired"] += 1
        return self._finish(Response(
            req.rid, req.kind, "expired",
            {"reason": "deadline passed before service"},
            self._clock() - req.arrived_s))

    # -------------------------------------------------------------- serving
    def drain(self) -> list[Response]:
        """Serve every queued request FIFO; returns their Responses.

        Consecutive ``value_query`` requests are coalesced: their points
        are concatenated and folded in shared `test_batch` chunks, then
        each request is answered individually. Expiry is checked as each
        request is popped.
        """
        out: list[Response] = []
        while True:
            req = self._admission.take()
            if req is None:
                break
            if self._expired(req):
                out.append(self._expire(req))
                continue
            if req.kind == "value_query":
                batch = [req]
                while True:
                    nxt = self._admission.peek()
                    if nxt is None or nxt.kind != "value_query":
                        break
                    nxt = self._admission.take()
                    if self._expired(nxt):
                        out.append(self._expire(nxt))
                        continue
                    batch.append(nxt)
                out.extend(self._serve_queries(batch))
            else:
                out.append(self._serve_one(req))
        return out

    def _serve_queries(self, reqs: list[Request]) -> list[Response]:
        t0 = self._clock()
        xs = np.concatenate([r.payload["x"] for r in reqs])
        ys = np.concatenate([r.payload["y"] for r in reqs])
        if len(reqs) > 1:
            self._stats["coalesced"] += len(reqs) - 1
        for s in range(0, len(xs), self.test_batch):
            self._fold_chunk(xs[s:s + self.test_batch],
                             ys[s:s + self.test_batch])
        self._results.clear()
        dt = self._clock() - t0
        out = []
        for r in reqs:
            self._stats["queries"] += 1
            self._lat.record(dt)
            out.append(self._finish(Response(
                r.rid, r.kind, "ok",
                {"folded": int(r.payload["x"].shape[0]),
                 "t_seen": self.t_seen, "version": self._version,
                 "coalesced_with": len(reqs) - 1}, dt)))
        return out

    def _serve_one(self, req: Request) -> Response:
        t0 = self._clock()
        try:
            if req.kind == "add_points":
                status, payload = self._do_add(req.payload)
            elif req.kind == "remove_points":
                status, payload = self._do_remove(req.payload)
            else:
                status, payload = self._do_get_values()
        except Exception as e:  # availability: every admitted request
            status, payload = "error", {"reason": repr(e)}  # is answered
        dt = self._clock() - t0
        self._lat.record(dt)
        return self._finish(Response(req.rid, req.kind, status, payload, dt))

    # ---------------------------------------------------------------- folds
    def _fold_chunk(self, xs: np.ndarray, ys: np.ndarray) -> None:
        """Append one <=test_batch chunk to the log and fold it; a session
        that dies past its own recovery budget is rebuilt from the log
        (`_recover_full`), so the chunk is folded either way."""
        tb, b = self.test_batch, len(xs)
        px = np.zeros((tb, self.d), np.float32)
        py = np.zeros((tb,), np.int32)
        pm = np.zeros((tb,), np.float32)
        px[:b], py[:b], pm[:b] = xs, ys, 1.0
        rec = _BatchRec(xs=px, ys=py, mask=pm, b=b)
        self._log.append(rec)
        try:
            self._session.update(xs, ys)
        except RuntimeError:
            self._recover_full()
        if self.cache_policy == "eager":
            self._fill_cache(rec)
            self._evict_caches()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _fill_cache(self, rec: _BatchRec) -> None:
        # rank caches are host-resident by design (long-lived mutation
        # inputs, not streaming temporaries)
        if rec.d2 is not None:
            return
        d2, order = self._rank(self._dev(rec.xs), self._dev(self._x))
        # owned copies, not views: add_points writes new columns
        rec.d2 = _host_copy(d2)
        rec.order = _host_copy(order)

    def _evict_caches(self) -> None:
        if self.max_cached_batches is None:
            return
        for rec in self._log[:-max(1, int(self.max_cached_batches))]:
            rec.d2 = rec.order = None

    def _ensure_caches(self) -> None:
        """Materialize (d2, order) for every in-window batch against the
        CURRENT train set -- called before the train arrays mutate."""
        if self.cache_policy == "off":
            return
        recs = self._log if self.max_cached_batches is None else \
            self._log[-max(1, int(self.max_cached_batches)):]
        for rec in recs:
            self._fill_cache(rec)

    def _refold_all(self, use_caches: bool = True) -> tuple[tuple, int]:
        """The state the batch log folds to under the current liveness
        mask, as tensors on the service's device, and its test count."""
        keep = self._dev(self._keep)
        xtr = self._dev(self._x)
        ytr = self._dev(self._y)
        state = self._spec.init(self.capacity, self.device)
        t = 0
        for rec in self._log:
            if use_caches and rec.d2 is not None:
                d2, order = self._dev(rec.d2), self._dev(rec.order)
            else:
                d2, order = self._rank(self._dev(rec.xs), xtr)
            state = self._refold(state, d2, order, self._dev(rec.ys),
                                 self._dev(rec.mask), ytr, keep)
            t += rec.b
        return state, t

    def _rebase(self, state, t: int) -> None:
        self._session.rebase(state, t=t, seq=len(self._log),
                             x_train=self._x.copy(),
                             y_train=self._y.copy())

    def _refold_rebase(self) -> None:
        """Guarded incremental refold; on guard exhaustion fall back to a
        FULL recompute from the log (rank + refold, no caches) so the
        mutation is answered either way."""
        try:
            (state, t), _ = self._guard.run(self._refold_all)
        except RuntimeError:
            self._stats["fallback_recomputes"] += 1
            state, t = self._refold_all(False)
        self._rebase(state, t)

    def _recover_full(self) -> None:
        """Last-resort availability backstop: the session died past its
        own recovery budget (single-device loss, stale checkpoints across
        a mutation boundary, ...), so rebuild the state from the service's
        own batch log and rebase. Every admitted request is still
        answered; `health()` reports ``"degraded"`` afterwards."""
        self._stats["full_recoveries"] += 1
        state, t = self._refold_all(use_caches=True)
        self._rebase(state, t)

    # ------------------------------------------------------------ mutations
    def _do_remove(self, payload: dict) -> tuple[str, dict]:
        ids = list(dict.fromkeys(payload["ids"]))  # dedupe, stable order
        missing = [i for i in ids if i not in self._slot_of]
        if missing:
            return "rejected", {"reason": f"unknown ids {missing[:8]}",
                                "version": self._version}
        if len(ids) >= self.n_live:
            return "rejected", {"reason": "cannot remove every live point",
                                "version": self._version}
        self._ensure_caches()  # against the PRE-removal train set: the
        # cached ranks stay valid, the refold masks dead slots
        slots = [self._slot_of.pop(i) for i in ids]
        for s in slots:
            self._keep[s] = 0.0
            self._x[s] = SENTINEL_COORD
            self._y[s] = SENTINEL_LABEL
            self._ids[s] = -1
        self._free.extend(slots)
        self._version += 1
        self._results.clear()
        self._stats["mutations"] += 1
        self._refold_rebase()
        return "ok", {"removed": len(slots), "version": self._version,
                      "n_live": self.n_live, "t_seen": self.t_seen}

    def _do_add(self, payload: dict) -> tuple[str, dict]:
        x, y = payload["x"], payload["y"]
        a = int(x.shape[0])
        if a > len(self._free):
            return "rejected", {
                "reason": f"capacity exceeded: {a} points for "
                          f"{len(self._free)} free slots",
                "version": self._version}
        self._ensure_caches()  # against the PRE-add train set: kept
        # columns stay bit-identical, only the new columns are computed
        slots = [self._free.pop(0) for _ in range(a)]
        for j, s in enumerate(slots):
            self._x[s] = x[j]
            self._y[s] = y[j]
            self._keep[s] = 1.0
            self._ids[s] = self._next_id
            self._slot_of[self._next_id] = s
            self._next_id += 1
        new_ids = [int(self._ids[s]) for s in slots]
        if self.cache_policy != "off":
            # cache column refresh: the new columns by the rank step's own
            # distance (the CUDA kernel on a card), so they hold the bits
            # a fresh ranking gives them, then a stable re-sort of each
            # cached row (host-resident)
            # sync-point: none on the device; `slots` is a host list and
            # the features are host ground truth
            xa = self._dev(self._x[np.asarray(slots)])
            for rec in self._log:
                if rec.d2 is None:
                    continue
                rec.d2[:, slots] = _host_copy(
                    self._colfn(self._dev(rec.xs), xa))
                order = torch.sort(self._dev(rec.d2), dim=-1,
                                   stable=True).indices
                rec.order = _host_copy(order.to(torch.int32))
        self._version += 1
        self._results.clear()
        self._stats["mutations"] += 1
        self._refold_rebase()
        return "ok", {"added": a, "ids": new_ids,
                      "version": self._version, "n_live": self.n_live,
                      "t_seen": self.t_seen}

    # -------------------------------------------------------------- results
    def _do_get_values(self) -> tuple[str, dict]:
        # result extraction gathers host arrays by design
        if self.t_seen == 0:
            return "rejected", {
                "reason": "no test points folded yet (value_query first)"}
        key = (self._version, self.t_seen, self.method,
               self._session.inner._ENGINE)
        hit = key in self._results
        if hit:
            self._stats["cache_hits"] += 1
        else:
            result = self._session.finalize(checkpoint=False)
            live = np.flatnonzero(self._keep > 0.0)
            sub = result.restrict(live)
            del result
            payload = {
                "ids": [int(i) for i in self._ids[live]],
                "values": _host_copy(sub.values()),
                "version": self._version, "t_seen": self.t_seen,
                "method": self.method, "n_live": int(live.shape[0]),
            }
            if sub.phi is not None:
                payload["phi"] = _host_copy(sub.phi)
            self._results[key] = payload
        return "ok", dict(self._results[key], cached=hit)

    def health(self) -> dict:
        """Immediate (never queued) health probe.

        ``status`` is ``"ok"`` or ``"degraded"`` -- degraded after any
        device-loss degradation, service-level full recovery, or
        incremental-refold fallback; the service keeps answering either
        way. Includes queue depth, admission counters, request latency
        p50/p99 over the recent window, and the session's resilience
        summary.
        """
        rs = self._session.resilience_summary()
        degraded = (bool(rs["degradations"])
                    or self._stats["full_recoveries"] > 0
                    or self._stats["fallback_recomputes"] > 0)
        lat = self._lat.times
        return {
            "status": "degraded" if degraded else "ok",
            "method": self.method,
            "engine": self._session.inner._ENGINE,
            "shards": int(self._session.shards),
            "n_live": self.n_live, "capacity": self.capacity,
            "version": self._version, "t_seen": self.t_seen,
            "queue_depth": self._admission.depth,
            "admission": dict(self._admission.stats),
            "requests": dict(self._stats),
            "latency_p50_s": float(np.percentile(lat, 50)) if lat else 0.0,
            "latency_p99_s": float(np.percentile(lat, 99)) if lat else 0.0,
            "resilience": rs,
        }

    # --------------------------------------------------- sync conveniences
    def value_query(self, x, y, *,
                    deadline_s: Optional[float] = None) -> Response:
        """Submit one query batch and drain; returns its Response."""
        rid = self.submit("value_query", x=x, y=y, deadline_s=deadline_s)
        self.drain()
        return self._responses[rid]

    def add_points(self, x, y) -> Response:
        """Submit one add_points mutation and drain; returns its Response."""
        rid = self.submit("add_points", x=x, y=y)
        self.drain()
        return self._responses[rid]

    def remove_points(self, ids) -> Response:
        """Submit one remove_points mutation and drain; returns its
        Response (``"ok"`` removals match a full recompute EXACTLY)."""
        rid = self.submit("remove_points", ids=ids)
        self.drain()
        return self._responses[rid]

    def get_values(self) -> Response:
        """Submit one get_values request and drain; returns its Response
        (payload: ids, values, optional phi, cached flag)."""
        rid = self.submit("get_values")
        self.drain()
        return self._responses[rid]

    def close(self) -> None:
        """Flush in-flight async checkpoint writes and release the
        service-owned temporary checkpoint directory (if any)."""
        self._session._ckpt.wait()
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None
