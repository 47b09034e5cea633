"""`ValuationSession`: constant-memory streaming valuation over unbounded t.

Counterpart of `repro.core.session.ValuationSession` (single device). The
streaming step folds EVERY registered valuation method over test batches,
state <- step(state, xb, yb, mask, ...), in place on the device; a session
owns that fold so test points can arrive incrementally:

    sess = ValuationSession(x_train, y_train, k=5)            # mode="sti"
    sess = ValuationSession(x_train, y_train, mode="knn_shapley")
    for xb, yb in test_stream:
        sess.update(xb, yb)
    result = sess.finalize()          # ValuationResult, averaged over t

`mode` is any method with a registered streaming kernel
(`repro_torch.kernels.stream_kernels`): "sti"/"sii" fold an (n, n)
accumulator and (n,) diagonal, "knn_shapley"/"wknn"/"loo" a single (n,)
vector. `fill="megakernel"` runs every step as one launch of the fused
kernel. Every batch is padded to `test_batch` rows with a validity mask,
so peak device memory is O(state + test_batch * n) however many updates
arrive.

`checkpoint()` / `ValuationSession.restore()` persist the partial sums in
the JAX package's npz format, so a checkpoint written by either package
restores in the other. The checkpoint names the resolved implementations
in the JAX package's words (the plain distance as "xla", the CUDA one as
"pallas"); a restore keeps a recorded fill only when it names a fill of
the restoring device's backend ("cuda" on a card, the plain fills on the
CPU) or "megakernel", which both packages know; every other fill, and
the distance, resolve anew there, so a CPU checkpoint restored on a card
runs the card's kernels.

`ShardedValuationSession` is the sharded form over a list of devices
(`repro_torch.distributed.sharding`): each test batch is split into D row
slices and the state is held as D row blocks -- (n/D, n) of the
interaction matrix, (n/D,) of the diagonal or the point vector -- that
are concatenated only at `finalize()` and `checkpoint()`. Checkpoints
hold the dense arrays and the shard count, so a stream checkpointed
under D shards restores under any shard count, 1 included (the session
then runs the single-device step).

`ApproxValuationSession` is `engine="approx"`: each test point meets only
the `top_m` candidates of an LSH index, point values land by a
deterministic scatter and sti/sii pairs in a host COO accumulator, and
`finalize()` reports the measured recall and a certified error bound.
Its checkpoints keep the LSH planes; those of the JAX package's approx
engine (drawn by `jax.random`) do not restore here, nor its own there.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.results import ValuationResult
from repro_torch.device import resolve_device, to_device
from repro_torch.tracing import span

__all__ = ["ValuationSession", "ShardedValuationSession",
           "ApproxValuationSession"]

# the port's distance names -> the JAX package's counterparts, for the
# checkpoint config that both packages read
_JAX_DISTANCE = {"plain": "xla", "cuda": "pallas"}


def _f32(a) -> torch.Tensor:
    """A checkpoint's numpy array as an f32 CPU tensor; a tensor is cast
    where it lies. Shares memory with `a` where no cast or move is needed:
    the caller hands over an array it owns."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32))


def _restorable_fill(name, backend: str) -> bool:
    """Whether a checkpoint's resolved fill names a fill of `backend`: the
    "cuda" kernel on a card, a plain fill on the CPU; "megakernel" runs on
    both. Other names, rect names ("rect_cuda") included, resolve anew."""
    from repro_torch.core.sti_knn import _FILL_FNS

    if name == "megakernel":
        return True
    return name in _FILL_FNS and (name == "cuda") == (backend == "cuda")


class ValuationSession:
    """Streaming valuation of any registered method against a fixed
    training set on one device (see module docstring). `embed_fn`, when
    given, maps raw features to the features the KNN ranks on (train and
    test alike), on the session's device."""

    _ENGINE = "session"

    def __init__(self, x_train, y_train, *, k: int = 5, mode: str = "sti",
                 test_batch: int = 256, fill: str = "auto",
                 fill_params: Optional[dict] = None, distance: str = "auto",
                 autotune: bool = False,
                 method_opts: Optional[dict] = None,
                 embed_fn: Optional[Callable] = None, device="cuda"):
        from repro_torch.kernels.sti_pipeline import _feature_dtype
        from repro_torch.kernels.stream_kernels import stream_methods

        if mode not in stream_methods():
            raise ValueError(
                f"unknown mode {mode!r}; choose from {stream_methods()}"
            )
        if k < 1:
            raise ValueError("k must be >= 1")
        self.device = resolve_device(device)
        self._embed = embed_fn or (lambda x: x)
        x = self._embed(to_device(x_train, self.device))
        self._fdt = _feature_dtype(x, fill=fill)
        self.x_train = x.to(self._fdt).contiguous()
        self.y_train = to_device(y_train, self.device)
        if self.x_train.ndim != 2:
            raise ValueError("train features must be (num_points, dim)")
        self.k = int(k)
        self.mode = mode
        self.test_batch = max(1, int(test_batch))
        self.method_opts = dict(method_opts or {})
        self._t = 0
        # hook: subclasses build their own step and state (sharded,
        # approx); autotune=True tunes what "auto" finds missing from the
        # tuning cache (`repro_torch.kernels.autotune`)
        self._build(fill, fill_params, distance, autotune)

    def _build(self, fill, fill_params, distance, autotune) -> None:
        from repro_torch.kernels.sti_pipeline import prepare_stream_step

        n, d = self.x_train.shape
        self._step, self._resolved, self._spec = prepare_stream_step(
            self.mode, n, d, self.k, test_batch=self.test_batch, fill=fill,
            fill_params=fill_params, distance=distance, autotune=autotune,
            method_opts=self.method_opts, device=self.device,
        )
        self._state = self._spec.init(n, self.device)

    # -------------------------------------------------------------- updates
    @property
    def t_seen(self) -> int:
        """Number of test points consumed so far."""
        return self._t

    def update(self, x_test_batch, y_test_batch) -> "ValuationSession":
        """Fold one batch of test points (any size; a single point may be
        passed as a (d,) vector) into the state, `test_batch` rows at a
        time, each slice padded to `test_batch` with a zero validity mask.
        Returns self (chainable)."""
        from repro_torch.kernels.sti_pipeline import pad_test_batch

        with span("session.update"):
            xb = to_device(x_test_batch, self.device)
            yb = to_device(y_test_batch, self.device)
            if xb.ndim == 1:
                xb, yb = xb[None, :], yb.reshape(1)
            xb = self._embed(xb).to(self._fdt)
            if xb.ndim != 2 or xb.shape[1] != self.x_train.shape[1]:
                raise ValueError(
                    f"test batch must be (b, {self.x_train.shape[1]}), "
                    f"got {tuple(xb.shape)}"
                )
            b = xb.shape[0]
            for start in range(0, b, self.test_batch):
                with span("session.pad"):
                    xs, ys, mask = pad_test_batch(
                        xb[start:start + self.test_batch].contiguous(),
                        yb[start:start + self.test_batch], self.test_batch)
                self._state = self._step(self._state,
                                         *self._place_batch(xs, ys, mask),
                                         *self._train_args())
            self._t += b
        return self

    def _place_batch(self, xs, ys, mask) -> tuple:
        """Hook: device placement of one padded batch (sharded override)."""
        return xs, ys, mask

    def _train_args(self) -> tuple:
        """Hook: the train arrays as the step takes them (sharded: one
        copy per shard's device)."""
        return self.x_train, self.y_train

    def set_train(self, x_train, y_train) -> None:
        """Replace the training arrays, same (n, d) shape (the state is
        shape-keyed). Raw features: `embed_fn` applies as in the
        constructor."""
        x = self._embed(to_device(x_train, self.device)).to(self._fdt)
        if x.shape != self.x_train.shape:
            raise ValueError(
                f"set_train must keep the train shape "
                f"{tuple(self.x_train.shape)}, got {tuple(x.shape)}"
            )
        self.x_train = x.contiguous()
        self.y_train = to_device(y_train, self.device)

    # ------------------------------------------------------------- results
    def _gathered_state(self, copy: bool = False) -> tuple:
        """Hook: the state as whole tensors on the session's device;
        `copy=True` guarantees they share no memory with the live state
        (finalize divides them in place). Sharded sessions concatenate
        their row blocks, which always copies."""
        if copy:
            return tuple(a.clone() for a in self._state)
        return self._state

    def finalize(self) -> ValuationResult:
        """Snapshot the running mean as a `ValuationResult`; the session
        stays live. The snapshot divides a copy of the state, so an
        interaction session holds a second (n, n) matrix meanwhile."""
        if self._t == 0:
            raise ValueError("no test points seen: call update() first")
        arrays = self._finalize_arrays()
        dev = self.device
        meta = {
            "method": self.mode,
            "mode": self.mode,
            "engine": self._ENGINE,
            "streamed": True,
            "k": self.k,
            "n": int(self.x_train.shape[0]),
            "t": self._t,
            "d": int(self.x_train.shape[1]),
            "test_batch": self.test_batch,
            "backend": dev.type,
            "device_kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            **{f"opt_{k_}": v for k_, v in self.method_opts.items()},
            **self._resolved,
        }
        meta["resolved_fill"] = self._resolved.get("fill")
        return ValuationResult(method=self.mode, meta=meta, **arrays)

    def _finalize_arrays(self) -> dict:
        """Hook: the finalized `ValuationResult` array kwargs (the approx
        session densifies its sparse pair state here)."""
        return self._spec.result_arrays(self._gathered_state(copy=True),
                                        self._t)

    # --------------------------------------------------------- persistence
    def _extra_config(self) -> dict:
        """Hook: subclass additions to the checkpoint config."""
        return {}

    def checkpoint(self, path) -> Path:
        """Persist the partial sums and config to `<path>.npz` (dense host
        arrays under the spec's names, "acc"/"diag" or "vec"; a sharded
        session concatenates its row blocks first).

        The write is atomic: the bytes go to a `.tmp` sibling, are
        fsync'd, and the file is renamed over the final path, so a
        preemption mid-write never leaves a truncated checkpoint."""
        base = Path(path)
        if base.suffix == ".npz":
            base = base.with_suffix("")
        base.parent.mkdir(parents=True, exist_ok=True)
        resolved = dict(self._resolved)
        resolved["distance"] = _JAX_DISTANCE.get(resolved.get("distance"),
                                                 resolved.get("distance"))
        cfg = {
            "k": self.k, "mode": self.mode, "test_batch": self.test_batch,
            "t": self._t, "resolved": resolved,
            "method_opts": self.method_opts,
            **self._extra_config(),
        }
        arrays = self._checkpoint_arrays()
        out = base.with_suffix(".npz")
        tmp = base.with_suffix(".npz.tmp")
        try:
            with open(tmp, "wb") as f:
                np.savez_compressed(
                    f, config=np.asarray(json.dumps(cfg)), **arrays
                )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
        return out

    def _checkpoint_arrays(self) -> dict:
        """Hook: the named host arrays a checkpoint holds (the spec's
        names; the approx session writes its own)."""
        return {name: a.detach().cpu().numpy()
                for name, a in zip(self._spec.names, self._gathered_state())}

    @classmethod
    def _restore_opts(cls, cfg: dict) -> dict:
        """Hook: constructor kwargs a subclass recovers from the config."""
        return {}

    @classmethod
    def _state_names(cls, cfg: dict) -> tuple:
        """Hook: the checkpoint array names to load for this config."""
        from repro_torch.kernels.stream_kernels import accumulator_spec

        return accumulator_spec(cfg["mode"]).names

    def _restore_extra(self, cfg: dict) -> None:
        """Hook: reinstall the non-array checkpoint state after the arrays
        are placed (the approx session's probe statistics)."""

    @classmethod
    def restore(cls, path, x_train, y_train,
                **session_opts) -> "ValuationSession":
        """Rebuild a session from `checkpoint()` output (of either package)
        plus the fixed training set; it continues exactly where the saved
        session stopped. The checkpoint's resolved fill is the default
        when it names a fill of the restoring backend
        (`_restorable_fill`); other fills, and the distance, resolve anew
        there. Explicit `session_opts` (e.g. `device=`) win."""
        base = Path(path)
        if base.suffix != ".npz":
            base = base.with_suffix(".npz")
        with np.load(base) as z:
            cfg = json.loads(str(z["config"]))
            arrays = tuple(z[name] for name in cls._state_names(cfg))
        devices = session_opts.get("devices")
        backend = torch.device(devices[0] if devices else
                               session_opts.get("device", "cuda")).type
        fill = cfg.get("resolved", {}).get("fill")
        if _restorable_fill(fill, backend):
            session_opts.setdefault("fill", fill)
        if cfg.get("method_opts"):
            session_opts.setdefault("method_opts", cfg["method_opts"])
        for opt, value in cls._restore_opts(cfg).items():
            session_opts.setdefault(opt, value)
        sess = cls(x_train, y_train, k=cfg["k"], mode=cfg["mode"],
                   test_batch=cfg["test_batch"], **session_opts)
        if arrays[0].shape[0] != sess.x_train.shape[0]:
            raise ValueError(
                f"checkpoint is for n={arrays[0].shape[0]} train points, "
                f"got n={sess.x_train.shape[0]}"
            )
        sess._place_state(arrays)
        sess._t = int(cfg["t"])
        sess._restore_extra(cfg)
        return sess

    def _place_state(self, arrays) -> None:
        """Hook: install restored whole state arrays, given as numpy arrays
        or tensors that the session may keep (sharded sessions split them
        into their row blocks)."""
        self._state = tuple(_f32(a).to(self.device).contiguous()
                            for a in arrays)


class ShardedValuationSession(ValuationSession):
    """Streaming valuation with the state split over D shards: each test
    batch row-split over the shards, the state held as (n/D, n) row blocks
    of the interaction matrix and (n/D,) rows of the diagonal or point
    vector, concatenated only at finalize and checkpoint.

    `devices=` lists one device per shard and may repeat a device (the
    counterpart of the JAX package's `mesh=`); n must divide into its
    length, and `device=` is then unused. Without it, `shards=` (default:
    every local card) is clamped by `shard_count` to the largest divisor
    of n the local cards allow.
    One usable shard -- a one-card host, `shards=1`, a one-entry list --
    falls back to the single-device step on `device`, so the same call
    runs everywhere; a host with one card runs D shards only through an
    explicit device list such as `["cuda"] * 4`. `test_batch` is rounded
    UP to a multiple of the shard count (the mask absorbs ragged input).
    """

    _ENGINE = "sharded"

    def __init__(self, x_train, y_train, *, shards: Optional[int] = None,
                 devices=None, **opts):
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
            if not devices:
                raise ValueError("devices= must name at least one device")
            # the session's own tensors live on the first shard's device
            opts["device"] = devices[0]
        self._requested_shards = shards
        self._requested_devices = devices
        self.group = None
        self.shards = 1
        super().__init__(x_train, y_train, **opts)

    def _build(self, fill, fill_params, distance, autotune) -> None:
        from repro_torch.distributed.sharding import replicate, shard_count
        from repro_torch.kernels.stream_kernels import accumulator_spec

        n, d = self.x_train.shape
        if self._requested_devices is not None:
            self.shards = len(self._requested_devices)
        else:
            self.shards = shard_count(n, self._requested_shards)
        if self.shards <= 1:
            # single-shard fallback: the single-device step IS the 1-shard
            # layout. Drop the fill params the square fill cannot accept
            # (layout hints meant for the rect fill), so a sharded call
            # runs unchanged on a one-card host instead of raising.
            if (accumulator_spec(self.mode).kind == "interaction"
                    and fill_params and fill != "auto"):
                from repro_torch.core.sti_knn import (
                    _FILL_FNS, _accepted_params)

                if fill in _FILL_FNS:
                    fill_params = _accepted_params(_FILL_FNS[fill],
                                                   fill_params)
            super()._build(fill, fill_params, distance, autotune)
            self._resolved = dict(self._resolved, shards=1)
            return
        from repro_torch.kernels.sti_pipeline import (
            prepare_sharded_stream_step)

        self._step, self._resolved, self.group, self._spec = (
            prepare_sharded_stream_step(
                self.mode, n, d, self.k, devices=self._requested_devices,
                shards=self.shards, test_batch=self.test_batch, fill=fill,
                fill_params=fill_params, distance=distance,
                autotune=autotune, method_opts=self.method_opts,
            )
        )
        self.test_batch = int(self._resolved["test_batch"])
        self._state = self._spec.init_shards(n, self.group)
        self._train_shards = (replicate(self.x_train, self.group),
                              replicate(self.y_train, self.group))

    def set_train(self, x_train, y_train) -> None:
        """Same-shape train replacement, copied to every shard's device
        (see `ValuationSession.set_train`)."""
        super().set_train(x_train, y_train)
        if self.group is not None:
            from repro_torch.distributed.sharding import replicate

            self._train_shards = (replicate(self.x_train, self.group),
                                  replicate(self.y_train, self.group))

    def _place_batch(self, xs, ys, mask) -> tuple:
        if self.group is None:
            return xs, ys, mask
        from repro_torch.distributed.sharding import shard_rows

        return tuple(shard_rows(a, self.group) for a in (xs, ys, mask))

    def _train_args(self) -> tuple:
        if self.group is None:
            return super()._train_args()
        return self._train_shards

    def _place_state(self, arrays) -> None:
        if self.group is None:
            super()._place_state(arrays)
            return
        self._state = self._spec.place(tuple(_f32(a) for a in arrays),
                                       self.group)

    def _gathered_state(self, copy: bool = False) -> tuple:
        if self.group is None:
            return super()._gathered_state(copy)
        from repro_torch.distributed.sharding import gather_rows

        return tuple(gather_rows(parts, self.group) for parts in self._state)

    def _extra_config(self) -> dict:
        return {"shards": self.shards}

    @classmethod
    def _restore_opts(cls, cfg: dict) -> dict:
        # request the checkpoint's shard count; shard_count() re-clamps it
        # to what this host allows (an explicit devices= list wins)
        return {"shards": cfg["shards"]} if "shards" in cfg else {}


# the port's approx checkpoints name their arrays apart from the JAX
# package's: the planes they were drawn with cannot be drawn there, so a
# JAX restore of one fails on the missing names instead of continuing
# under other planes (and the port refuses a JAX-written one)
_APPROX_ARRAYS = {"point": ("torch_vec", "lsh_proj"),
                  "interaction": ("torch_diag", "pair_keys", "pair_vals",
                                  "lsh_proj")}


class ApproxValuationSession(ValuationSession):
    """Approximate top-m streaming valuation (`engine="approx"`), the
    counterpart of `repro.core.session.ApproxValuationSession`.

    Same fold contract as `ValuationSession`, but each test point is
    compared against only the `top_m` candidates an LSH index proposes
    (`repro_torch.kernels.ann`): O(t (L log n + L W d + m log m)) instead
    of O(t n d + t n log n). Point values land by an O(m) deterministic
    scatter; sti/sii pairs in a host-side COO accumulator that stores only
    pairs that ever co-occur in a candidate set, with the diagonal kept
    exact and dense on the device.

    The error knob is CERTIFIED: every step probes its first
    `recall_sample` rows against an exact distance row, and `finalize()`
    reports the measured recall and the matched-prefix bound of
    `repro_torch.core.approx` in meta["recall_estimate"] /
    meta["error_bound"]; `recall_target` adds meta["recall_target_met"].

    Determinism: the planes come from `torch.Generator().manual_seed(seed)`
    on the CPU (or explicitly, `proj=` (L, b, d), e.g. the JAX package's
    planes), the point scatter and the COO merge are order-stable, and a
    checkpoint keeps the planes, the sparse state and the probe
    statistics: two identical runs, or a checkpoint/restore, give the same
    bits. A checkpoint of the JAX package's approx engine does not restore
    here, nor one of this session there: their planes differ. With
    `top_m >= n` (the default) the session runs the dense exact step, so
    it is bit-identical to the exact engine and meta reports error_bound
    0.
    """

    _ENGINE = "approx"

    def __init__(self, x_train, y_train, *, top_m: Optional[int] = None,
                 seed: int = 0, n_tables: Optional[int] = None,
                 n_bits: int = 16, window: Optional[int] = None,
                 proj=None, recall_sample: int = 8,
                 recall_k: Optional[int] = None,
                 recall_target: Optional[float] = None, **opts):
        self.top_m = None if top_m is None else int(top_m)
        self.seed = int(seed)
        self.n_bits = int(n_bits)
        self.recall_sample = int(recall_sample)
        self.recall_k = None if recall_k is None else int(recall_k)
        self.recall_target = (None if recall_target is None
                              else float(recall_target))
        self._requested_tables = n_tables
        self._requested_window = window
        self._proj = None if proj is None else torch.as_tensor(
            np.array(proj.detach().cpu() if isinstance(proj, torch.Tensor)
                     else proj, np.float32))
        self._explicit_planes = proj is not None
        self._prefix_min: Optional[int] = None
        self._recall_sum = 0.0
        self._recall_rows = 0
        self._probe_k = 0
        self._pairs = None
        self._approx_exact = False
        super().__init__(x_train, y_train, **opts)

    def _build(self, fill, fill_params, distance, autotune) -> None:
        from repro_torch.kernels.stream_kernels import accumulator_spec

        n, d = (int(s) for s in self.x_train.shape)
        m = n if self.top_m is None else min(self.top_m, n)
        self.m = m
        if m >= n:
            # the candidate list would be the whole train set: run the
            # dense step, the exact engine's own, so m = n is bit-identical
            # to it by construction
            self._approx_exact = True
            super()._build(fill, fill_params, distance, autotune)
            self._resolved = dict(self._resolved, top_m=m, approx_exact=True)
            return
        if m < self.k + 1:
            raise ValueError(
                f"top_m must be >= k+1 = {self.k + 1} (the KNN utility and "
                f"the loo window need the first k+1 neighbours), got {m}"
            )
        from repro_torch.kernels.ann import build_tables, draw_planes

        self.x_train = self.x_train.to(torch.float32).contiguous()
        self._fdt = torch.float32
        ann_l, ann_w = self._requested_tables, self._requested_window
        if self._proj is not None:
            ann_l, self.n_bits = (int(s) for s in self._proj.shape[:2])
        if ann_l is None or ann_w is None:
            from repro_torch.kernels.autotune import best_ann

            tuned_l, tuned_w = best_ann(n, self.test_batch, d, m,
                                        backend=self.device.type,
                                        allow_tune=autotune)
            ann_l = int(ann_l or tuned_l)
            ann_w = int(ann_w or tuned_w)
        ann_l, ann_w = int(ann_l), min(int(ann_w), n)
        if ann_l * ann_w < m:  # the pool must be able to cover top_m
            ann_w = min(n, -(-m // ann_l))
        if self._proj is None:
            self._proj = draw_planes(self.seed, ann_l, self.n_bits, d)
        self._tables = build_tables(self.x_train, self._proj.to(self.device))
        probe_k = (self.recall_k if self.recall_k is not None
                   else min(2 * self.k + 2, m))
        self._probe_k = max(1, min(int(probe_k), m))
        probe = max(0, min(self.recall_sample, self.test_batch))
        spec = accumulator_spec(self.mode)
        if spec.kind == "point":
            from repro_torch.kernels.sti_pipeline import (
                make_approx_point_step)

            inner = make_approx_point_step(
                self.mode, self.k, n, m, ann_w, probe, self._probe_k,
                tuple(sorted(self.method_opts.items())))
            self._spec = spec

            def step(state, xs, ys, mask, xtr, ytr):
                vec, prefix, recall = inner(state[0], xs, ys, mask, xtr,
                                            ytr, self._tables)
                self._fold_probe(prefix, recall, mask)
                return (vec,)
        else:
            from repro_torch.kernels.stream_kernels import AccumulatorSpec
            from repro_torch.kernels.sti_pipeline import (
                ApproxPairAccumulator, make_approx_interaction_step)

            inner = make_approx_interaction_step(
                self.mode, self.k, n, m, ann_w, probe, self._probe_k)
            # sparse interaction state: the dense EXACT (n,) diagonal on
            # the device plus the host COO pair accumulator
            self._spec = AccumulatorSpec("point", ("diag",), ("vector",))
            self._pairs = ApproxPairAccumulator(n)

            def step(state, xs, ys, mask, xtr, ytr):
                diag, rows, cols, vals, prefix, recall = inner(
                    state[0], xs, ys, mask, xtr, ytr, self._tables)
                self._pairs.add(rows, cols, vals)
                self._fold_probe(prefix, recall, mask)
                return (diag,)

        self._state = self._spec.init(n, self.device)
        self._step = step
        self._resolved = {
            "fill": None, "distance": "candidates", "top_m": m,
            "approx_exact": False, "n_tables": ann_l,
            "n_bits": self.n_bits, "window": ann_w,
        }

    # -------------------------------------------------------- probe folding
    def _fold_probe(self, prefix, recall, mask) -> None:
        """Fold one step's probe rows into the running recall statistics,
        counting only rows of REAL test points (they come first)."""
        real = int(mask.sum().item())
        s = min(int(prefix.shape[0]), real)
        if s <= 0:
            return
        p = prefix[:s].cpu().numpy()
        r = recall[:s].cpu().numpy()
        low = int(p.min())
        self._prefix_min = (low if self._prefix_min is None
                            else min(self._prefix_min, low))
        self._recall_sum += float(r.sum())
        self._recall_rows += s

    # -------------------------------------------------------------- results
    def _finalize_arrays(self) -> dict:
        if self._pairs is None:
            return super()._finalize_arrays()
        return {"phi": self._pairs.to_dense(self._state[0], self._t)}

    def _approx_meta(self) -> dict:
        """The approx result metadata: resolved m, measured recall and
        matched prefix, and the certified error bound they imply."""
        meta = {"top_m": self.m, "approx_exact": self._approx_exact}
        if self.recall_target is not None:
            meta["recall_target"] = self.recall_target
        if self._approx_exact:
            meta.update(recall_estimate=1.0, matched_prefix=self.m,
                        error_bound=0.0)
            if self.recall_target is not None:
                meta["recall_target_met"] = True
            return meta
        recall = (self._recall_sum / self._recall_rows
                  if self._recall_rows else None)
        meta.update(recall_estimate=recall, matched_prefix=self._prefix_min,
                    probe_k=self._probe_k, probed_rows=self._recall_rows)
        if self._prefix_min is not None:
            from repro_torch.core.approx import error_bound

            meta["error_bound"] = error_bound(
                self.mode, n=int(self.x_train.shape[0]), k=self.k, m=self.m,
                prefix=self._prefix_min)
        if self._pairs is not None:
            meta["pairs_stored"] = self._pairs.nnz
        if self.recall_target is not None and recall is not None:
            meta["recall_target_met"] = bool(recall >= self.recall_target)
        return meta

    def finalize(self) -> ValuationResult:
        """Exact-dispatch or sparse finalize plus the approx metadata
        (recall estimate, matched prefix, certified error bound)."""
        return super().finalize().with_meta(**self._approx_meta())

    # ---------------------------------------------------------- persistence
    def _extra_config(self) -> dict:
        return {
            "approx": {
                "top_m": self.m, "seed": self.seed,
                "n_tables": self._resolved.get("n_tables"),
                "n_bits": self.n_bits,
                "window": self._resolved.get("window"),
                "recall_sample": self.recall_sample,
                "recall_k": self.recall_k,
                "recall_target": self.recall_target,
                "exact": self._approx_exact,
                "planes": ("explicit" if self._explicit_planes
                           else "torch.Generator"),
            },
            "probe": {
                "prefix_min": self._prefix_min,
                "recall_sum": self._recall_sum,
                "recall_rows": self._recall_rows,
            },
        }

    def _checkpoint_arrays(self) -> dict:
        if self._approx_exact:
            return super()._checkpoint_arrays()
        names = _APPROX_ARRAYS["point" if self._pairs is None
                               else "interaction"]
        arrays = [self._state[0].detach().cpu().numpy()]
        if self._pairs is not None:
            arrays.extend(self._pairs.state())
        arrays.append(self._proj.numpy())
        return dict(zip(names, arrays))

    @classmethod
    def _sparse(cls, cfg: dict) -> bool:
        """Whether a config is a non-exact approx checkpoint."""
        approx = cfg.get("approx")
        return approx is not None and not approx.get("exact", False)

    @classmethod
    def _state_names(cls, cfg: dict) -> tuple:
        from repro_torch.kernels.stream_kernels import accumulator_spec

        if not cls._sparse(cfg):
            return super()._state_names(cfg)
        if "planes" not in cfg["approx"]:
            raise ValueError(
                "this approx checkpoint was written by the JAX package: its "
                "LSH planes were drawn by jax.random, which the port cannot "
                "reproduce, so it cannot be continued here (restart the "
                "stream, or finish it with the JAX package)")
        return _APPROX_ARRAYS[accumulator_spec(cfg["mode"]).kind]

    @classmethod
    def _restore_opts(cls, cfg: dict) -> dict:
        approx = cfg.get("approx", {})
        keys = ("top_m", "seed", "n_tables", "n_bits", "window",
                "recall_sample", "recall_k", "recall_target")
        return {k_: approx[k_] for k_ in keys if approx.get(k_) is not None}

    @classmethod
    def restore(cls, path, x_train, y_train,
                **session_opts) -> "ApproxValuationSession":
        """`ValuationSession.restore` plus the planes: a non-exact approx
        checkpoint rebuilds the index from the planes it holds. Raises on a
        JAX-written approx checkpoint (see `_state_names`)."""
        base = Path(path)
        if base.suffix != ".npz":
            base = base.with_suffix(".npz")
        with np.load(base) as z:
            cfg = json.loads(str(z["config"]))
            if cls._sparse(cfg):
                cls._state_names(cfg)       # raises on a JAX checkpoint
                session_opts.setdefault("proj", z["lsh_proj"].copy())
        return super().restore(base, x_train, y_train, **session_opts)

    def _place_state(self, arrays) -> None:
        if self._approx_exact:
            super()._place_state(arrays)
            return
        self._state = (_f32(arrays[0]).to(self.device),)
        if self._pairs is not None:
            self._pairs.load(arrays[1], arrays[2])

    def _restore_extra(self, cfg: dict) -> None:
        probe = cfg.get("probe", {})
        low = probe.get("prefix_min")
        self._prefix_min = None if low is None else int(low)
        self._recall_sum = float(probe.get("recall_sum", 0.0))
        self._recall_rows = int(probe.get("recall_rows", 0))
