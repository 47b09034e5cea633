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

__all__ = ["ValuationSession", "ShardedValuationSession"]

# the port's distance names -> the JAX package's counterparts, for the
# checkpoint config that both packages read
_JAX_DISTANCE = {"plain": "xla", "cuda": "pallas"}


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
        # hook: subclasses build their own step and state (sharded)
        self._build(fill, fill_params, distance)

    def _build(self, fill, fill_params, distance) -> None:
        from repro_torch.kernels.sti_pipeline import prepare_stream_step

        n, d = self.x_train.shape
        self._step, self._resolved, self._spec = prepare_stream_step(
            self.mode, n, d, self.k, test_batch=self.test_batch, fill=fill,
            fill_params=fill_params, distance=distance,
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
        arrays = self._spec.result_arrays(self._gathered_state(copy=True),
                                          self._t)
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
        arrays = {name: a.detach().cpu().numpy()
                  for name, a in zip(self._spec.names,
                                     self._gathered_state())}
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

    @classmethod
    def _restore_opts(cls, cfg: dict) -> dict:
        """Hook: constructor kwargs a subclass recovers from the config."""
        return {}

    @classmethod
    def restore(cls, path, x_train, y_train,
                **session_opts) -> "ValuationSession":
        """Rebuild a session from `checkpoint()` output (of either package)
        plus the fixed training set; it continues exactly where the saved
        session stopped. The checkpoint's resolved fill is the default
        when it names a fill of the restoring backend
        (`_restorable_fill`); other fills, and the distance, resolve anew
        there. Explicit `session_opts` (e.g. `device=`) win."""
        from repro_torch.kernels.stream_kernels import accumulator_spec

        base = Path(path)
        if base.suffix != ".npz":
            base = base.with_suffix(".npz")
        with np.load(base) as z:
            cfg = json.loads(str(z["config"]))
            arrays = tuple(z[name]
                           for name in accumulator_spec(cfg["mode"]).names)
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
        sess._place_state(tuple(
            torch.from_numpy(np.asarray(a, np.float32)) for a in arrays))
        sess._t = int(cfg["t"])
        return sess

    def _place_state(self, arrays) -> None:
        """Hook: install restored whole state arrays (sharded sessions
        split them into their row blocks)."""
        self._state = tuple(a.to(self.device).contiguous() for a in arrays)


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

    def _build(self, fill, fill_params, distance) -> None:
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
            super()._build(fill, fill_params, distance)
            self._resolved = dict(self._resolved, shards=1)
            return
        from repro_torch.kernels.sti_pipeline import (
            prepare_sharded_stream_step)

        self._step, self._resolved, self.group, self._spec = (
            prepare_sharded_stream_step(
                self.mode, n, d, self.k, devices=self._requested_devices,
                shards=self.shards, test_batch=self.test_batch, fill=fill,
                fill_params=fill_params, distance=distance,
                method_opts=self.method_opts,
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
        self._state = self._spec.place(arrays, self.group)

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
