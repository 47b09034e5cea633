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
"pallas"); a restore skips the fill and distance names it does not know,
which then resolve anew on the restoring device, and keeps "megakernel",
which both packages know.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core.results import ValuationResult
from repro_torch.device import resolve_device, to_device

__all__ = ["ValuationSession"]

# the port's distance names -> the JAX package's counterparts, for the
# checkpoint config that both packages read
_JAX_DISTANCE = {"plain": "xla", "cuda": "pallas"}


class ValuationSession:
    """Streaming valuation of any registered method against a fixed
    training set on one device (see module docstring)."""

    def __init__(self, x_train, y_train, *, k: int = 5, mode: str = "sti",
                 test_batch: int = 256, fill: str = "auto",
                 fill_params: Optional[dict] = None, distance: str = "auto",
                 method_opts: Optional[dict] = None, device="cuda"):
        from repro_torch.kernels.sti_pipeline import (
            _feature_dtype, prepare_stream_step)
        from repro_torch.kernels.stream_kernels import stream_methods

        if mode not in stream_methods():
            raise ValueError(
                f"unknown mode {mode!r}; choose from {stream_methods()}"
            )
        if k < 1:
            raise ValueError("k must be >= 1")
        self.device = resolve_device(device)
        self._fdt = _feature_dtype(x_train, fill=fill)
        self.x_train = to_device(x_train, self.device,
                                 self._fdt).contiguous()
        self.y_train = to_device(y_train, self.device)
        if self.x_train.ndim != 2:
            raise ValueError("train features must be (num_points, dim)")
        self.k = int(k)
        self.mode = mode
        self.test_batch = max(1, int(test_batch))
        self.method_opts = dict(method_opts or {})
        self._t = 0
        n, d = self.x_train.shape
        self._step, self._resolved, self._spec = prepare_stream_step(
            mode, n, d, self.k, test_batch=self.test_batch, fill=fill,
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

        xb = to_device(x_test_batch, self.device, self._fdt)
        yb = to_device(y_test_batch, self.device)
        if xb.ndim == 1:
            xb, yb = xb[None, :], yb.reshape(1)
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
            self._state = self._step(self._state, xs, ys, mask,
                                     self.x_train, self.y_train)
        self._t += b
        return self

    def set_train(self, x_train, y_train) -> None:
        """Replace the training arrays, same (n, d) shape (the state is
        shape-keyed)."""
        x = to_device(x_train, self.device, self._fdt)
        if x.shape != self.x_train.shape:
            raise ValueError(
                f"set_train must keep the train shape "
                f"{tuple(self.x_train.shape)}, got {tuple(x.shape)}"
            )
        self.x_train = x.contiguous()
        self.y_train = to_device(y_train, self.device)

    # ------------------------------------------------------------- results
    def finalize(self) -> ValuationResult:
        """Snapshot the running mean as a `ValuationResult`; the session
        stays live. The snapshot divides a copy of the state, so an
        interaction session holds a second (n, n) matrix meanwhile."""
        if self._t == 0:
            raise ValueError("no test points seen: call update() first")
        arrays = self._spec.result_arrays(
            tuple(a.clone() for a in self._state), self._t)
        dev = self.device
        meta = {
            "method": self.mode,
            "mode": self.mode,
            "engine": "session",
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
    def checkpoint(self, path) -> Path:
        """Persist the partial sums and config to `<path>.npz` (dense host
        arrays under the spec's names, "acc"/"diag" or "vec").

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
        }
        arrays = {name: a.detach().cpu().numpy()
                  for name, a in zip(self._spec.names, self._state)}
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
    def restore(cls, path, x_train, y_train,
                **session_opts) -> "ValuationSession":
        """Rebuild a session from `checkpoint()` output (of either package)
        plus the fixed training set; it continues exactly where the saved
        session stopped. The checkpoint's resolved fill and distance are
        the defaults when the port knows their names ("megakernel"
        included); other names are skipped and resolve anew. Explicit
        `session_opts` (e.g. `device=`) win."""
        from repro_torch.core.sti_knn import _FILL_FNS
        from repro_torch.kernels.sti_pipeline import _DISTANCES
        from repro_torch.kernels.stream_kernels import accumulator_spec

        base = Path(path)
        if base.suffix != ".npz":
            base = base.with_suffix(".npz")
        with np.load(base) as z:
            cfg = json.loads(str(z["config"]))
            arrays = tuple(z[name]
                           for name in accumulator_spec(cfg["mode"]).names)
        known = {"fill": set(_FILL_FNS) | {"megakernel"},
                 "distance": set(_DISTANCES)}
        for opt, names in known.items():
            value = cfg.get("resolved", {}).get(opt)
            if value in names:
                session_opts.setdefault(opt, value)
        if cfg.get("method_opts"):
            session_opts.setdefault("method_opts", cfg["method_opts"])
        sess = cls(x_train, y_train, k=cfg["k"], mode=cfg["mode"],
                   test_batch=cfg["test_batch"], **session_opts)
        if arrays[0].shape[0] != sess.x_train.shape[0]:
            raise ValueError(
                f"checkpoint is for n={arrays[0].shape[0]} train points, "
                f"got n={sess.x_train.shape[0]}"
            )
        sess._state = tuple(
            torch.from_numpy(np.asarray(a, np.float32)).to(sess.device)
            for a in arrays)
        sess._t = int(cfg["t"])
        return sess
