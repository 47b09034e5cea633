"""Atomic, checksummed, optionally async checkpoints of nested arrays.

Counterpart of `repro.checkpoint.checkpointer`, with the same on-disk
layout byte for byte, so a directory written by either package restores in
the other:

    <dir>/step_<N>/
        MANIFEST.json          {step, leaves: [{key, file, shape, dtype,
                                sha256}], done}
        <leaf-hash>.npy        one file per leaf (np.save)

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors, numpy arrays or numpy scalars. It is flattened as
`jax.tree_util` flattens it: dict keys in sorted order, None an empty
node. Each leaf's key is JAX's `keystr` of its path (``['state']['acc']``,
``[0]``, ``[1].mu['embed']`` for a NamedTuple field) and its file name
the first 12 hex digits of the key's md5.

Atomicity: a step is written to step_<N>.tmp, fsync'd, then renamed -- a
crashed write can never be mistaken for a valid checkpoint.

Integrity: every leaf file's sha256 is recorded in the MANIFEST and
verified on restore. A corrupted leaf makes `restore(step=None)` SKIP that
step and fall back to the previous done=true checkpoint; restoring an
explicitly requested corrupt step raises `CheckpointCorruptionError`.

Async: `save_async` takes the host snapshot synchronously and writes on a
daemon thread, overlapping the disk with the next step; `wait()` joins.
The snapshot is an OWNED host copy of every leaf: the port's steps
accumulate into their state in place, so a leaf that shared memory with
the live state (a CPU tensor's `.numpy()`, a caller's array) would be
written with a later step's bits.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["Checkpointer", "CheckpointCorruptionError"]


class CheckpointCorruptionError(RuntimeError):
    """An explicitly requested checkpoint step failed sha256 verification."""


class _Field(str):
    """A NamedTuple field in a path: JAX's `GetAttrKey`, ``.name`` in a
    key."""


def _flatten(tree: Any, path: tuple = (), keep_none: bool = False
             ) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs of `tree` in `jax.tree_util` order: dict keys
    sorted, lists and tuples in order, None contributing no leaf (or, with
    `keep_none`, a None leaf)."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], path + (key,), keep_none)
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name, item in zip(tree._fields, tree):
            out += _flatten(item, path + (_Field(name),), keep_none)
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, item in enumerate(tree):
            out += _flatten(item, path + (i,), keep_none)
        return out
    if tree is None and not keep_none:
        return []
    return [(path, tree)]


def _unflatten(tree_like: Any, leaves) -> Any:
    """`tree_like`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if isinstance(tree_like, dict):
        return {key: _unflatten(tree_like[key], leaves)
                for key in sorted(tree_like)}
    if isinstance(tree_like, (list, tuple)):
        items = [_unflatten(item, leaves) for item in tree_like]
        if hasattr(tree_like, "_fields"):
            return type(tree_like)(*items)
        return type(tree_like)(items) if isinstance(tree_like, tuple) \
            else items
    if tree_like is None:
        return None
    return next(leaves)


def _keystr(path: tuple) -> str:
    """JAX's `keystr` of a path: ``['name']`` for a dict key, ``[i]`` for
    a sequence index, ``.name`` for a NamedTuple field."""
    return "".join(f".{key}" if isinstance(key, _Field)
                   else f"[{key!r}]" if isinstance(key, str) else f"[{key}]"
                   for key in path)


def _leaf_name(path: tuple) -> str:
    return hashlib.md5(_keystr(path).encode()).hexdigest()[:12]


def _file_sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _host_copy(x) -> np.ndarray:
    """An owned host numpy copy of a leaf: a tensor (a CUDA tensor's
    device-to-host copy; a CPU tensor cloned), a grid's `Sharded` blocks
    (gathered whole, so the file is the reference's), a numpy array or
    scalar (copied)."""
    if hasattr(x, "gather") and hasattr(x, "placement"):
        return x.gather(torch.device("cpu")).detach().numpy()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.to("cpu") if x.is_cuda else x.clone()).numpy()
    return np.array(x, copy=True)


class Checkpointer:
    """Atomic, checksummed, optionally async checkpoint store of nested
    arrays (see module docstring for the on-disk layout and guarantees)."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- save
    def save(self, step: int, tree: Any):
        """Synchronously write `tree` as checkpoint `step` (atomic)."""
        self.wait()
        self._write(step, self._snapshot(tree))

    def save_async(self, step: int, tree: Any):
        """Snapshot `tree` to owned host copies NOW, write on a daemon
        thread (overlaps disk I/O with the next step; `wait()` joins)."""
        self.wait()
        snap = self._snapshot(tree)  # host copy BEFORE returning
        self._thread = threading.Thread(
            target=self._write, args=(step, snap), daemon=True)
        self._thread.start()

    def wait(self):
        """Join any in-flight `save_async` write (no-op when idle)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _snapshot(self, tree) -> list[tuple[tuple, np.ndarray]]:
        return [(p, _host_copy(x)) for p, x in _flatten(tree)]

    def _write(self, step: int, leaves):
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": [], "done": False}
        for path, arr in leaves:
            name = _leaf_name(path)
            np.save(tmp / f"{name}.npy", arr)
            manifest["leaves"].append({
                "key": _keystr(path),
                "file": f"{name}.npy",
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "sha256": _file_sha256(tmp / f"{name}.npy"),
            })
        manifest["done"] = True
        mf = tmp / "MANIFEST.json"
        mf.write_text(json.dumps(manifest))
        fd = os.open(tmp, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
        if final.exists():
            # overwrite (e.g. a rebase checkpoint at an already-written
            # step): move the old directory aside FIRST so there is no
            # instant with neither version on disk, then drop it
            old = self.dir / f"step_{step:08d}.old.tmp"
            if old.exists():
                shutil.rmtree(old)
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, final)
        self.prune()

    def prune(self, keep_last: Optional[int] = None) -> list[int]:
        """Retention policy: drop all but the newest `keep_last` steps
        (default: the constructor's `keep`), returning the pruned steps.

        VERIFICATION-AWARE: if none of the survivors passes sha256
        verification, the newest VERIFIED older step is retained as well --
        pruning never removes the last good restore point. Checked
        newest-first, so the common case (the just-written step verifies)
        costs one checksum pass.

        Deletion is ATOMIC per step: the directory is renamed to a
        `.prune.tmp` name -- invisible to `all_steps` -- before removal.
        """
        keep = self.keep if keep_last is None else int(keep_last)
        steps = self.all_steps()
        if keep < 1 or len(steps) <= keep:
            return []
        survivors = set(steps[-keep:])
        if not any(self.verify_step(s)
                   for s in sorted(survivors, reverse=True)):
            for s in reversed(steps[:-keep]):
                if self.verify_step(s):
                    survivors.add(s)
                    break
        pruned = []
        for s in steps:
            if s in survivors:
                continue
            trash = self.dir / f"step_{s:08d}.prune.tmp"
            if trash.exists():
                shutil.rmtree(trash)
            try:
                os.rename(self.dir / f"step_{s:08d}", trash)
            except OSError:
                continue
            shutil.rmtree(trash, ignore_errors=True)
            pruned.append(s)
        return pruned

    # -------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        """Sorted step numbers of every done=true checkpoint directory."""
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "MANIFEST.json").exists():
                continue
            try:
                m = json.loads((p / "MANIFEST.json").read_text())
            except json.JSONDecodeError:
                continue
            if m.get("done"):
                out.append(m["step"])
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """Newest done=true step number, or None when the store is empty."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify_step(self, step: int) -> bool:
        """True iff every leaf file of `step` matches its MANIFEST sha256.

        Leaves written before checksums existed (no "sha256" entry) are
        trusted; a missing file or digest mismatch fails the whole step.
        """
        d = self.dir / f"step_{step:08d}"
        try:
            manifest = json.loads((d / "MANIFEST.json").read_text())
        except (OSError, json.JSONDecodeError):
            return False
        for e in manifest.get("leaves", []):
            want = e.get("sha256")
            if want is None:
                continue
            f = d / e["file"]
            if not f.exists() or _file_sha256(f) != want:
                return False
        return True

    def latest_verified_step(self) -> Optional[int]:
        """Newest done=true step that passes checksum verification (the
        fallback walk: corrupt steps are skipped, never loaded)."""
        for step in reversed(self.all_steps()):
            if self.verify_step(step):
                return step
        return None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                devices: Any = None, placements: Any = None
                ) -> tuple[Any, int]:
        """Restore into the structure of `tree_like` (its leaves are only
        placeholders). Leaves come back as numpy arrays; with `devices`
        (one device for every leaf, or a tree of `tree_like`'s structure
        naming a device or None per leaf) a numeric leaf comes back as a
        tensor on its device, owned (made from the loaded array). With
        `placements` (a tree of `tree_like`'s structure naming a
        `distributed.sharding.Placement` or None per leaf: `tree_named`'s,
        the counterpart of the reference's `shardings=`) a leaf with a
        placement comes back laid over its grid, whatever grid wrote it;
        the other leaves go by `devices`.

        With `step=None` the newest checkpoint whose leaf checksums verify
        is used -- a corrupted step directory is skipped in favour of the
        previous done=true one. An explicitly requested `step` that fails
        verification raises `CheckpointCorruptionError`.
        """
        if step is None:
            step = self.latest_verified_step()
            if step is None:
                raise FileNotFoundError(
                    f"no (uncorrupted) checkpoint in {self.dir}")
        elif not self.verify_step(step):
            raise CheckpointCorruptionError(
                f"checkpoint step {step} in {self.dir} failed sha256 "
                f"verification")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        by_key = {e["key"]: e for e in manifest["leaves"]}
        leaves = _flatten(tree_like)
        if devices is None or isinstance(devices, (str, torch.device)):
            placement = [devices] * len(leaves)
        else:
            placement = [dev for _, dev in _flatten(devices, keep_none=True)]
        laid = ([None] * len(leaves) if placements is None else
                [pl for _, pl in _flatten(placements, keep_none=True)])
        out = []
        for (path, _), dev, pl in zip(leaves, placement, laid):
            arr = np.load(d / by_key[_keystr(path)]["file"])
            if pl is not None:
                arr = pl.place(torch.from_numpy(arr))
            elif dev is not None and arr.dtype.kind in "biuf":
                arr = torch.from_numpy(arr).to(dev)
            out.append(arr)
        return _unflatten(tree_like, iter(out)), step
