"""Deterministic fault injection for the resilient valuation runtime.

Counterpart of `repro.distributed.fault_injection`. Real preemptions and
device losses cannot be scheduled in a test, so the failure modes are
injectable, seeded hooks that `repro_torch.core.resilient.
ResilientValuationSession` calls at fixed points of its fold loop:

  * ``kind="device"``       -- `before_step` raises `InjectedDeviceFailure`
                               (the exception path a lost card or a
                               preempted worker surfaces through);
  * ``kind="deadline"``     -- `before_step` stalls for `delay_s` seconds,
                               driving the step past a `StepGuard` deadline
                               (straggler simulation);
  * ``kind="nan"``          -- `poison_state` returns the state with one
                               accumulator element set to NaN (silent
                               numeric corruption, e.g. a bad collective);
  * ``kind="ckpt_corrupt"`` -- `after_checkpoint` flips one byte inside one
                               leaf file of the newest on-disk checkpoint
                               (torn write / bit rot), which the
                               Checkpointer's sha256 verification must
                               catch on restore.

Faults fire at an exact batch sequence number (`at_seq`) for an exact
number of attempts (`times`), so every drill is reproducible; the choice of
array, element, leaf file and byte comes from `np.random.default_rng(seed)`
in the same order as in the JAX package, so one seed poisons the same
element and flips the same byte in both. `FaultInjector.events` records
every firing.

These are Python exceptions and Python-side writes. A real CUDA fault (an
illegal address) is sticky: it poisons the process's CUDA context, and no
in-process retry recovers from it; the drills do not model that.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch

__all__ = [
    "Fault",
    "FaultInjector",
    "InjectedFault",
    "InjectedDeviceFailure",
    "corrupt_checkpoint_leaf",
]


class InjectedFault(RuntimeError):
    """Base class for failures raised by the injection harness."""


class InjectedDeviceFailure(InjectedFault):
    """Simulated device loss / worker preemption inside a step."""


@dataclass
class Fault:
    """One scheduled failure (see module docstring for the kinds).

    `at_seq` is the batch sequence number the fault arms at; `times` is how
    many consecutive step ATTEMPTS it fires for ("device"/"deadline" --
    `times` larger than the guard's retry budget forces guard exhaustion,
    which is the kill / degradation trigger), and `delay_s` is the stall
    injected by "deadline". "nan" and "ckpt_corrupt" fire once; for
    "ckpt_corrupt" `at_seq` means "the first checkpoint written at or after
    this sequence number". `seed` picks the poisoned element / flipped byte.
    """

    kind: str                 # "device" | "deadline" | "nan" | "ckpt_corrupt"
    at_seq: int
    times: int = 1
    delay_s: float = 0.0
    seed: int = 0
    _remaining: int = field(init=False, repr=False)

    def __post_init__(self):
        if self.kind not in ("device", "deadline", "nan", "ckpt_corrupt"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        self._remaining = int(self.times)


def _poisoned(arr, idx: tuple):
    """A copy of state array `arr` with element `idx` set to NaN; `arr` is
    untouched. `arr` is a tensor, or a sharded array's list of row blocks
    (`ShardedValuationSession`), whose global row idx[0] lies in block
    idx[0] // rows-per-block: only that block is copied."""
    if isinstance(arr, torch.Tensor):
        out = arr.clone()
        out[idx] = float("nan")
        return out
    rows = arr[0].shape[0]
    b = idx[0] // rows
    block = arr[b].clone()
    block[(idx[0] % rows,) + tuple(idx[1:])] = float("nan")
    return list(arr[:b]) + [block] + list(arr[b + 1:])


def _global_shape(arr) -> tuple:
    """Shape of a state array, a list of row blocks counted whole."""
    if isinstance(arr, torch.Tensor):
        return tuple(arr.shape)
    rows = sum(int(block.shape[0]) for block in arr)
    return (rows,) + tuple(arr[0].shape[1:])


class FaultInjector:
    """Deterministic schedule of `Fault`s, consumed by the resilient
    session's hooks; `events` is the audit log of every firing."""

    def __init__(self, faults: Iterable[Fault] = (),
                 sleep_fn=time.sleep):
        self.faults = list(faults)
        self.events: list[dict] = []
        self._sleep = sleep_fn

    def _fire(self, kind: str, seq: int, **extra) -> None:
        self.events.append({"kind": kind, "seq": int(seq), **extra})

    def fired(self, kind: Optional[str] = None) -> list[dict]:
        """Events recorded so far, optionally filtered by fault kind."""
        if kind is None:
            return list(self.events)
        return [e for e in self.events if e["kind"] == kind]

    # ------------------------------------------------------------- hooks
    def before_step(self, seq: int) -> None:
        """Called at the start of every step ATTEMPT (including retries):
        raises for an armed "device" fault, stalls for "deadline"."""
        for f in self.faults:
            if f.at_seq != seq or f._remaining <= 0:
                continue
            if f.kind == "device":
                f._remaining -= 1
                self._fire("device", seq, remaining=f._remaining)
                raise InjectedDeviceFailure(
                    f"injected device failure at batch seq {seq}")
            if f.kind == "deadline":
                f._remaining -= 1
                self._fire("deadline", seq, delay_s=f.delay_s)
                self._sleep(f.delay_s)

    def poison_state(self, seq: int, state: tuple) -> tuple:
        """Called after a successful fold: when a "nan" fault is armed at
        `seq`, returns `state` with one element of one array replaced by
        NaN (seeded choice) in a COPY of that array -- the live tensors are
        never written, so a host snapshot or replay input that shares
        their memory stays clean; else returns `state` unchanged."""
        for f in self.faults:
            if f.kind != "nan" or f.at_seq != seq or f._remaining <= 0:
                continue
            f._remaining -= 1
            rng = np.random.default_rng(f.seed)
            i = int(rng.integers(len(state)))
            shape = _global_shape(state[i])
            flat_idx = int(rng.integers(int(np.prod(shape))))
            idx = tuple(int(j) for j in np.unravel_index(flat_idx, shape))
            self._fire("nan", seq, array=i, index=list(idx))
            return state[:i] + (_poisoned(state[i], idx),) + state[i + 1:]
        return state

    def after_checkpoint(self, seq: int, checkpointer) -> None:
        """Called after a checkpoint save has been issued: corrupts one leaf
        of the newest on-disk step when a "ckpt_corrupt" fault is armed at
        or before `seq` (waits for the async write first, so the corruption
        lands on complete bytes the way bit rot / a torn write would)."""
        for f in self.faults:
            if f.kind != "ckpt_corrupt" or seq < f.at_seq or f._remaining <= 0:
                continue
            f._remaining -= 1
            checkpointer.wait()
            step = checkpointer.latest_step()
            if step is None:  # nothing on disk yet; fault stays spent
                self._fire("ckpt_corrupt", seq, step=None)
                return
            info = corrupt_checkpoint_leaf(
                checkpointer.dir, step, seed=f.seed)
            self._fire("ckpt_corrupt", seq, step=step, **info)


def corrupt_checkpoint_leaf(ckpt_dir, step: Optional[int] = None,
                            seed: int = 0) -> dict:
    """Flip one byte in one `.npy` leaf of checkpoint `step` (default: the
    newest step directory) -- the seeded, reproducible stand-in for bit rot
    or a torn write. Returns {"file": name, "offset": byte} for logging.
    The MANIFEST sha256 of that leaf no longer matches, so restore must
    skip the directory."""
    d = Path(ckpt_dir)
    if step is None:
        dirs = sorted(p for p in d.glob("step_*") if p.is_dir()
                      and p.suffix != ".tmp")
        if not dirs:
            raise FileNotFoundError(f"no checkpoint directories in {d}")
        target = dirs[-1]
    else:
        target = d / f"step_{step:08d}"
    leaves = sorted(target.glob("*.npy"))
    if not leaves:
        raise FileNotFoundError(f"no leaf files in {target}")
    rng = np.random.default_rng(seed)
    leaf = leaves[int(rng.integers(len(leaves)))]
    size = leaf.stat().st_size
    # flip a byte in the payload half so the npy header stays parseable --
    # the corruption must be caught by the CHECKSUM, not by np.load crashing.
    # The byte is rewritten in place: a leaf may be a 16 GiB accumulator.
    offset = size // 2 + int(rng.integers(max(size // 4, 1)))
    offset = min(offset, size - 1)
    with open(leaf, "r+b") as fh:
        fh.seek(offset)
        byte = fh.read(1)[0]
        fh.seek(offset)
        fh.write(bytes([byte ^ 0xFF]))
    return {"file": leaf.name, "offset": offset}
