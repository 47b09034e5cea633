"""`ResilientValuationSession`: preemption-safe streaming valuation.

Counterpart of `repro.core.resilient`. It wraps the streaming engine
(`ValuationSession` / `ShardedValuationSession`) in the runtime that
survives failed steps, stragglers, NaN poisoning and torn writes:
`distributed.fault_tolerance` (StepGuard retries with backoff, HealthLog
straggler flagging), `checkpoint.Checkpointer` (atomic, checksummed, async
checkpoints) and `distributed.fault_injection` (the deterministic failure
hooks of the drills).

Guarantees:

  * EXACTLY-ONCE FOLD -- every incoming batch carries a sequence number;
    the checkpoint records how many batches the state contains, so after a
    restore a caller replays its stream from the start and already-folded
    batches are skipped. A recovered run finalizes BIT-IDENTICAL to an
    uninterrupted one (the same steps in the same order; checkpoint arrays
    round-trip f32-exact).
  * TRANSACTIONAL BATCHES -- a step that dies mid-fold leaves half-updated
    accumulators (the port's steps fold IN PLACE); before the retry the
    state is recovered from the last good checkpoint plus an in-memory
    replay buffer of the batches since.
  * NaN/Inf ROLLBACK -- after each fold the state is checked finite;
    poisoning triggers the same checkpoint-rollback-replay cycle (bounded
    by `max_rollbacks`).
  * GRACEFUL DEGRADATION -- when a sharded step exhausts its retry budget
    the session rebuilds on the first D' entries of its device list (the
    next divisor of n, down to `min_shards`), restores the dense
    checkpoint, replays, and continues; a single-device session re-raises.

Every array that crosses the session boundary is OWNED, because the port
writes its state in place: replay-buffer batches are host copies of what
the caller passed, checkpoint snapshots are host copies, `rebase` copies
its input, restored leaves are made from freshly loaded arrays. A rollback
or an async write thus never sees a later step's bits.

Checkpoints keep the JAX package's layout and config names (the distance
"plain"/"cuda" as "xla"/"pallas", the CUDA fill as "pallas"), so a
directory written by either package restores in the other. The drills
inject Python exceptions; a real CUDA fault is sticky (it poisons the
process's context) and is not recovered in process.

`finalize()` reports retries, rollbacks, degradations, straggler steps and
checkpoints under ``ValuationResult.meta["resilience"]``.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, _host_copy
from repro_torch.core.results import ValuationResult
from repro_torch.core.session import ShardedValuationSession, ValuationSession
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (
    HealthLog,
    StepGuard,
    degrade_plan,
)

__all__ = ["ResilientValuationSession"]

_CONFIG_KEY = "['config']"

# implementation names the two packages give differently, port -> JAX, for
# the checkpoint config both read; the reverse map reads a JAX config
_JAX_NAMES = {"distance": {"plain": "xla", "cuda": "pallas"},
              "fill": {"cuda": "pallas"}}
_PORT_NAMES = {"distance": {"xla": "plain", "pallas": "cuda",
                            "pallas_interpret": "cuda"},
               "fill": {"pallas": "cuda", "pallas_interpret": "cuda"}}


def _all_finite(state: tuple) -> bool:
    """True iff every array of the accumulator state (a tensor, or a
    sharded array's list of row blocks) is NaN/Inf-free. One host sync:
    the per-block verdicts stay on their devices until the end. Blocks of
    4096 rows bound the temporaries `torch.isfinite` makes (on an (n, n)
    f32 matrix it would allocate an |a| copy and boolean masks, 28 GiB at
    n = 65536)."""
    blocks = [a for arr in state
              for a in (arr if isinstance(arr, list) else [arr])]
    verdicts = [torch.isfinite(part).all().to(blocks[0].device)
                for a in blocks for part in torch.split(a, 4096)]
    return bool(torch.stack(verdicts).all())


def _owned_state(arrays) -> tuple:
    """Owned copies of whole state arrays (tensors stay on their device,
    anything else becomes an f32 numpy array)."""
    return tuple(a.detach().clone() if isinstance(a, torch.Tensor)
                 else np.array(a, np.float32, copy=True) for a in arrays)


def _counter(stats: dict, key: str):
    """A `StepGuard.on_retry` hook adding one to `stats[key]`."""

    def count(attempt: int, err) -> None:
        stats[key] += 1

    return count


def _read_config(ck: Checkpointer, step: int) -> dict:
    """Load the JSON config leaf of checkpoint `step` (needed before the
    session -- and hence the restore tree structure -- can be built)."""
    d = ck.dir / f"step_{step:08d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    for e in manifest["leaves"]:
        if e["key"] == _CONFIG_KEY:
            return json.loads(str(np.load(d / e["file"])))
    raise KeyError(f"checkpoint step {step} carries no config leaf")


class ResilientValuationSession:
    """Fault-tolerant wrapper around the streaming valuation sessions
    (see module docstring for the guarantees and recovery state machine).

    Parameters beyond the wrapped session's (`mode`, `k`, `test_batch`,
    `fill`, `distance`, `method_opts`, `device`, ...):

      * ckpt_dir / ckpt_every / keep -- checkpoint directory, cadence in
        batches (one batch = one `update()` call) and retention.
        `ckpt_every=0` disables checkpointing AND the replay buffer:
        failures then raise instead of recovering.
      * sharded / shards / devices -- wrap a `ShardedValuationSession`
        over `devices` (one per shard; may repeat a device) or, without a
        list, `shards` local cards; degradation keeps the first D' of the
        list.
      * deadline_s / max_retries / backoff_s / seed -- `StepGuard` budget.
      * nan_guard / max_rollbacks -- post-fold finiteness check and the
        rollback budget for it.
      * min_shards -- floor for graceful degradation (default 1).
      * injector -- optional `FaultInjector` (drills); None in production.
      * async_checkpoint -- overlap checkpoint writes with the next step;
        the snapshot is taken synchronously either way.
    """

    def __init__(self, x_train, y_train, *, ckpt_dir,
                 mode: str = "sti", k: int = 5,
                 ckpt_every: int = 8, keep: int = 4,
                 async_checkpoint: bool = True,
                 sharded: bool = False, shards: Optional[int] = None,
                 devices=None,
                 deadline_s: float = float("inf"), max_retries: int = 3,
                 backoff_s: float = 0.01, seed: int = 0,
                 nan_guard: bool = True, max_rollbacks: int = 3,
                 min_shards: int = 1,
                 injector=None, device="cuda",
                 **session_opts):
        self._x_train = x_train
        self._y_train = y_train
        self.mode = mode
        self.k = int(k)
        self.ckpt_every = int(ckpt_every)
        self.async_checkpoint = bool(async_checkpoint)
        self._devices = (None if devices is None
                         else [resolve_device(d) for d in devices])
        self._device = (self._devices[0] if self._devices
                        else resolve_device(device))
        self._sharded = (bool(sharded) or shards is not None
                         or devices is not None)
        self.nan_guard = bool(nan_guard)
        self.max_rollbacks = int(max_rollbacks)
        self.min_shards = max(1, int(min_shards))
        self._injector = injector
        self._session_opts = dict(session_opts, mode=mode, k=k)
        self._ckpt = Checkpointer(ckpt_dir, keep=keep)
        self._stats = {
            "retries": 0, "rollbacks": 0, "nan_detected": 0,
            "degradations": [], "replayed_skipped": 0,
            "checkpoint_steps": [],
        }
        # the retry hook counts into the stats dict, not through self: a
        # bound method would make the session a reference cycle, and its
        # (n, n) state would outlive `del` until the cycle collector ran
        self._guard = StepGuard(
            deadline_s=deadline_s, max_retries=max_retries,
            backoff_s=backoff_s, seed=seed,
            on_retry=_counter(self._stats, "retries"),
        )
        self._health = HealthLog()
        # _folded = batches in the current state; _arrived = batches this
        # process has been offered (replay dedupe compares the two)
        self._folded = 0
        self._arrived = 0
        self._buffer: list[tuple[int, np.ndarray, np.ndarray]] = []
        self._dirty = False   # state may be half-folded (failed attempt)
        self._build_inner(shards)

    # ------------------------------------------------------------ plumbing
    def _build_inner(self, shards: Optional[int]) -> None:
        if not self._sharded:
            self._inner = ValuationSession(
                self._x_train, self._y_train, device=self._device,
                **self._session_opts)
            return
        devices = None
        if self._devices is not None:
            from repro_torch.distributed.sharding import shard_count

            n = int(self._x_train.shape[0])
            count = len(self._devices) if shards is None else shard_count(
                n, shards, available=len(self._devices))
            devices = self._devices[:count]
            shards = None
        self._inner = ShardedValuationSession(
            self._x_train, self._y_train, shards=shards, devices=devices,
            device=self._device, **self._session_opts)

    @property
    def inner(self) -> ValuationSession:
        """The wrapped (possibly rebuilt-on-degradation) session."""
        return self._inner

    @property
    def shards(self) -> int:
        """Current shard count of the wrapped session (1 = single)."""
        return getattr(self._inner, "shards", 1)

    @property
    def t_seen(self) -> int:
        """Test points folded into the current state."""
        return self._inner.t_seen

    @property
    def batches_folded(self) -> int:
        """Batch sequence numbers folded so far (= next expected seq)."""
        return self._folded

    # ------------------------------------------------------------- updates
    def update(self, x_test_batch, y_test_batch) -> "ResilientValuationSession":
        """Fold one batch (one sequence number) with full fault handling.

        Batches must arrive in a deterministic order; after a restore the
        caller replays its stream from the start and the first
        `batches_folded` arrivals are skipped (exactly-once fold). Returns
        self (chainable).
        """
        seq = self._arrived
        self._arrived += 1
        if seq < self._folded:
            self._stats["replayed_skipped"] += 1
            return self
        if seq > self._folded:
            raise RuntimeError(
                f"batch gap: arrived seq {seq} but state holds "
                f"{self._folded}; the caller must replay in order")
        # owned host copies: the caller may reuse its buffers before a
        # replay reads them
        xb = _host_copy(x_test_batch)
        yb = _host_copy(y_test_batch)
        if self.ckpt_every > 0:
            self._buffer.append((seq, xb, yb))
        self._fold(seq, xb, yb)
        return self

    def _fold(self, seq: int, xb, yb, rollback_depth: int = 0) -> None:
        """Guarded, transactional fold of batch `seq`; on guard exhaustion
        degrade (sharded) or re-raise; on NaN/Inf roll back and refold."""

        def attempt():
            if self._dirty:
                self._recover_state(upto=seq)
                self._dirty = False
            if self._injector is not None:
                self._injector.before_step(seq)
            # dirty from here: an exception or deadline overrun below may
            # leave (or has left) a partial/duplicate fold in the state
            self._dirty = True
            self._inner.update(xb, yb)
            return self._inner._state

        try:
            # only the time is kept: a reference to the step's output here
            # would hold the (n, n) state through a rollback's reload
            dt = self._guard.run(attempt)[1]
        except RuntimeError:
            if not self._try_degrade():
                raise
            # degraded topology is live and recovered up to seq; refold the
            # batch that killed the old one (fresh guard budget)
            self._fold(seq, xb, yb, rollback_depth)
            return
        self._dirty = False
        self._health.record(dt)
        if self._injector is not None:
            self._inner._state = self._injector.poison_state(
                seq, self._inner._state)
        if self.nan_guard and not _all_finite(self._inner._state):
            self._stats["nan_detected"] += 1
            if self.ckpt_every <= 0:
                raise RuntimeError(
                    f"non-finite accumulator state after batch {seq} and "
                    f"no checkpointing to roll back to (ckpt_every=0)")
            if rollback_depth >= self.max_rollbacks:
                raise RuntimeError(
                    f"non-finite state persists after {rollback_depth} "
                    f"rollbacks at batch {seq}")
            self._stats["rollbacks"] += 1
            self._recover_state(upto=seq)
            self._fold(seq, xb, yb, rollback_depth + 1)
            return
        self._folded = seq + 1
        if self.ckpt_every > 0 and self._folded % self.ckpt_every == 0:
            self._checkpoint()

    # ------------------------------------------------------------ recovery
    def _recover_state(self, upto: int) -> None:
        """Restore the last good checkpoint and refold buffered batches
        with seq < `upto`, leaving the state exactly as it was before the
        failed/poisoned batch. Raw (unguarded) refolds: a failure here
        propagates to the enclosing guard attempt, whose retry runs the
        whole recovery again from a clean base."""
        self._ckpt.wait()
        step = self._ckpt.latest_verified_step()
        if step is None:
            n = int(self._inner.x_train.shape[0])
            self._inner._place_state(
                tuple(np.zeros(s, np.float32)
                      for s in self._inner._spec.shapes(n)))
            self._inner._t = 0
            self._folded = 0
        else:
            self._load_checkpoint(step)
        for q, xb, yb in self._buffer:
            if q < self._folded:
                continue
            if q >= upto:
                break
            if q > self._folded:
                raise RuntimeError(
                    f"replay buffer gap: need batch {self._folded}, next "
                    f"buffered is {q} (checkpoint too old for the buffer)")
            self._inner.update(xb, yb)
            self._folded = q + 1

    def _try_degrade(self) -> bool:
        """Rebuild the sharded session on fewer shards (next divisor of n
        below the current count); False when no degradation is possible
        (single-device session / already at min_shards). The fresh inner is
        marked dirty, so the caller's refold recovers it from the last good
        checkpoint + replay buffer before touching the failing batch."""
        cur = self.shards
        if not isinstance(self._inner, ShardedValuationSession):
            return False
        new = degrade_plan(
            int(self._inner.x_train.shape[0]), cur, self.min_shards
        )
        if new is None:
            return False
        self._stats["degradations"].append(
            {"from": int(cur), "to": int(new)})
        self._ckpt.wait()
        self._inner = None  # release the old shards' state first
        self._build_inner(new)
        self._dirty = True
        return True

    # ------------------------------------------------------------ mutations
    def rebase(self, state_arrays, *, t: int, seq: Optional[int] = None,
               x_train=None, y_train=None) -> None:
        """Install an externally recomputed state as the NEW ground truth.

        This is the train-set-mutation boundary of the online valuation
        service: `add_points`/`remove_points` refold the batch log against
        the mutated train set OUTSIDE the fold loop, then rebase.
        `state_arrays` are whole arrays (tensors on any device, or numpy);
        the session installs its own copy of them.

          * the replay buffer is CLEARED -- pre-mutation batches must never
            be refolded against the post-mutation train set;
          * a SYNCHRONOUS checkpoint of the rebased state is written at the
            current sequence number, so rollback/restore lands on this side
            of the mutation (overwriting any same-step pre-mutation
            checkpoint);
          * `t`/`seq` reset the fold counters to what the new state
            actually contains (`seq` defaults to whatever has arrived).
        """
        self._ckpt.wait()
        self._inner._state = None  # release the old state before copying
        state = _owned_state(state_arrays)
        if x_train is not None:
            self._x_train = x_train
            self._y_train = y_train
            self._inner.set_train(x_train, y_train)
        self._inner._place_state(state)
        self._inner._t = int(t)
        self._folded = int(seq) if seq is not None \
            else max(self._folded, self._arrived)
        self._arrived = self._folded
        self._buffer.clear()
        self._dirty = False
        if self.ckpt_every > 0:
            self._checkpoint(force=True)
            self._ckpt.wait()

    # --------------------------------------------------------- checkpoints
    def _config(self) -> dict:
        opts = {}
        for key, value in self._session_opts.items():
            if not isinstance(
                    value, (str, int, float, bool, dict, list, type(None))):
                continue
            opts[key] = _JAX_NAMES.get(key, {}).get(value, value) \
                if isinstance(value, str) else value
        return {
            "mode": self.mode, "k": self.k,
            "test_batch": int(self._inner.test_batch),
            "sharded": self._sharded, "shards": int(self.shards),
            "ckpt_every": self.ckpt_every, "session_opts": opts,
        }

    def _tree_like(self) -> dict:  # sync-point: checkpoint-tree host staging
        # the structure of `_state_tree`; the leaves are placeholders
        return {
            "config": np.asarray(""),
            "scalars": {"seq": np.int64(0), "t": np.int64(0)},
            "state": {nm: np.float32(0) for nm in self._inner._spec.names},
        }

    def _state_tree(self) -> dict:  # sync-point: checkpoint snapshot
        # the checkpointer snapshots each leaf to an owned host copy
        # synchronously (recovery semantics); only the WRITE overlaps the
        # next step under async_checkpoint
        return {
            "config": np.asarray(json.dumps(self._config())),
            "scalars": {"seq": np.int64(self._folded),
                        "t": np.int64(self._inner._t)},
            "state": {nm: a for nm, a in zip(
                self._inner._spec.names, self._inner._gathered_state())},
        }

    def checkpoint(self) -> None:
        """Write a checkpoint of the current state now (also done
        automatically every `ckpt_every` batches and at `finalize`)."""
        self._checkpoint(force=True)

    def _checkpoint(self, force: bool = False) -> None:
        steps = self._stats["checkpoint_steps"]
        if steps and steps[-1] == self._folded and not force:
            return
        tree = self._state_tree()
        if self.async_checkpoint:
            self._ckpt.save_async(self._folded, tree)
        else:
            self._ckpt.save(self._folded, tree)
        del tree
        steps.append(self._folded)
        if self._injector is not None:
            self._injector.after_checkpoint(self._folded, self._ckpt)
        # trim the replay buffer with ONE checkpoint of lag, so a rollback
        # still has the batches it needs if the newest checkpoint itself
        # turns out corrupted on disk
        keep_from = steps[-2] if len(steps) >= 2 else 0
        self._buffer = [e for e in self._buffer if e[0] >= keep_from]

    def _load_checkpoint(self, step: int) -> None:
        tree, _ = self._ckpt.restore(self._tree_like(), step)
        names = self._inner._spec.names
        self._inner._state = None  # release the old state first
        self._inner._place_state(
            tuple(tree["state"][nm] for nm in names))
        self._inner._t = int(tree["scalars"]["t"])
        self._folded = int(tree["scalars"]["seq"])
        self._dirty = False

    @classmethod
    def restore(cls, ckpt_dir, x_train, y_train, *,
                step: Optional[int] = None, injector=None, device="cuda",
                **overrides) -> "ResilientValuationSession":
        """Rebuild a session on `device` (or an override `devices=` list)
        from the newest VERIFIED checkpoint in `ckpt_dir` -- of either
        package; corrupted steps are skipped via the Checkpointer's sha256
        fallback walk -- plus the fixed training set.

        `overrides` replace checkpointed constructor options -- e.g.
        ``shards=2`` or ``devices=["cuda"] * 2`` to restore a stream
        checkpointed under 8 shards onto 2 (the dense checkpoint is
        shard-count independent). The restored session expects its caller
        to replay the batch stream from the START: the first
        `batches_folded` arrivals are skipped.
        """
        devices = overrides.get("devices")
        resolve_device(devices[0] if devices else device)  # fail early
        ck = Checkpointer(ckpt_dir)
        use = step if step is not None else ck.latest_verified_step()
        if use is None:
            raise FileNotFoundError(
                f"no (uncorrupted) checkpoint in {ckpt_dir}")
        cfg = _read_config(ck, use)
        kwargs = {key: _PORT_NAMES.get(key, {}).get(value, value)
                  if isinstance(value, str) else value
                  for key, value in cfg.get("session_opts", {}).items()}
        kwargs.update(
            mode=cfg["mode"], k=cfg["k"], test_batch=cfg["test_batch"],
            ckpt_every=cfg.get("ckpt_every", 8), device=device,
        )
        if cfg.get("sharded"):
            kwargs.setdefault("sharded", True)
            kwargs.setdefault("shards", cfg.get("shards"))
        kwargs.update(overrides)
        if kwargs.get("devices") is not None:
            kwargs["shards"] = None
        sess = cls(x_train, y_train, ckpt_dir=ckpt_dir, injector=injector,
                   **kwargs)
        sess._load_checkpoint(use)
        return sess

    # ------------------------------------------------------------- results
    def resilience_summary(self) -> dict:
        """JSON-able digest of everything the runtime absorbed: retries,
        rollbacks, degradations, skipped replays, checkpoints, stragglers."""
        return {
            **{k_: (list(v) if isinstance(v, list) else v)
               for k_, v in self._stats.items()},
            "shards": int(self.shards),
            "health": self._health.summary(),
        }

    def finalize(self, checkpoint: bool = True) -> ValuationResult:
        """Checkpoint (unless disabled), snapshot the running mean, and
        attach the resilience story under ``meta["resilience"]``."""
        if checkpoint and self.ckpt_every > 0 and self._folded > 0:
            self._checkpoint()
            self._ckpt.wait()
        result = self._inner.finalize()
        return result.with_meta(
            resilient=True, resilience=self.resilience_summary())
