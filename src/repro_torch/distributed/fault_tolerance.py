"""Fault-tolerance runtime policies: step guard, health log, degradation.

Counterpart of `repro.distributed.fault_tolerance`; numpy apart from the
wait for a step's result.

  * StepGuard      -- deadline + retry around a step. Retries are spaced by
                      exponential backoff with DETERMINISTIC seeded jitter,
                      so a fleet of preempted workers does not thunder back
                      in lockstep yet every run is reproducible. Before the
                      clock is read it synchronizes every CUDA device that
                      holds a tensor of the step's output: PyTorch returns
                      before the card finishes, so without it the deadline
                      would time the launch, and an asynchronous fault of
                      one step would surface inside the next step's attempt
                      and be charged to the wrong batch.
  * degrade_plan   -- the graceful-degradation policy: given the train
                      size and the current shard count, the next smaller
                      usable shard count after a device loss.
  * HealthLog      -- per-step wall-time ring buffer; flags stragglers as
                      steps > mean + k*std over the PRECEDING window (the
                      sample under judgement never contaminates its own
                      baseline; it joins the window only after the verdict).

`repro_torch.core.resilient.ResilientValuationSession` drives the
streaming valuation engine through StepGuard + HealthLog + degrade_plan,
and the online service (`repro_torch.serving.valuation_service`) reuses
StepGuard for mutation refolds and HealthLog for request latencies.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["StepGuard", "HealthLog", "degrade_plan", "block_until_ready"]


def _cuda_devices(out, found: set) -> set:
    """Indices of the CUDA devices holding a tensor of `out` (nested
    tuples, lists and dicts; a grid's `Sharded` blocks)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device.index)
    elif hasattr(out, "tensors"):
        _cuda_devices(out.tensors(), found)
    elif isinstance(out, (tuple, list)):
        for item in out:
            _cuda_devices(item, found)
    elif isinstance(out, dict):
        for item in out.values():
            _cuda_devices(item, found)
    return found


def block_until_ready(out) -> None:
    """Wait until every CUDA device that holds a tensor of `out` has
    finished its queued work (the counterpart of
    `jax.block_until_ready`); a no-op for CPU tensors and host values. A
    fault of the queued work raises here."""
    for index in sorted(_cuda_devices(out, set())):
        torch.cuda.synchronize(index)


class HealthLog:
    """Per-step wall-time window with mean + k*sigma straggler flagging.

    Contract: a sample `dt` is judged against the statistics of the
    PRECEDING `window` samples only -- it is appended to the window after
    the outlier decision, so a genuine straggler cannot raise the mean it
    is compared against (and a burst of stragglers keeps being flagged
    instead of normalizing itself). The first `min_history` samples are
    never flagged (no stable baseline yet). Storage is bounded at `window`
    samples; `total` and `straggler_steps` survive the trimming so a
    long-running session can report them in its result metadata.
    """

    def __init__(self, window: int = 50, k_sigma: float = 3.0,
                 min_history: int = 8):
        self.window = int(window)
        self.k = float(k_sigma)
        self.min_history = int(min_history)
        self.times: list[float] = []
        self.total = 0
        self.straggler_steps: list[int] = []

    def record(self, dt: float) -> bool:
        """Record a step time; True if this step is a straggler outlier.

        The decision compares `dt` against mean + k*max(std, 0.05*mean) of
        the current window, which does NOT yet contain `dt` (see class
        docstring); only after the verdict is the sample folded in.
        """
        hist = self.times
        is_straggler = False
        if len(hist) >= self.min_history:
            mu, sd = float(np.mean(hist)), float(np.std(hist))
            is_straggler = dt > mu + self.k * max(sd, 0.05 * mu)
        if is_straggler:
            self.straggler_steps.append(self.total)
        self.total += 1
        self.times.append(dt)
        if len(self.times) > self.window:
            del self.times[: len(self.times) - self.window]
        return is_straggler

    def summary(self) -> dict:
        """JSON-able digest (step count, straggler count/indices, mean)."""
        return {
            "steps": self.total,
            "stragglers": len(self.straggler_steps),
            "straggler_steps": list(self.straggler_steps[-16:]),
            "mean_step_s": float(np.mean(self.times)) if self.times else 0.0,
        }


@dataclass
class StepGuard:
    """Runs a step with deadline + bounded retries + exponential backoff.

    Backoff before retry attempt a (a >= 1) sleeps
    ``backoff_s * backoff_factor**(a-1) * (1 + jitter)`` seconds, where
    jitter is drawn uniformly from [0, jitter_frac) by a PRNG seeded with
    `seed` -- deterministic across runs, decorrelated across differently
    seeded workers. `backoff_s=0` (the default) sleeps not at all.
    `sleep_fn` is injectable for tests.
    """

    deadline_s: float = float("inf")
    max_retries: int = 2
    on_retry: Optional[Callable[[int, Exception | str], None]] = None
    backoff_s: float = 0.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0
    jitter_frac: float = 0.25
    seed: int = 0
    sleep_fn: Callable[[float], None] = time.sleep
    _rng: np.random.Generator = field(init=False, repr=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def backoff_delay(self, attempt: int) -> float:
        """The (jittered, capped) sleep before retry `attempt` (1-based)."""
        if self.backoff_s <= 0.0:
            return 0.0
        base = self.backoff_s * self.backoff_factor ** max(attempt - 1, 0)
        jitter = 1.0 + self.jitter_frac * float(self._rng.random())
        return min(base * jitter, self.backoff_max_s)

    def run(self, fn, *args):
        """Call `fn(*args)` and wait for the devices of its result; returns
        (out, dt).

        Retries up to `max_retries` times on exception (device failure
        surfaces here, in the call or in the wait) or deadline overrun,
        sleeping `backoff_delay` between attempts; raises RuntimeError once
        the budget is exhausted.
        """
        err: Exception | str = ""
        for attempt in range(self.max_retries + 1):
            if attempt > 0:
                delay = self.backoff_delay(attempt)
                if delay > 0.0:
                    self.sleep_fn(delay)
            t0 = time.time()
            try:
                out = fn(*args)
                block_until_ready(out)
                dt = time.time() - t0
                if dt <= self.deadline_s:
                    return out, dt
                err = f"deadline exceeded ({dt:.1f}s > {self.deadline_s}s)"
            except Exception as e:  # device failure surfaces here
                # kept without its traceback: the frames it holds (the
                # step's closure, and so a session's device state) would
                # otherwise live on in a reference cycle with this frame
                err = e.with_traceback(None)
            if self.on_retry:
                self.on_retry(attempt, err)
        raise RuntimeError(f"step failed after {self.max_retries} retries: {err}")


def degrade_plan(n: int, current: int,
                 min_shards: int = 1) -> Optional[int]:
    """Next smaller usable shard count after losing device(s), or None.

    The row blocks must be exact, so the plan is the largest D < `current`
    with n % D == 0, floored at `min_shards` (the floor wins even when it
    does not divide n). None means no degradation is possible (`current`
    is already at or below the floor); the caller should re-raise / fail
    over instead.
    """
    current = int(current)
    min_shards = max(1, int(min_shards))
    if current <= min_shards:
        return None
    new = current - 1
    while new > min_shards and int(n) % new:
        new -= 1
    return max(new, min_shards)
