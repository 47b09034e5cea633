"""Training loop of the port: counterpart of `repro.training.trainer`.

`Trainer(cfg, tcfg, device="cuda")` trains one model on one device: the
loss and its gradients by autograd (each layer group recomputed in the
backward pass, `cfg.remat`), gradient accumulation over micro-batches,
AdamW in place (`training.optimizer`), a `StepGuard` around the loss
and gradients of every step (deadline, bounded retries), a `HealthLog`
of step times (stragglers), an asynchronous checkpoint of (params,
opt_state) every `ckpt_every` steps and `maybe_restore` from the newest
verified one, and batches from a deterministic `batch_fn(step)` through
a `ShardedPrefetchLoader`.

Only the gradient phase is retried: it reads the state and writes none.
The update writes the parameters and moments in place (a second copy of
either is 8 GB at qwen3-1.7b's width), so it is never run twice: a fault
inside it, or a step that overruns its deadline once it has started,
raises and leaves the run to `maybe_restore`. The reference reaches the
same end by donating (params, opt_state) to its jitted step, whose
buffers a second attempt could not read.

Checkpoints hold the reference's leaves under the reference's keys, so a
run resumes across the two packages in either direction.

`Trainer(cfg, tcfg, mesh=grid)` lays the step over a ("data", "model")
`DeviceGrid`, as the reference lays it over a mesh: the strategy is
`tcfg.strategy` or `strategy_for(cfg)`, and params and both AdamW moments
are stored as `Sharded` blocks of `tree_named(grid, param_spec(
rules_for(...)))`. Each step splits the batch over the data rows when it
divides them, else runs it whole on data row 0 (the reference's
`_maybe_replicate_batch`); the weights are gathered onto each row's
device at use (each row reading its own replica of what is replicated
over "data"), the gradients of each index range are summed over its
replicas, and AdamW updates every block in place
(`distributed/grid_step.py`). As in the reference, the config is not
changed: no `fsdp_constrain` cast, and no `shmap_axes`, so an MoE block
routes the tokens of all rows as one batch and its groups, drops and aux
loss are the single-device run's.
`maybe_restore` restores onto the grid's placements.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import (
    ModelConfig, tree_leaves, tree_map, tree_unflatten)
from repro_torch.data.pipeline import ShardedPrefetchLoader
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.fault_tolerance import (
    HealthLog, StepGuard, block_until_ready)
from repro_torch.distributed.grid_step import GridRun, update, zero_moments
from repro_torch.models import build_model
from repro_torch.training.optimizer import (
    AdamState, AdamWConfig, adamw_init, adamw_update)

__all__ = ["TrainerConfig", "Trainer"]


@dataclass
class TrainerConfig:
    steps: int = 100
    grad_accum: int = 1
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    step_deadline_s: float = float("inf")
    strategy: Optional[str] = None   # "tp_dp" | "fsdp"; None: strategy_for
    opt: AdamWConfig = field(default_factory=AdamWConfig)


class Trainer:
    """One model trained on one device, or on a `DeviceGrid` (`mesh`; see
    the module docstring)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 device="cuda", *, mesh: Optional[SH.DeviceGrid] = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = (resolve_device(device) if mesh is None
                       else mesh.device(0, 0))
        self.model = build_model(cfg)
        if mesh is not None:
            strategy = tcfg.strategy or SH.strategy_for(cfg)
            self.rules = SH.rules_for(cfg, strategy, mesh)
            self.pspec = self.model.param_spec(self.rules)
            self.psharding = SH.tree_named(mesh, self.pspec)
        self.ckpt = Checkpointer(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
        self.health = HealthLog()
        self.guard = StepGuard(deadline_s=tcfg.step_deadline_s,
                               on_retry=self._on_retry)

    @staticmethod
    def _on_retry(attempt, err):
        print(f"[fault-tolerance] step retry {attempt}: {err}")

    # ------------------------------------------------------------- init
    def init_state(self, seed: int = 0):
        """(params, opt_state): f32 params drawn from a generator seeded
        with `seed` on the training device, zero AdamW moments."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = self.model.init(gen, device=self.device)
        if self.mesh is None:
            return params, adamw_init(params)
        params = tree_map(lambda pl, p: pl.place(p), self.psharding, params)
        return params, zero_moments(params, self.device)

    def maybe_restore(self, params, opt_state):
        """(params, opt_state, start_step): the newest verified checkpoint
        of `ckpt_dir` (either package's), else the arguments and 0."""
        start = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            placements = None if self.mesh is None else (
                self.psharding, AdamState(self.psharding, self.psharding,
                                          None))
            (params, opt_state), start = self.ckpt.restore(
                (params, opt_state), devices=self.device,
                placements=placements)
            print(f"[restore] resumed from step {start}")
        return params, opt_state, start

    # ------------------------------------------------------------- step
    def _loss_and_grads(self, params, leaves, batch):
        """(loss, metrics, grads) of one batch: grad_accum micro-batches,
        their gradients summed in order and divided by grad_accum."""
        accum = self.tcfg.grad_accum
        if accum == 1:
            loss, metrics = self.model.loss_fn(params, batch)
            return loss, metrics, list(torch.autograd.grad(loss, leaves))
        size = next(iter(batch.values())).shape[0]
        if size % accum:
            raise ValueError(f"batch of {size} does not split into "
                             f"grad_accum={accum} micro-batches")
        grads, loss_sum = None, 0
        for mb in range(accum):
            part = {k: v[mb * (size // accum):(mb + 1) * (size // accum)]
                    for k, v in batch.items()}
            loss, metrics = self.model.loss_fn(params, part)
            g = torch.autograd.grad(loss, leaves)
            grads = list(g) if grads is None else [
                a.add_(b) for a, b in zip(grads, g)]
            loss_sum = loss_sum + loss.detach()
        return loss_sum / accum, metrics, [g / accum for g in grads]

    def _gradients(self, params, batch):
        """(loss, metrics, grads) of one batch, the parameters left as they
        were: the part of a step that is safe to run again. On a grid the
        grads are one per index range (`grid_step.range_grads`)."""
        if self.mesh is not None:
            return GridRun(self.model, self.mesh, params).grads(
                batch, self.tcfg.grad_accum)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics, grads = self._loss_and_grads(params, leaves,
                                                            batch)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def _apply(self, params, opt_state, grads):
        """AdamW in place -> (params, opt_state, {"grad_norm", "lr"})."""
        if self.mesh is not None:
            count, om = update(self.tcfg.opt, grads, opt_state, params)
            return params, AdamState(opt_state.mu, opt_state.nu, count), om
        return adamw_update(self.tcfg.opt, tree_unflatten(params, grads),
                            opt_state, params)

    def step(self, params, opt_state, batch):
        """One training step, params and moments updated in place ->
        (params, opt_state, metrics): loss, ce, aux, grad_norm and lr, 0-d
        tensors on the device. Unguarded: `fit` guards its steps."""
        loss, metrics, grads = self._gradients(params, batch)
        params, opt_state, om = self._apply(params, opt_state, grads)
        return params, opt_state, dict(metrics, loss=loss, **om)

    def _guarded_step(self, params, opt_state, batch):
        """`step` under the guard -> (params, opt_state, metrics, dt). The
        gradient phase is retried; the in-place update runs once, and a
        fault inside it or an overrun of the whole step raises."""
        t0 = time.time()
        (loss, metrics, grads), _ = self.guard.run(self._gradients, params,
                                                   batch)
        try:
            params, opt_state, om = self._apply(params, opt_state, grads)
            block_until_ready((params, opt_state))
        except Exception as e:
            raise RuntimeError(
                "the in-place optimizer update failed part way: params and "
                "opt_state no longer belong to one step; resume from the "
                "last checkpoint (maybe_restore)") from e
        dt = time.time() - t0
        if dt > self.tcfg.step_deadline_s:
            raise RuntimeError(
                f"step overran its deadline ({dt:.1f}s > "
                f"{self.tcfg.step_deadline_s}s) after the in-place update; "
                f"not retried, as a retry would apply the update twice")
        return params, opt_state, dict(metrics, loss=loss, **om), dt

    # -------------------------------------------------------------- run
    def fit(self, params, opt_state, batch_fn: Callable[[int], Any],
            start_step: int = 0):
        """Train from `start_step` to `tcfg.steps`. batch_fn(step) -> host
        batch, deterministic in step, so restarts see the same data.
        Returns (params, opt_state, metrics history)."""
        metrics_hist = []
        loader = ShardedPrefetchLoader(batch_fn, self.device,
                                       start_step=start_step)
        try:
            for s in range(start_step, self.tcfg.steps):
                step_idx, batch = next(loader)
                if step_idx != s:
                    raise RuntimeError(f"loader at step {step_idx}, "
                                       f"trainer at {s}")
                params, opt_state, metrics, dt = self._guarded_step(
                    params, opt_state, batch)
                if self.health.record(dt):
                    print(f"[straggler] step {s} took {dt:.2f}s")
                if s % self.tcfg.log_every == 0 or s == self.tcfg.steps - 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    metrics_hist.append({"step": s, "time_s": dt, **m})
                    print(f"step {s:5d} loss {m['loss']:.4f} "
                          f"gnorm {m.get('grad_norm', 0):.2f} "
                          f"{dt * 1e3:.0f}ms")
                if self.ckpt and (s + 1) % self.tcfg.ckpt_every == 0:
                    self.ckpt.save_async(s + 1, (params, opt_state))
        finally:
            loader.close()
        if self.ckpt:
            self.ckpt.wait()
        return params, opt_state, metrics_hist
