"""AdamW, the cosine schedule and global-norm clipping over the port's
params trees: counterpart of `repro.training.optimizer`.

The state mirrors the parameter tree (`AdamState(mu, nu, count)`, the
JAX NamedTuple's fields in its order), so a checkpoint of
(params, opt_state) is the reference's leaf for leaf and crosses packages
both ways (`checkpoint.checkpointer`). Where the JAX update returns new
trees (and its trainer donates the old), `adamw_update` writes the
parameters and moments in place and returns the same trees: at qwen3-1.7b's
width a second copy of either is 8 GB. The arithmetic is the reference's,
term for term, in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import tree_leaves, tree_map

__all__ = ["AdamWConfig", "AdamState", "adamw_init", "adamw_update",
           "adamw_step", "cosine_schedule", "global_norm",
           "clip_by_global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class AdamState(NamedTuple):
    """First and second moments (trees of f32 tensors shaped like the
    params) and the int32 step count, a 0-d tensor."""
    mu: Any
    nu: Any
    count: torch.Tensor


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """step (a tensor) -> the learning rate, an f32 tensor on its device:
    linear warmup to `lr` over `warmup_steps`, then a cosine down to
    `min_lr_frac * lr` at `total_steps`."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = step / max(cfg.warmup_steps, 1)
        prog = torch.clamp(
            (step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)
    return sched


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over every leaf of sum(x^2) in f32, leaves added in
    tree order."""
    total = 0
    for x in tree_leaves(tree):
        part = torch.sum(torch.square(x.to(torch.float32)))
        total = part if isinstance(total, int) else total + part.to(
            total.device)
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / norm), norm). The leaves are
    scaled in place (each keeps its type); returns the same tree."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    for x in tree_leaves(tree):
        x.mul_(scale.to(x.device))   # an f32 product, rounded once
    return tree, g


def adamw_init(params) -> AdamState:
    """Zero moments shaped like `params` (f32, on each leaf's device) and
    count 0."""
    def zeros(tree):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), tree)
    device = tree_leaves(params)[0].device
    return AdamState(mu=zeros(params), nu=zeros(params),
                     count=torch.zeros((), dtype=torch.int32, device=device))


def adamw_step(cfg: AdamWConfig, count: torch.Tensor, params: list,
               grads: list, mu: list, nu: list) -> torch.Tensor:
    """The AdamW update at step `count` (after its increment), in place,
    of each parameter and its two moments from its (clipped) gradient:
    lists of tensors, each quadruple on one device (a gradient is moved
    there). Returns the learning rate, on `count`'s device."""
    lr = cosine_schedule(cfg)(count)
    cf = count.to(torch.float32)
    b1c = 1 - torch.tensor(cfg.b1, dtype=torch.float32,
                           device=cf.device) ** cf
    b2c = 1 - torch.tensor(cfg.b2, dtype=torch.float32,
                           device=cf.device) ** cf
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mu, nu, strict=True):
            dev = p.device
            g = g.to(dev, torch.float32)
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            step = (m / b1c.to(dev)) / (torch.sqrt(v / b2c.to(dev)) +
                                        cfg.eps)
            if p.ndim >= 2:
                step.add_(cfg.weight_decay * p.to(torch.float32))
            p.copy_(p.to(torch.float32) - lr.to(dev) * step)
    return lr


def adamw_update(cfg: AdamWConfig, grads, state: AdamState, params):
    """One AdamW step: clip `grads` (in place) by their global norm, then
    update every parameter and both moments in place (`adamw_step`).
    Returns (params, new_state, {"grad_norm", "lr"}), the metrics 0-d
    tensors; the new state holds the same moment trees and a new count.
    No value leaves the device."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    count = state.count + 1
    lr = adamw_step(cfg, count, tree_leaves(params), tree_leaves(grads),
                    tree_leaves(state.mu), tree_leaves(state.nu))
    return params, AdamState(state.mu, state.nu, count), {
        "grad_norm": gnorm, "lr": lr}
