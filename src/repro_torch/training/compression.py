"""Gradient compression for the cross-pod reduction: counterpart of
`repro.training.compression`.

Two schemes, applied to the pod-axis reduction only:

  * stochastic int8 quantization with a per-tensor scale, summed over the
    pods in int32 (`int8_allreduce_pod`): one byte an element on the wire;
  * top-k sparsification with error feedback (`topk_error_feedback`), k
    defaulting to 1 %.

The JAX package runs the all-reduce inside `shard_map` over a "pod" mesh
axis and draws the rounding noise from a `jax.random` key. The port sums
over the pods of a `ShardGroup` (one process, a device list, as the
sharded valuation engine does) and takes the noise from an explicit
`torch.Generator` or from the caller: the two packages' random bits
differ, so the tests hand JAX's noise to the port.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.base import tree_leaves, tree_map, tree_unflatten
from repro_torch.distributed.sharding import ShardGroup

__all__ = ["quantize_int8", "int8_allreduce_pod", "topk_error_feedback",
           "init_error", "compress_grads"]


def quantize_int8(x: torch.Tensor, noise: torch.Tensor):
    """(q int8, scale f32 0-d): x / scale rounded after adding `noise`
    (uniform in [-0.5, 0.5), x's shape) and clipped to [-127, 127], with
    scale = max(max |x|, 1e-8) / 127."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale + noise), -127, 127)
    return q.to(torch.int8), scale


def _uniform_noise(tree, generator: torch.Generator):
    """One uniform [-0.5, 0.5) f32 draw per leaf of `tree`, in leaf order,
    from `generator` (on its own device)."""
    return tree_map(lambda x: torch.rand(
        x.shape, generator=generator, dtype=torch.float32,
        device=generator.device) - 0.5, tree)


def int8_allreduce_pod(grads: Sequence, group: ShardGroup, *,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[Sequence] = None) -> list:
    """The pods' gradient trees summed through stochastic int8.

    `grads[p]` is pod p's tree, on `group.devices[p]`. Each leaf is
    quantized per pod (`quantize_int8` with that pod's noise), the int8
    values summed over the pods in int32 and the scales in f32, and the
    sum dequantized with the mean scale: qsum * (ssum / P) / P, in the
    leaf's type. Returns one tree per pod, on its device (pods on one
    device share its tensors). The noise is `noise[p]`, a tree like
    `grads[p]` (JAX's replicated key gives every pod the same), or else
    drawn per pod, leaf by leaf, from `generator`."""
    pods = group.size
    if len(grads) != pods:
        raise ValueError(f"{len(grads)} gradient trees for {pods} pods")
    if noise is None:
        if generator is None:
            raise ValueError("int8_allreduce_pod needs noise= or generator=")
        noise = [_uniform_noise(g, generator) for g in grads]
    leaves = [tree_leaves(g) for g in grads]
    noises = [tree_leaves(nz) for nz in noise]
    home = group.devices[0]
    summed = []
    for i, x0 in enumerate(leaves[0]):
        qsum = ssum = None
        for p in range(pods):
            x = leaves[p][i]
            q, scale = quantize_int8(x.to(torch.float32),
                                     noises[p][i].to(x.device))
            q, scale = q.to(home, torch.int32), scale.to(home)
            qsum = q if qsum is None else qsum + q
            ssum = scale if ssum is None else ssum + scale
        summed.append((qsum.to(torch.float32) * (ssum / pods) / pods
                       ).to(x0.dtype))
    return [tree_unflatten(grads[p], [s.to(dev) for s in summed])
            for p, dev in enumerate(group.devices)]


def topk_error_feedback(grads, error, frac: float = 0.01):
    """Top-|k| sparsification with error feedback. Returns
    (sparse_grads, new_error): sparse_grads dense-shaped (zeros elsewhere)
    in each gradient's type, new_error what was not sent, f32. Elements
    tied at the k-th magnitude are all kept, as in the reference."""
    def one(g, e):
        gf = g.to(torch.float32) + e
        k = max(1, int(frac * gf.numel()))
        thresh = torch.topk(torch.abs(gf).reshape(-1), k).values[-1]
        mask = (torch.abs(gf) >= thresh).to(torch.float32)
        sparse = gf * mask
        return sparse.to(g.dtype), gf - sparse

    pairs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                       tree_leaves(error))]
    return (tree_unflatten(grads, [p[0] for p in pairs]),
            tree_unflatten(grads, [p[1] for p in pairs]))


def init_error(grads_like):
    """Zero error-feedback state, f32, shaped like `grads_like`."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compress_grads(grads, state, scheme: str, frac: float = 0.01):
    """The trainer's dispatcher: "none" passes through, "topk_ef" runs
    `topk_error_feedback` with the error state `state`. Returns
    (grads, state)."""
    if scheme == "none":
        return grads, state
    if scheme == "topk_ef":
        return topk_error_feedback(grads, state, frac)
    raise ValueError(scheme)
