"""Carry LM parameters between the JAX package and the port.

`params_from_jax` takes the JAX `params` pytree with its leaves as numpy
arrays (`jax.tree.map(np.asarray, params)`) and returns the port's tree:
the same dicts and lists, each leaf one tensor of the same shape, type and
stacked layout (groups on the leading axis). `params_to_numpy` goes back.
Both copy values exactly, so a round trip is bit for bit.
`opt_state_from_jax` does the same for the optimizer state
(`repro.training.optimizer.AdamState`, its leaves numpy arrays) and
returns the port's `AdamState`; `caches_from_jax` for a decode cache tree
(`KVCache`, the cross-attention "xkv" caches too, `MambaState`,
`MLSTMState`, `SLSTMState`), each NamedTuple becoming the port's class of
the same name. Every family's tree carries over, Whisper's encoder
(`enc_pos`, `enc_groups`, `enc_ln_f`) and decoder included.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import tree_map
from repro_torch.device import resolve_device

__all__ = ["params_from_jax", "params_to_numpy", "opt_state_from_jax",
           "caches_from_jax"]


def params_from_jax(tree, device="cuda"):
    """Numpy-leaved JAX params tree -> the port's params on `device`."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def params_to_numpy(tree):
    """The port's params -> the same tree with numpy leaves (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def opt_state_from_jax(state, device="cuda"):
    """Numpy-leaved JAX `AdamState(mu, nu, count)` -> the port's
    `training.optimizer.AdamState` on `device`: the moment trees as
    `params_from_jax` carries params, the count a 0-d int32 tensor."""
    from repro_torch.training.optimizer import AdamState

    dev = resolve_device(device)
    return AdamState(
        mu=params_from_jax(state.mu, dev), nu=params_from_jax(state.nu, dev),
        count=torch.as_tensor(np.asarray(state.count, dtype=np.int32),
                              device=dev))


def caches_from_jax(caches, device="cuda"):
    """Numpy-leaved JAX decode caches (the list of per-entry dicts of
    `repro.models.transformer.init_caches`, or a prefill's) -> the port's,
    on `device`: every leaf copied, with its type; each cache NamedTuple
    rebuilt as the port's class of the same name."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import MambaState, MLSTMState, SLSTMState

    classes = {c.__name__: c for c in (KVCache, MambaState, MLSTMState,
                                       SLSTMState)}
    dev = resolve_device(device)

    def carry(node):
        if isinstance(node, dict):
            return {k: carry(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return classes[type(node).__name__](*(carry(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(carry(v) for v in node)
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return carry(caches)
