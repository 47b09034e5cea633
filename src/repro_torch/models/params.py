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
`params_from_flat` lays a flat dict of named weights (the plain Jamba2
reference's `draw_weights`) into a decoder's tree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import tree_map
from repro_torch.device import resolve_device

__all__ = ["params_from_jax", "params_to_numpy", "opt_state_from_jax",
           "caches_from_jax", "params_from_flat"]


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


def params_from_flat(cfg, weights: dict):
    """A decoder's params from a flat dict of named weights: "tok" (vocab,
    d), optionally "out" (d, vocab), "ln_f" (d,), and for each layer i
    "{i}.ln1", "{i}.ln2" (d,), "{i}.mixer.<name>" and "{i}.ffn.<name>"
    under the names of `models.attention.attn_desc`, `models.ssm.
    mamba_desc`, `models.layers.mlp_desc` and `models.moe.moe_desc`.

    The tensors keep their type and device. Each group's leaves are
    stacked on the leading axis (a view where there is one group), and
    the dict's entries are taken out as they are laid, so that no weight
    is held twice for long. Padded q heads get zero columns in wq and zero
    rows in wo, padded vocab rows zeros, as the port's padding asks."""
    from repro_torch.models import transformer as T

    hd, nh, hp = cfg.hd, cfg.num_heads, cfg.padded_heads
    pv = cfg.padded_vocab

    def take(name):
        w = weights.pop(name)
        if name.endswith("mixer.wq") and hp != nh:
            w = torch.cat([w, w.new_zeros((w.shape[0], (hp - nh) * hd))], 1)
        elif name.endswith("mixer.wo") and hp != nh:
            w = torch.cat([w, w.new_zeros(((hp - nh) * hd, w.shape[1]))], 0)
        elif name in ("tok", "out") and pv != cfg.vocab_size:
            pad = pv - cfg.vocab_size
            w = (torch.cat([w, w.new_zeros((pad, w.shape[1]))], 0)
                 if name == "tok"
                 else torch.cat([w, w.new_zeros((w.shape[0], pad))], 1))
        return w

    def stack(parts):
        return parts[0].unsqueeze(0) if len(parts) == 1 else torch.stack(
            parts)

    blocks = []
    for i, e in enumerate(T.layer_schedule(cfg)):
        layers = range(i, cfg.num_layers, cfg.group_size)
        block = {}
        for part in ("ln1", "ln2"):
            block[part] = {"scale": stack([take(f"{j}.{part}")
                                           for j in layers])}
        for part in ("mixer", "ffn"):
            keys = sorted({k.split(".", 2)[2] for k in weights
                           if k.startswith(f"{i}.{part}.")})
            block[part] = {k: stack([take(f"{j}.{part}.{k}")
                                     for j in layers]) for k in keys}
        if not e.ffn:
            block.pop("ln2")
            block.pop("ffn")
        blocks.append(block)
    embed = {"tok": take("tok")}
    if "out" in weights:
        embed["out"] = take("out")
    return {"embed": embed, "groups": {"blocks": blocks},
            "ln_f": {"scale": take("ln_f")}}
