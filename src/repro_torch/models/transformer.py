"""Decoder-LM assembly of the port (counterpart of
`repro.models.transformer`), for the dense family.

A "group" is the repeating unit (cfg.group_size layers; one layer for a
dense arch). Params for one group are described once and stacked on a
leading layers axis, as in the JAX package, so one JAX leaf is one tensor
here; where the JAX package runs `lax.scan` over the groups, the port runs
a Python loop over views of the stacked tensors. Caches are stacked the
same way, and decode writes them in place.

In train mode with grad on, each group is recomputed in the backward pass
(`cfg.remat`, `torch.utils.checkpoint`, as the reference wraps its group
function in `jax.checkpoint`), and the stacked weights are split once per
forward (`torch.unbind`): slicing them group by group would give every
group a full-size zero gradient of the stacked tensors to add.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import (
    PD, ModelConfig, tree_leaves, tree_map, tree_unflatten)
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L

__all__ = ["layer_schedule", "model_desc", "forward", "init_caches",
           "pooled_embeddings"]


class Entry(NamedTuple):
    mixer: str            # attn | swa
    ffn: Optional[str]    # mlp | None


def layer_schedule(cfg: ModelConfig) -> list[Entry]:
    """The per-group layer schedule. The port runs the dense family (attn
    or swa mixers with an mlp ffn); the other families raise."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported; the port "
            f"runs the dense family only (ROADMAP.md queue A 3)")
    mixer = "swa" if cfg.sliding_window else "attn"
    ffn = None if cfg.d_ff == 0 else "mlp"
    return [Entry(mixer, ffn) for _ in range(cfg.group_size)]


def _block_desc(cfg: ModelConfig, e: Entry):
    d = {"ln1": L.norm_desc(cfg), "mixer": A.attn_desc(cfg)}
    if e.ffn == "mlp":
        d["ln2"] = L.norm_desc(cfg)
        d["ffn"] = L.mlp_desc(cfg)
    return d


def _stack_desc(desc, n: int):
    return tree_map(
        lambda pd: PD((n, *pd.shape), ("layers", *pd.axes), pd.init,
                      pd.scale),
        desc, is_leaf=lambda x: isinstance(x, PD))


def model_desc(cfg: ModelConfig):
    """Full parameter description tree for a decoder LM."""
    group = {"blocks": [_block_desc(cfg, e) for e in layer_schedule(cfg)]}
    return {
        "embed": L.embedding_desc(cfg),
        "groups": _stack_desc(group, cfg.num_groups),
        "ln_f": L.norm_desc(cfg),
    }


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                device="cuda"):
    """Stacked per-group caches for decode: one dict per schedule entry
    holding "kv", a KVCache of (groups, batch, kv, S, hd) k/v and
    (groups, batch, S) positions, all empty (`EMPTY_POS`). max_len is the
    KV length (cfg.sliding_window caps it for SWA archs)."""
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    g, kvh, hd = cfg.num_groups, cfg.num_kv_heads, cfg.hd
    caches = []
    for e in layer_schedule(cfg):
        S = min(max_len, cfg.sliding_window) if e.mixer == "swa" else max_len
        caches.append({"kv": A.KVCache(
            k=torch.zeros((g, batch, kvh, S, hd), dtype=dtype, device=dev),
            v=torch.zeros((g, batch, kvh, S, hd), dtype=dtype, device=dev),
            pos=torch.full((g, batch, S), A.EMPTY_POS, dtype=torch.int32,
                           device=dev),
        )})
    return caches


def _apply_block(bp, x, cfg: ModelConfig, e: Entry, mode: str, cache,
                 index, positions, kv_block):
    """One block. Returns (x, new_cache)."""
    h = L.apply_norm(bp["ln1"], x, cfg)
    new_cache: dict[str, Any] = {}
    window = cfg.sliding_window if e.mixer == "swa" else None
    if mode == "decode":
        y, new_cache["kv"] = A.decode_attention(
            bp["mixer"], h, cfg, cache["kv"], index, window=window)
    elif mode == "prefill":
        y, new_cache["kv"] = A.attention(
            bp["mixer"], h, cfg, positions=positions, causal=True,
            window=window, kv_block=kv_block, return_cache=True)
    else:
        y = A.attention(bp["mixer"], h, cfg, positions=positions,
                        causal=True, window=window, kv_block=kv_block)
    x = x + y
    if e.ffn:
        x = x + L.apply_mlp(bp["ffn"], L.apply_norm(bp["ln2"], x, cfg), cfg)
    return x, new_cache


def _unstack(tree, n: int) -> list:
    """The n per-group trees of a stacked tree: each leaf split once along
    its leading axis (`torch.unbind`, views), so a backward pass stacks
    each leaf's group gradients into one tensor."""
    leaves = [w.unbind(0) for w in tree_leaves(tree)]
    return [tree_unflatten(tree, [parts[gi] for parts in leaves])
            for gi in range(n)]


def _dots_policy(ctx, op, *args, **kwargs):
    """remat "dots": keep the outputs of 2-D matrix products (the
    projections; the reference's dots_with_no_batch_dims_saveable) and
    recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """`fn` recomputed in the backward pass as `cfg.remat` asks."""
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts)

    if cfg.remat in ("block", "full"):
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"remat {cfg.remat!r}: none | block | full | dots")


def forward(params, cfg: ModelConfig, tokens, *, mode: str = "train",
            caches=None, index=None, kv_block=1024, positions=None):
    """Decoder LM forward.

    mode: train (no caches) | prefill (returns caches) | decode (s == 1,
    caches required, index = current position; the caches are written in
    place and returned). Without `positions`, train and prefill attend at
    positions arange(s) through the flash-attention path; explicit
    positions take the plain blockwise path.
    Returns (logits, hidden, caches, aux_loss).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    if mode == "decode" and caches is None:
        raise ValueError("decode needs caches")
    sched = layer_schedule(cfg)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    have_cache = caches is not None

    def group_fn(x, gparams, gcaches):
        new_caches = []
        for i, e in enumerate(sched):
            x, nc = _apply_block(
                gparams["blocks"][i], x, cfg, e, mode,
                gcaches[i] if have_cache else None, index, positions,
                kv_block)
            new_caches.append(nc)
        return x, new_caches

    if mode == "train" and cfg.remat != "none" and torch.is_grad_enabled():
        group_fn = _remat(group_fn, cfg)
    per_group = []
    for gi, gparams in enumerate(_unstack(params["groups"],
                                          cfg.num_groups)):
        gcaches = tree_map(lambda c: c[gi], caches) if have_cache else None
        x, new_caches = group_fn(x, gparams, gcaches)
        per_group.append(new_caches)

    if mode == "decode":
        out_caches = caches  # written in place through the views
    elif mode == "prefill":
        out_caches = tree_map(lambda *cs: torch.stack(cs), *per_group)
    else:
        out_caches = None
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = L.logits_from_hidden(params["embed"], x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, x, out_caches, aux


def pooled_embeddings(params, cfg: ModelConfig, tokens, **kw):
    """Mean-pooled final hidden state, (B, d_model) f32: the valuation
    feature extractor (the `embed_fn` of the sessions)."""
    _, hidden, _, _ = forward(params, cfg, tokens, mode="train", **kw)
    return torch.mean(hidden.to(torch.float32), dim=1)
