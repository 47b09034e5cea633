"""Mixture-of-Experts FFN of the port: top-k routing, capacity-bounded
scatter dispatch, gather combine (counterpart of `repro.models.moe`, its
`_moe_math` on one device).

Tokens are cut into groups of `moe_group_size` (the last padded with zero
rows, which route and take queue places like real tokens). Per group:

  pos[t,j]   = position of (token t, choice j) in its expert's queue (the
               cumsum over the flattened (token, choice) order)
  slot[t,j]  = expert * cap + pos          (dropped iff pos >= cap)
  expert_in  = zeros(E*cap, d).index_put(slot, keep * x[t], accumulate)
  h          = per-expert SwiGLU on (E, cap, d), batched matmuls
  y[t]       = sum_j gate[t,j] * expert_out[slot[t,j]]

A dropped choice adds an exact zero into its expert's last slot, so the
unordered accumulate of the card leaves every slot exact. `route` is the
routing alone, which `apply_moe` and the parity tests both call: a
flipped choice or drop changes a token's output by O(1), so routing is
held for equality, not within a tolerance.

`cfg.shmap_axes` (set by `launch/specs.py::lm_cell` for MoE configs) is
the reference's `shard_map` MoE: each data shard groups and routes only
its own tokens, so groups, capacity and drops are per shard, and each
model shard computes its slice of the expert hidden dim, the partial
outputs summed in the activation type. The grid runs `apply_moe` on one
data row's tokens with `model_shards` = the grid's model size.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import PD, ModelConfig

__all__ = ["moe_desc", "apply_moe", "route", "Routing", "capacity"]


def moe_desc(cfg: ModelConfig):
    f = cfg.moe_d_ff or cfg.d_ff
    e = cfg.num_experts
    return {
        "router": PD((cfg.d_model, e), ("embed", None), scale=0.02),
        "w1": PD((e, cfg.d_model, f), ("expert", "embed", "expert_mlp")),
        "w2": PD((e, f, cfg.d_model), ("expert", "expert_mlp", "embed")),
        "w3": PD((e, cfg.d_model, f), ("expert", "embed", "expert_mlp")),
    }


class Routing(NamedTuple):
    """One call's routing, per group g of gs tokens (sk = gs * topk):
    probs (g, gs, E) f32; gate_vals, gate_idx (g, gs, topk) (gate_vals
    normalized over the k choices); pos, slot (g, sk) int64 queue position
    and buffer row; keep (g, sk) bool; cap the per-expert capacity."""
    probs: torch.Tensor
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    pos: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    cap: int


def capacity(cfg: ModelConfig, group_size: int) -> int:
    """Per-expert queue length of a group: int(gs * k * cf / E) + 1."""
    return int(group_size * cfg.experts_per_token * cfg.capacity_factor
               / cfg.num_experts) + 1


def route(xg: torch.Tensor, router: torch.Tensor, cfg: ModelConfig
          ) -> Routing:
    """Routing of the grouped tokens xg (g, gs, d): f32 router softmax,
    top-k with the lower expert index first among equal probabilities (as
    `jax.lax.top_k`: a stable descending sort, whose first k are taken),
    queue positions by a cumsum over the flattened (token, choice) order."""
    n_grp, gs, _ = xg.shape
    e, topk = cfg.num_experts, cfg.experts_per_token
    logits = xg.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)  # (g, gs, e)
    gate_idx = torch.sort(probs, dim=-1, descending=True,
                          stable=True).indices[..., :topk]
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    cap = capacity(cfg, gs)
    flat_idx = gate_idx.reshape(n_grp, gs * topk)
    sel = F.one_hot(flat_idx, e)  # (g, sk, e), small
    pos = ((torch.cumsum(sel, dim=1) - 1) * sel).sum(-1)
    keep = pos < cap
    slot = torch.clamp(flat_idx * cap + torch.clamp(pos, 0, cap - 1),
                       0, e * cap - 1)
    return Routing(probs, gate_vals, gate_idx, pos, slot, keep, cap)


def apply_moe(p, x, cfg: ModelConfig, model_shards: int = 1):
    """x: (b, s, d) -> (out (b, s, d), aux_loss 0-d f32): the MoE FFN and
    the Switch load-balancing loss E * sum_e(frac_top1_e * mean_prob_e),
    both over every row of every group, padding rows included.

    With `cfg.shmap_axes` set, x is one data shard's tokens (the reference
    runs the block under `shard_map`): they are grouped and routed alone,
    and each of `model_shards` model shards computes its slice of the
    expert hidden dim (w1 / w3 columns, w2 rows) and combines it; the
    partial outputs are summed over the model shards in the activation
    type, in shard order. Without it `model_shards` must be 1."""
    if model_shards > 1 and not cfg.shmap_axes:
        raise ValueError("model_shards > 1 needs cfg.shmap_axes")
    b, s, d = x.shape
    e, topk = cfg.num_experts, cfg.experts_per_token
    n_tok = b * s
    gs = min(cfg.moe_group_size, n_tok)
    n_grp = -(-n_tok // gs)
    pad = n_grp * gs - n_tok
    tokens = x.reshape(n_tok, d)
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    xg = tokens.reshape(n_grp, gs, d)
    r = route(xg, p["router"], cfg)
    cap = r.cap

    cdtype = cfg.dtype
    keep = r.keep.to(cdtype)
    gidx = torch.arange(n_grp, device=x.device)[:, None]
    # scatter-dispatch into (g, E*cap, d); a dropped choice adds 0 * x
    tok_rep = xg.to(cdtype).repeat_interleave(topk, dim=1)  # (g, sk, d)
    expert_in = torch.zeros((n_grp, e * cap, d), dtype=cdtype,
                            device=x.device).index_put(
        (gidx, r.slot), tok_rep * keep[..., None], accumulate=True)
    # experts batched: (e, g * cap, d) @ (e, d, f)
    ein = expert_in.reshape(n_grp, e, cap, d).transpose(0, 1).reshape(
        e, n_grp * cap, d)
    w = r.gate_vals.reshape(n_grp, gs * topk).to(cdtype) * keep
    f = p["w1"].shape[-1]
    if f % model_shards:
        raise ValueError(f"the expert hidden dim {f} does not split over "
                         f"{model_shards} model shards")
    fs = f // model_shards
    out = None
    for j in range(model_shards):
        cols = slice(j * fs, (j + 1) * fs)
        h = F.silu(ein @ p["w1"][..., cols].to(cdtype)) * (
            ein @ p["w3"][..., cols].to(cdtype))
        eout = (h @ p["w2"][:, cols].to(cdtype)).reshape(
            e, n_grp, cap, d).transpose(0, 1).reshape(n_grp, e * cap, d)
        # gather-combine
        y = eout[gidx, r.slot]  # (g, sk, d)
        y = (y * w[..., None]).reshape(n_grp, gs, topk, d).sum(2)
        part = y.reshape(n_grp * gs, d)[:n_tok].reshape(b, s, d).to(x.dtype)
        out = part if out is None else out + part

    top1 = F.one_hot(r.gate_idx[..., 0], e).to(torch.float32)
    frac = torch.mean(top1, dim=(0, 1))
    mean_prob = torch.mean(r.probs, dim=(0, 1))
    aux = e * torch.sum(frac * mean_prob)
    return out, aux

