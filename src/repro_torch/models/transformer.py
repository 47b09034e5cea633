"""Decoder-LM assembly of the port (counterpart of
`repro.models.transformer`): heterogeneous per-group layer schedules for
the dense, MoE, SSM (xLSTM), hybrid (Jamba), audio (the Whisper decoder,
with a cross-attention sub-block in every block and learned positions)
and VLM (patch embeddings prepended to the tokens) families.

A "group" is the repeating unit (cfg.group_size layers): dense and MoE
archs have a 1-layer group; Jamba an 8-layer group (1 attention + 7 Mamba,
MoE every 2nd layer); xLSTM an 8-layer group (7 mLSTM + 1 sLSTM). Params
for one group are described once and stacked on a leading layers axis, as
in the JAX package, so one JAX leaf is one tensor here; where the JAX
package runs `lax.scan` over the groups, the port runs a Python loop over
views of the stacked tensors. Caches are stacked the same way. Decode
writes the KV caches in place; an SSM state is copied back into its pool
leaf, or the leaf is rebound where the new state has another type (the
sLSTM h, ROADMAP.md queue C 1.4).

In train mode with grad on, each group is recomputed in the backward pass
(`cfg.remat`, `torch.utils.checkpoint`, as the reference wraps its group
function in `jax.checkpoint`), and the stacked weights are split once per
forward (`torch.unbind`): slicing them group by group would give every
group a full-size zero gradient of the stacked tensors to add.

`forward` is `forward_rows` over one row. On a device grid
(`distributed/grid_step.py`) `forward_rows` runs one forward over the
data rows, each on its own device, all rows of a block before the next,
so that an MoE block can route the tokens of every row as one batch.
`cfg.fsdp_constrain` casts each group's >= 2-D f32 weights to
`cfg.dtype` at use, as the reference does (ROADMAP.md queue C 1.10).
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
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S

__all__ = ["layer_schedule", "model_desc", "forward", "forward_rows",
           "Rows", "one_row", "init_caches", "pooled_embeddings"]

# the learned decoder positions of the audio family: sized for the
# reference's stress shapes (real Whisper caps at 448 positions)
AUDIO_POSITIONS = 32768


class Entry(NamedTuple):
    mixer: str            # attn | swa | mamba | mlstm | slstm
    ffn: Optional[str]    # mlp | moe | None
    cross: bool = False   # a cross-attention sub-block (whisper decoder)


def layer_schedule(cfg: ModelConfig) -> list[Entry]:
    """The per-group layer schedule; an unknown family raises ValueError."""
    out = []
    for i in range(cfg.group_size):
        if cfg.family in ("dense", "moe", "vlm"):
            mixer = "swa" if cfg.sliding_window else "attn"
        elif cfg.family == "hybrid":
            mixer = "attn" if i in cfg.attn_layer_in_group else cfg.ssm_kind
        elif cfg.family == "ssm":
            mixer = "slstm" if i in cfg.slstm_layer_in_group else "mlstm"
        elif cfg.family == "audio":
            mixer = "attn"
        else:
            raise ValueError(cfg.family)
        if cfg.d_ff == 0 and not cfg.moe_d_ff:
            ffn = None
        elif cfg.num_experts and i % cfg.moe_period == cfg.moe_period - 1:
            ffn = "moe"
        else:
            ffn = "mlp"
        out.append(Entry(mixer, ffn, cfg.family == "audio"))
    return out


class Mixer(NamedTuple):
    """An SSM mixer's functions (models/ssm.py)."""
    desc: Any
    forward: Any
    decode_step: Any
    init_state: Any


_MIXERS = {
    "mamba": Mixer(S.mamba_desc, S.mamba_forward, S.mamba_decode_step,
                   S.mamba_init_state),
    "mlstm": Mixer(S.mlstm_desc, S.mlstm_forward, S.mlstm_decode_step,
                   S.mlstm_init_state),
    "slstm": Mixer(S.slstm_desc, S.slstm_forward, S.slstm_decode_step,
                   S.slstm_init_state),
}


def _block_desc(cfg: ModelConfig, e: Entry):
    mixer = (A.attn_desc(cfg) if e.mixer in ("attn", "swa")
             else _MIXERS[e.mixer].desc(cfg))
    d = {"ln1": L.norm_desc(cfg), "mixer": mixer}
    if e.cross:
        d["ln_x"] = L.norm_desc(cfg)
        d["xattn"] = A.attn_desc(cfg, cross=True)
    if e.ffn:
        d["ln2"] = L.norm_desc(cfg)
        d["ffn"] = (MOE.moe_desc(cfg) if e.ffn == "moe"
                    else L.mlp_desc(cfg))
    return d


def _stack_desc(desc, n: int):
    return tree_map(
        lambda pd: PD((n, *pd.shape), ("layers", *pd.axes), pd.init,
                      pd.scale),
        desc, is_leaf=lambda x: isinstance(x, PD))


def model_desc(cfg: ModelConfig):
    """Full parameter description tree for a decoder LM."""
    group = {"blocks": [_block_desc(cfg, e) for e in layer_schedule(cfg)]}
    d = {
        "embed": L.embedding_desc(cfg),
        "groups": _stack_desc(group, cfg.num_groups),
        "ln_f": L.norm_desc(cfg),
    }
    if cfg.family == "audio":
        d["pos_emb"] = PD((AUDIO_POSITIONS, cfg.d_model), (None, "embed"),
                          init="embed")
    return d


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                enc_len: int = 0, dtype=None, device="cuda"):
    """Stacked per-group caches for decode, one dict per schedule entry:
    attention layers hold "kv", a KVCache of (groups, batch, kv, S, hd)
    k/v and (groups, batch, S) positions, all empty (`EMPTY_POS`); SSM
    layers hold "ssm", their state with a leading groups axis, all zeros
    (the reference's pool: zeros, the mLSTM stabilizer m too, and the sLSTM
    h in bf16 whatever the activation type); a cross sub-block holds
    "xkv", the encoder's k/v (zeros, `enc_len` of them) at positions
    arange(enc_len). max_len is the KV length (cfg.sliding_window caps it
    for SWA archs). `device="meta"` describes them without storage."""
    dtype = dtype or cfg.dtype
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    g, kvh, hd = cfg.num_groups, cfg.num_kv_heads, cfg.hd
    caches = []
    for e in layer_schedule(cfg):
        if e.mixer in ("attn", "swa"):
            S_ = (min(max_len, cfg.sliding_window) if e.mixer == "swa"
                  else max_len)
            caches.append({"kv": A.KVCache(
                k=torch.zeros((g, batch, kvh, S_, hd), dtype=dtype,
                              device=dev),
                v=torch.zeros((g, batch, kvh, S_, hd), dtype=dtype,
                              device=dev),
                pos=torch.full((g, batch, S_), A.EMPTY_POS,
                               dtype=torch.int32, device=dev),
            )})
        else:
            st = _MIXERS[e.mixer].init_state(cfg, batch, device=dev)
            caches.append({"ssm": tree_map(
                lambda a: torch.zeros((g, *a.shape), dtype=a.dtype,
                                      device=dev), st)})
        if e.cross:
            caches[-1]["xkv"] = A.KVCache(
                k=torch.zeros((g, batch, kvh, enc_len, hd), dtype=dtype,
                              device=dev),
                v=torch.zeros((g, batch, kvh, enc_len, hd), dtype=dtype,
                              device=dev),
                pos=torch.arange(enc_len, dtype=torch.int32, device=dev
                                 ).expand(g, batch, enc_len).contiguous())
    return caches


def _mixer_block(bp, x, cfg: ModelConfig, e: Entry, mode: str, cache,
                 index, positions, kv_block, enc_out):
    """One block up to its FFN: the mixer and the cross sub-block.
    Returns (x, new_cache)."""
    h = L.apply_norm(bp["ln1"], x, cfg)
    new_cache: dict[str, Any] = {}
    if e.mixer in ("attn", "swa"):
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
    else:
        m = _MIXERS[e.mixer]
        if mode == "decode":
            y, new_cache["ssm"] = m.decode_step(bp["mixer"], h, cfg,
                                                cache["ssm"])
        else:
            y, st = m.forward(bp["mixer"], h, cfg, None)
            if mode == "prefill":
                new_cache["ssm"] = st
    x = x + y
    if e.cross:
        hx = L.apply_norm(bp["ln_x"], x, cfg)
        if mode == "decode":
            # reads the encoder k/v cached at prefill; never writes it
            y, _ = A.decode_attention(bp["xattn"], hx, cfg, cache["xkv"],
                                      index, use_rope=False, xattn=True)
        elif mode == "prefill":
            y, new_cache["xkv"] = A.attention(
                bp["xattn"], hx, cfg, positions=positions, xattn_kv=enc_out,
                use_rope=False, return_cache=True)
        else:
            y = A.attention(bp["xattn"], hx, cfg, positions=positions,
                            xattn_kv=enc_out, use_rope=False)
        x = x + y
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


class Rows(NamedTuple):
    """How `forward_rows` runs one forward over R data rows, each on its
    own device (the grid executor's view, `distributed/grid_step.py`; a
    single device is one row).

    params(None) -> per row, the top-level params (all but "groups") on
        the row's device;
    params(gi) -> per row, group gi's params on the row's device, fetched
        inside the group's (recomputed) function, so a gather there is
        redone in the backward pass rather than kept;
    moe(ps, hs) -> (ys, aux): an MoE block's FFN over the rows' inputs
        hs, ps its params per row; aux one 0-d f32 tensor on row 0's
        device;
    encoder() -> per row, the audio encoder's params on the row's device
        (None for the other families; read by `Model.forward_rows`)."""
    params: Any
    moe: Any
    encoder: Any = None


def one_row(params, cfg: ModelConfig, encoder=None) -> Rows:
    """A decoder's `params` (and an audio model's `encoder` params), whole
    tensors on one device, as the `Rows` of one row."""
    groups = _unstack(params["groups"], cfg.num_groups)
    top = {k: v for k, v in params.items() if k != "groups"}

    def moe(ps, hs):
        y, aux = MOE.apply_moe(ps[0], hs[0], cfg)
        return [y], aux

    return Rows(lambda gi: [top if gi is None else groups[gi]], moe,
                None if encoder is None else lambda: [encoder])


def _fsdp_use(cfg: ModelConfig):
    """The reference's weight use under `fsdp_constrain`: a >= 2-D f32
    weight cast to `cfg.dtype` (before its FSDP gather there)."""
    def use(w):
        if w.ndim >= 2 and w.dtype == torch.float32:
            return w.to(cfg.dtype)
        return w
    return use


def forward(params, cfg: ModelConfig, tokens, *, mode: str = "train",
            caches=None, index=None, extra_embeds=None, kv_block=1024,
            positions=None, enc_out=None):
    """Decoder LM forward.

    mode: train (no caches) | prefill (returns caches) | decode (s == 1,
    caches required, index = current position; the caches are written in
    place and returned, an SSM state rebound where its type changes).
    Without `positions`, train and prefill self-attention runs at
    positions arange(s) through the flash-attention path; explicit
    positions take the plain blockwise path.
    extra_embeds: (b, p, d_model) continuous embeddings prepended to the
    token embeddings (VLM). enc_out: (b, s_enc, d_model) encoder output
    for the cross-attention sub-blocks (audio; train and prefill).
    `cfg.fsdp_constrain` casts each group's >= 2-D f32 weights to
    `cfg.dtype` at use, as the reference does.
    Returns (logits, hidden, caches, aux_loss): aux_loss is the MoE
    load-balancing loss summed over the MoE blocks (0 without experts).
    """
    one = lambda v: None if v is None else [v]  # noqa: E731
    logits, hidden, caches, aux = forward_rows(
        one_row(params, cfg), cfg, [tokens], mode=mode, caches=one(caches),
        index=index, extra_embeds=one(extra_embeds), kv_block=kv_block,
        positions=one(positions), enc_out=one(enc_out))
    return logits[0], hidden[0], None if caches is None else caches[0], aux


def forward_rows(rows: Rows, cfg: ModelConfig, tokens, *, mode="train",
                 caches=None, index=None, extra_embeds=None, kv_block=1024,
                 positions=None, enc_out=None):
    """`forward` over the data rows of `rows`, all rows of a block before
    the next block: every argument of `forward` that is per batch is here
    a list, one entry per row (on the row's device), and so is every
    result but aux. Each row's block runs on its own, except an MoE
    block's FFN, which `rows.moe` runs over all the rows' inputs."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    if mode == "decode" and caches is None:
        raise ValueError("decode needs caches")
    sched = layer_schedule(cfg)
    n_rows = len(tokens)
    per_row = lambda v: [None] * n_rows if v is None else v  # noqa: E731
    positions, enc_out = per_row(positions), per_row(enc_out)
    top = rows.params(None)
    xs = []
    for r in range(n_rows):
        x = L.embed_tokens(top[r]["embed"], tokens[r], cfg)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds[r].to(x.dtype), x], dim=1)
        if cfg.family == "audio":
            b, s = x.shape[:2]
            if positions[r] is not None:
                at = positions[r]
            elif mode == "decode":
                at = torch.full((b, s), int(index), dtype=torch.int64,
                                device=x.device)
            else:
                at = torch.arange(s, device=x.device).expand(b, s)
            x = x + top[r]["pos_emb"][at].to(x.dtype)
        xs.append(x)
    have_cache = caches is not None
    use = _fsdp_use(cfg) if cfg.fsdp_constrain else None

    def group_fn(xs, gi, gcaches):
        xs = list(xs)
        gps = rows.params(gi)
        if use is not None:
            gps = [tree_map(use, gp) for gp in gps]
        aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
        new_caches = [[] for _ in range(n_rows)]
        for i, e in enumerate(sched):
            for r in range(n_rows):
                xs[r], nc = _mixer_block(
                    gps[r]["blocks"][i], xs[r], cfg, e, mode,
                    gcaches[r][i] if have_cache else None, index,
                    positions[r], kv_block, enc_out[r])
                new_caches[r].append(nc)
            if not e.ffn:
                continue
            bps = [gp["blocks"][i] for gp in gps]
            hs = [L.apply_norm(bp["ln2"], x, cfg) for bp, x in zip(bps, xs)]
            if e.ffn == "moe":
                ys, a = rows.moe([bp["ffn"] for bp in bps], hs)
                aux = aux + a
            else:
                ys = [L.apply_mlp(bp["ffn"], h, cfg) for bp, h in zip(bps,
                                                                       hs)]
            xs = [x + y for x, y in zip(xs, ys)]
        return xs, new_caches, aux

    if mode == "train" and cfg.remat != "none" and torch.is_grad_enabled():
        group_fn = _remat(group_fn, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    per_group = []
    for gi in range(cfg.num_groups):
        gcaches = ([tree_map(lambda c: c[gi], cr) for cr in caches]
                   if have_cache else None)
        xs, new_caches, a = group_fn(xs, gi, gcaches)
        aux = aux + a
        per_group.append(new_caches)

    if mode == "decode":
        # KV caches were written in place through the views; SSM states
        # come back new and go into their pool leaves
        for r in range(n_rows):
            for i, e in enumerate(sched):
                if "ssm" in caches[r][i]:
                    caches[r][i]["ssm"] = _write_states(
                        caches[r][i]["ssm"],
                        [pg[r][i]["ssm"] for pg in per_group])
        out_caches = caches
    elif mode == "prefill":
        out_caches = [tree_map(lambda *cs: torch.stack(cs),
                               *[pg[r] for pg in per_group])
                      for r in range(n_rows)]
    else:
        out_caches = None
    xs = [L.apply_norm(top[r]["ln_f"], x, cfg) for r, x in enumerate(xs)]
    logits = [L.logits_from_hidden(top[r]["embed"], x, cfg)
              for r, x in enumerate(xs)]
    return logits, xs, out_caches, aux


def _write_states(pool, states):
    """The per-group decode states `states` into the stacked `pool` state:
    each leaf copied in place where its type is the pool's, else the pool
    leaf rebound to the stacked new states (the JAX decode step returns
    its new state in the activation type, so its pool takes that type)."""
    out = []
    for j, leaf in enumerate(pool):
        new = [st[j] for st in states]
        if new[0].dtype == leaf.dtype:
            for gi, t in enumerate(new):
                leaf[gi].copy_(t)
            out.append(leaf)
        else:
            out.append(torch.stack(new))
    return type(pool)(*out)


def pooled_embeddings(params, cfg: ModelConfig, tokens, **kw):
    """Mean-pooled final hidden state, (B, d_model) f32: the valuation
    feature extractor (the `embed_fn` of the sessions)."""
    _, hidden, _, _ = forward(params, cfg, tokens, mode="train", **kw)
    return torch.mean(hidden.to(torch.float32), dim=1)
