"""GQA attention of the port: causal / sliding-window prefill, non-causal
encoder self-attention and cross-attention through the flash-attention
kernel, the plain blockwise path, and KV-cache decode (linear and ring
buffer; cross-attention reads its cache). Counterpart of
`repro.models.attention`.

Head-count padding: q heads are padded up to `cfg.padded_heads`; padded
heads have zero rows in wo, so the math is exact. K/V stay at the true
head count and are expanded to the q heads with the static map
`kv_head_map`, which works for any (H, KV).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.configs.base import PD, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rope

__all__ = ["attn_desc", "attention", "decode_attention", "KVCache",
           "kv_head_map"]

_NEG = -1e30
EMPTY_POS = 2**30  # the position of an empty cache slot


class KVCache(NamedTuple):
    """k/v: (b, KV, S, hd). pos: (b, S) int32 absolute positions (ring
    buffers need them; `EMPTY_POS` marks an empty slot)."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


def attn_desc(cfg: ModelConfig, cross: bool = False):
    hp, kv, hd = cfg.padded_heads, cfg.num_kv_heads, cfg.hd
    d = {
        "wq": PD((cfg.d_model, hp * hd), ("embed", "heads")),
        "wk": PD((cfg.d_model, kv * hd), ("embed", "kv")),
        "wv": PD((cfg.d_model, kv * hd), ("embed", "kv")),
        "wo": PD((hp * hd, cfg.d_model), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        d["bq"] = PD((hp * hd,), ("heads",), init="zeros")
        d["bk"] = PD((kv * hd,), ("kv",), init="zeros")
        d["bv"] = PD((kv * hd,), ("kv",), init="zeros")
    if cfg.qk_norm:
        d["q_norm"] = PD((hd,), (None,), init="ones")
        d["k_norm"] = PD((hd,), (None,), init="ones")
    return d


def kv_head_map(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Static map padded-q-head -> kv head (int64). True heads map in
    contiguous groups; padded heads (zeroed by wo) map to head 0. One
    tensor per (heads, kv heads, padded heads, device), made once: a copy
    from the host at every call would wait for the card's queue."""
    return _head_map(cfg.num_heads, cfg.num_kv_heads, cfg.padded_heads,
                     torch.device("cpu" if device is None else device))


@functools.lru_cache(maxsize=None)
def _head_map(h: int, kv: int, hp: int, device) -> torch.Tensor:
    m = [min(i * kv // h, kv - 1) if i < h else 0 for i in range(hp)]
    return torch.tensor(m, dtype=torch.int64, device=device)


def _rms(x, scale, eps):
    xf = x.to(torch.float32)
    out = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


def _project_q(p, x, cfg, positions, use_rope):
    b, s, _ = x.shape
    hp, hd = cfg.padded_heads, cfg.hd
    q = x @ p["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(b, s, hp, hd)
    if cfg.qk_norm:
        q = _rms(q, p["q_norm"], cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
    return q


def _project_kv(p, x, cfg, positions, use_rope):
    b, s, _ = x.shape
    kv, hd = cfg.num_kv_heads, cfg.hd
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        k = _rms(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        k = rope(k, positions, cfg.rope_theta)
    return k, v


def _blockwise_attn(q, k, v, q_pos, k_pos, *, causal, window, kv_block):
    """Flash-style attention in plain PyTorch: a loop over KV blocks with
    running max/denominator. q: (b, hp, s, hd); k, v: (b, hp, skv, hd).
    Positions drive masking, so ring buffers and offsets work uniformly."""
    b, hp, s, hd = q.shape
    skv = k.shape[2]
    blk = min(kv_block, skv)
    scale = 1.0 / (hd ** 0.5)
    qf = q.to(torch.float32)
    m = torch.full((b, hp, s), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hp, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hp, s, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, skv, blk):
        kc = k[:, :, k0:k0 + blk].to(torch.float32)
        vc = v[:, :, k0:k0 + blk].to(torch.float32)
        pc = k_pos[:, k0:k0 + blk]
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, kc) * scale
        if causal:
            mask = pc[:, None, None, :] <= q_pos[:, None, :, None]
        else:
            mask = (pc < EMPTY_POS)[:, None, None, :]
        if window is not None:
            mask = mask & (pc[:, None, None, :]
                           > q_pos[:, None, :, None] - window)
        logits = torch.where(mask, logits, _NEG)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        # zero masked entries explicitly: exp(-NEG - -NEG) == 1 otherwise
        pexp = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
        l = l * alpha + pexp.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", pexp,
                                                    vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def attention(p, x, cfg: ModelConfig, *, positions=None, causal=True,
              window=None, kv_block=1024, return_cache=False,
              xattn_kv=None, use_rope=True):
    """Full (train/prefill) attention. x: (b, s, d_model).

    Cross-attention: `xattn_kv` is (b, s_enc, d_model); then causal is
    ignored and the kv positions are the encoder arange. Two kinds of
    call run `ops.flash_attention` -- the CUDA kernel on the card,
    forward only -- because no position-dependent mask applies to them:
    self-attention at the default positions (`positions=None`: arange;
    causal or not, windowed or not), and cross-attention without a window
    (non-causal over every encoder key, whatever the query positions). A
    call that needs a gradient (grad on, an input requiring it), explicit
    self-attention positions and a windowed cross call take the plain
    blockwise path, the one the reference differentiates.
    RoPE applies where `use_rope` and `cfg.rope` both ask for it.
    """
    b, s, _ = x.shape
    use_rope = use_rope and cfg.rope
    if xattn_kv is None:
        kernel_ok = positions is None
    else:
        kernel_ok = window is None
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    q = _project_q(p, x, cfg, positions, use_rope)
    if xattn_kv is None:
        k, v = _project_kv(p, x, cfg, positions, use_rope)
        k_pos = positions
    else:
        s_enc = xattn_kv.shape[1]
        enc_pos = torch.arange(s_enc, dtype=torch.int32,
                               device=x.device).expand(b, s_enc)
        k, v = _project_kv(p, xattn_kv, cfg, enc_pos, use_rope)
        k_pos = enc_pos
        causal = False
    hmap = kv_head_map(cfg, x.device)
    kx = k[:, :, hmap, :].transpose(1, 2).contiguous()  # (b, hp, s_kv, hd)
    vx = v[:, :, hmap, :].transpose(1, 2).contiguous()
    qx = q.transpose(1, 2).contiguous()
    needs_grad = torch.is_grad_enabled() and (
        qx.requires_grad or kx.requires_grad or vx.requires_grad)
    if kernel_ok and not needs_grad:
        out = ops.flash_attention(qx, kx, vx, causal=causal, window=window)
    else:
        out = _blockwise_attn(qx, kx, vx, positions, k_pos, causal=causal,
                              window=window, kv_block=kv_block)
    out = out.transpose(1, 2).reshape(b, s, -1)
    y = out @ p["wo"].to(x.dtype)
    if return_cache:
        cache = KVCache(k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(),
                        k_pos.to(torch.int32).contiguous())
        return y, cache
    return y


def decode_attention(p, x, cfg: ModelConfig, cache, index: int,
                     *, window=None, use_rope=True, xattn=False):
    """One-token decode. x: (b, 1, d_model); cache k/v: (b, KV, S, hd).

    Linear cache: writes at `index`. Ring buffer (window is not None and
    S == window): writes at index % S, with absolute positions tracked in
    cache.pos. The write is in place: the returned cache holds the same
    tensors as `cache`. As `lax.dynamic_update_slice` in the JAX package, a
    write past the end lands on the last slot. Cross-attention
    (xattn=True): the cache holds encoder k/v and is not written.

    `cache` may also be a list of KVCache blocks that split the seq dim in
    order (a seq-sharded cache on a device grid, each block on its own
    device): the new k/v go into the block holding the slot, and each
    block's (max, sum, output) partial, computed on its device, is
    combined on x's (`_combine_blocks`), the flash-decode across model
    shards that the reference's partitioner writes. No block is gathered.
    """
    b = x.shape[0]
    index = int(index)
    use_rope = use_rope and cfg.rope
    pos_now = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q = _project_q(p, x, cfg, pos_now, use_rope)  # (b, 1, hp, hd)
    blocks = cache if isinstance(cache, list) else [cache]
    if not xattn:
        k_new, v_new = _project_kv(p, x, cfg, pos_now, use_rope)
        S = sum(c.k.shape[2] for c in blocks)
        slot = index % S if window is not None and S == window else index
        slot = min(max(slot, 0), S - 1)
        for c in blocks:
            if slot < c.k.shape[2]:
                c.k[:, :, slot] = k_new[:, 0].to(c.k.device, c.k.dtype)
                c.v[:, :, slot] = v_new[:, 0].to(c.v.device, c.v.dtype)
                c.pos[:, slot] = index
                break
            slot -= c.k.shape[2]
    if isinstance(cache, list):
        out = _combine_blocks(q, blocks, cfg, index, window, xattn)
    else:
        out = _attend(q, cache, cfg, index, window, xattn)
    y = out.reshape(b, 1, -1).to(x.dtype) @ p["wo"].to(x.dtype)
    return y, cache


def _valid(cache: KVCache, index: int, window, xattn: bool):
    """(b, 1, 1, S) mask of the cache slots a decode query at `index`
    reads."""
    if xattn:
        # encoder positions are all visible; mask only empty slots
        return cache.pos[:, None, None, :] < EMPTY_POS
    valid = cache.pos[:, None, None, :] <= index
    if window is not None:
        valid = valid & (cache.pos[:, None, None, :] > index - window)
    return valid


def _logits(q, cache: KVCache, cfg: ModelConfig):
    """(b, hp, 1, S) f32 scaled logits of q (b, 1, hp, hd) against the
    cache's keys, on the cache's device."""
    hmap = kv_head_map(cfg, cache.k.device)
    kx = cache.k[:, hmap]  # (b, hp, S, hd)
    scale = 1.0 / (cfg.hd ** 0.5)
    return torch.einsum("bqhd,bhkd->bhqk", q.to(cache.k.device, torch.float32),
                        kx.to(torch.float32)) * scale


def _attend(q, cache: KVCache, cfg: ModelConfig, index, window, xattn):
    """Softmax attention of q over one whole cache -> (b, 1, hp, hd) f32."""
    logits = torch.where(_valid(cache, index, window, xattn),
                         _logits(q, cache, cfg), _NEG)
    w = torch.softmax(logits, dim=-1)
    vx = cache.v[:, kv_head_map(cfg, cache.v.device)]
    return torch.einsum("bhqk,bhkd->bqhd", w, vx.to(torch.float32))


def _combine_blocks(q, blocks, cfg: ModelConfig, index, window, xattn):
    """Attention of q over seq blocks: each block's max m_b, sum l_b and
    unnormalized output o_b on its device, then on q's device
    out = sum_b exp(m_b - m) o_b / sum_b exp(m_b - m) l_b, m = max_b m_b.
    A block with no visible slot has l_b = 0 and o_b = 0."""
    parts = []
    for c in blocks:
        valid = _valid(c, index, window, xattn)
        logits = torch.where(valid, _logits(q, c, cfg), _NEG)
        m = logits.amax(-1, keepdim=True)  # (b, hp, 1, 1)
        pexp = torch.where(valid, torch.exp(logits - m), 0.0)
        vx = c.v[:, kv_head_map(cfg, c.v.device)].to(torch.float32)
        o = torch.einsum("bhqk,bhkd->bhqd", pexp, vx)
        parts.append(tuple(t.to(q.device) for t in
                           (m, pexp.sum(-1, keepdim=True), o)))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    num = sum(torch.exp(m - m_all) * o for m, _, o in parts)
    den = sum(torch.exp(m - m_all) * l for m, l, _ in parts)
    return (num / den).transpose(1, 2)  # (b, 1, hp, hd)
