"""Plain PyTorch reference of AI21-Jamba2-Mini's decoder layers: one
review at a time, float32, TF32 off, no kernels, cache or batching.

It follows HF `modeling_jamba` (arXiv:2403.19887) and shares no code with
the program. A layer is x += mixer(RMSNorm(x)); x += ffn(RMSNorm(x)),
RMSNorm in f32 with eps `sizes["eps"]`:

  * attention at layers i % attn_period == attn_offset: GQA, no bias, no
    positional encoding (HF `JambaAttention` has no rotary embedding),
    causal softmax(q k^T / sqrt(head_dim)) v;
  * Mamba-1 elsewhere: in_proj -> (x, z); causal depthwise conv plus
    bias, SiLU; x_proj -> (dt, B, C), each RMS-normed; delta =
    softplus(dt_proj(dt) + dt_bias); the scan h_t = exp(delta_t A) h_{t-1}
    + delta_t B_t x_t, y_t = C_t . h_t + D x_t, position by position;
    y * SiLU(z), out_proj;
  * FFN: SwiGLU; at layers i % expert_period == expert_offset, `experts`
    experts: a linear router, a softmax over all of them, the top-k taken
    with their softmax weights, not renormalised (HF
    `JambaSparseMoeBlock`), each token through its own k experts;
  * the final RMSNorm after the last layer; the feature of a review is the
    mean of that over its positions (the benchmark's cut: one period of
    8 layers, the norm moved to its end).

`draw_weights(sizes, seed, device)` draws every tensor from its own
seeded stream (splitmix64 of the seed and an FNV-1a hash of the name) in
float32 on `device` and rounds it to bfloat16, the values the program
holds; the reference upcasts them at each use. Matrices are N(0,
1/fan_in); the token table N(0, 1); norm weights ones; the conv bias
N(0, 1/d_conv); Mamba's published initialisation (arXiv:2312.00752) for
A_log (S4D-real: A = -(1..d_state) in each channel) and dt_bias (dt
log-uniform in [1e-3, 1e-1], through the inverse of softplus); D ones.

`scan_dtype=torch.bfloat16` keeps the scan's state in bfloat16 (rounded
after every position). `act_bits=m` rounds every activation the program
holds in its activation type (the residual stream, each norm's and each
product's output, the conv's, the scan's y) to m bits of mantissa, to
nearest even, with float32's exponent: 7 is bfloat16's mantissa, and 3
(float8 e4m3's) is the nearest precision below it, the benchmark's
control.
"""

from __future__ import annotations

import math

import torch

_F32 = torch.float32


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for (seed, stream): splitmix64 of both."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(stream) + 1) % (1 << 64)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % (1 << 64)
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def name_stream(name: str) -> int:
    """FNV-1a (64-bit) of the name's bytes: the stream of a tensor."""
    h = 0xCBF29CE484222325
    for byte in name.encode():
        h = ((h ^ byte) * 0x100000001B3) % (1 << 64)
    return h


def is_attention(sizes: dict, i: int) -> bool:
    return i % sizes["attn_period"] == sizes["attn_offset"]


def is_moe(sizes: dict, i: int) -> bool:
    return i % sizes["expert_period"] == sizes["expert_offset"]


def shapes(sizes: dict) -> dict:
    """{name: (shape, init)} of every weight, in drawing order; init is
    ("normal", std), ("ones",), ("a_log",) or ("dt_bias",)."""
    d, f, v = sizes["d_model"], sizes["d_ff"], sizes["vocab"]
    hq = sizes["heads"] * sizes["head_dim"]
    hkv = sizes["kv_heads"] * sizes["head_dim"]
    di = sizes["expand"] * d
    ds, dc, dr, e = (sizes["d_state"], sizes["d_conv"], sizes["dt_rank"],
                     sizes["experts"])

    def mat(*shape):
        return (shape, ("normal", 1.0 / math.sqrt(shape[-2])))

    out = {"tok": ((v, d), ("normal", 1.0))}
    for i in range(sizes["layers"]):
        p = f"{i}."
        out[p + "ln1"] = ((d,), ("ones",))
        if is_attention(sizes, i):
            out.update({p + "mixer.wq": mat(d, hq),
                        p + "mixer.wk": mat(d, hkv),
                        p + "mixer.wv": mat(d, hkv),
                        p + "mixer.wo": mat(hq, d)})
        else:
            out.update({
                p + "mixer.in_proj": mat(d, 2 * di),
                p + "mixer.conv_w": mat(dc, di),
                p + "mixer.conv_b": ((di,), ("normal", 1.0 / math.sqrt(dc))),
                p + "mixer.x_proj": mat(di, dr + 2 * ds),
                p + "mixer.dt_norm": ((dr,), ("ones",)),
                p + "mixer.b_norm": ((ds,), ("ones",)),
                p + "mixer.c_norm": ((ds,), ("ones",)),
                p + "mixer.dt_proj": mat(dr, di),
                p + "mixer.dt_bias": ((di,), ("dt_bias",)),
                p + "mixer.A_log": ((di, ds), ("a_log",)),
                p + "mixer.D": ((di,), ("ones",)),
                p + "mixer.out_proj": mat(di, d)})
        out[p + "ln2"] = ((d,), ("ones",))
        if is_moe(sizes, i):
            out.update({p + "ffn.router": mat(d, e),
                        p + "ffn.w1": mat(e, d, f), p + "ffn.w3": mat(e, d, f),
                        p + "ffn.w2": mat(e, f, d)})
        else:
            out.update({p + "ffn.w1": mat(d, f), p + "ffn.w3": mat(d, f),
                        p + "ffn.w2": mat(f, d)})
    out["ln_f"] = ((d,), ("ones",))
    if sizes.get("head"):
        out["out"] = mat(d, v)
    return out


def draw_weights(sizes: dict, seed: int, device) -> dict:
    """Every weight of `shapes(sizes)`, drawn in f32 on `device` from its
    own stream and rounded to bfloat16."""
    out = {}
    for name, (shape, init) in shapes(sizes).items():
        gen = torch.Generator(device=device).manual_seed(
            stream_seed(seed, name_stream(name)))
        if init[0] == "ones":
            w = torch.ones(shape, dtype=_F32, device=device)
        elif init[0] == "a_log":
            a = torch.arange(1, shape[1] + 1, dtype=_F32, device=device)
            w = torch.log(a).expand(shape).contiguous()
        elif init[0] == "dt_bias":
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                           + math.log(1e-3))
            w = dt + torch.log(-torch.expm1(-dt))  # softplus(w) = dt
        else:
            w = torch.randn(shape, generator=gen, device=device)
            w.mul_(init[1])
        out[name] = w.to(torch.bfloat16)
        del w
    return out


def round_mantissa(x: torch.Tensor, bits: int | None) -> torch.Tensor:
    """f32 `x` rounded to `bits` bits of mantissa, to nearest, ties to
    even (None: `x` as it is)."""
    if bits is None:
        return x
    drop = 23 - int(bits)
    v = x.contiguous().view(torch.int32)
    keep = (v >> drop) & 1
    out = (v + ((1 << (drop - 1)) - 1) + keep) & ~((1 << drop) - 1)
    return out.view(torch.float32)


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.to(_F32)


def _attention(w, p, h, sizes, r):
    s = h.shape[0]
    nh, nkv, hd = sizes["heads"], sizes["kv_heads"], sizes["head_dim"]
    q = r(h @ w[p + "wq"].to(_F32)).view(s, nh, hd).transpose(0, 1)
    k = r(h @ w[p + "wk"].to(_F32)).view(s, nkv, hd).transpose(0, 1)
    v = r(h @ w[p + "wv"].to(_F32)).view(s, nkv, hd).transpose(0, 1)
    k = k.repeat_interleave(nh // nkv, dim=0)
    v = v.repeat_interleave(nh // nkv, dim=0)
    scores = q @ k.transpose(1, 2) / math.sqrt(hd)
    causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = r(torch.softmax(scores, dim=-1) @ v)
    return r(o.transpose(0, 1).reshape(s, nh * hd) @ w[p + "wo"].to(_F32))


def _mamba(w, p, h, sizes, scan_dtype, r):
    s = h.shape[0]
    eps, dc, ds, dr = (sizes["eps"], sizes["d_conv"], sizes["d_state"],
                       sizes["dt_rank"])
    xz = r(h @ w[p + "in_proj"].to(_F32))
    x, z = xz.chunk(2, dim=-1)
    di = x.shape[1]
    xpad = torch.cat([torch.zeros((dc - 1, di), dtype=_F32,
                                  device=h.device), x])
    cw = w[p + "conv_w"].to(_F32)
    xc = sum(cw[j] * xpad[j:j + s] for j in range(dc))
    xc = r(torch.nn.functional.silu(xc + w[p + "conv_b"].to(_F32)))
    proj = r(xc @ w[p + "x_proj"].to(_F32))
    dt, B, C = proj[:, :dr], proj[:, dr:dr + ds], proj[:, dr + ds:]
    dt = r(_rms(dt, w[p + "dt_norm"], eps))
    B = r(_rms(B, w[p + "b_norm"], eps))
    C = r(_rms(C, w[p + "c_norm"], eps))
    delta = torch.nn.functional.softplus(
        r(dt @ w[p + "dt_proj"].to(_F32) + w[p + "dt_bias"].to(_F32)))
    A = -torch.exp(w[p + "A_log"].to(_F32))
    dA = torch.exp(delta[:, :, None] * A)                  # (s, di, ds)
    dBx = (delta * xc)[:, :, None] * B[:, None, :]
    hs = torch.empty((s, di, ds), dtype=_F32, device=h.device)
    state = torch.zeros((di, ds), dtype=_F32, device=h.device)
    for t in range(s):
        torch.addcmul(dBx[t], dA[t], state, out=hs[t])
        if scan_dtype != _F32:
            hs[t] = hs[t].to(scan_dtype).to(_F32)
        state = hs[t]
    y = (hs * C[:, None, :]).sum(-1) + w[p + "D"].to(_F32) * xc
    y = r(y * torch.nn.functional.silu(z))
    return r(y @ w[p + "out_proj"].to(_F32))


def _swiglu(h, w1, w3, w2, r):
    a = r(torch.nn.functional.silu(r(h @ w1.to(_F32))))
    return r(r(a * r(h @ w3.to(_F32))) @ w2.to(_F32))


def _moe(w, p, h, sizes, r):
    probs = torch.softmax(h @ w[p + "router"].to(_F32), dim=-1)
    gates, idx = torch.topk(probs, sizes["top_k"], dim=-1)
    out = torch.zeros_like(h)
    for e in range(sizes["experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = _swiglu(h[tok], w[p + "w1"][e], w[p + "w3"][e],
                        w[p + "w2"][e], r)
            out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out


def hidden(w: dict, sizes: dict, ids: torch.Tensor,
           scan_dtype=torch.float32, act_bits=None) -> torch.Tensor:
    """(s,) token ids of one review -> (s, d_model) f32 hidden state after
    the final RMSNorm."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        eps = sizes["eps"]

        def r(t):
            return round_mantissa(t, act_bits)

        x = w["tok"][ids].to(_F32)
        for i in range(sizes["layers"]):
            p = f"{i}."
            h = r(_rms(x, w[p + "ln1"], eps))
            if is_attention(sizes, i):
                x = r(x + _attention(w, p + "mixer.", h, sizes, r))
            else:
                x = r(x + _mamba(w, p + "mixer.", h, sizes, scan_dtype, r))
            h = r(_rms(x, w[p + "ln2"], eps))
            if is_moe(sizes, i):
                x = r(x + _moe(w, p + "ffn.", h, sizes, r))
            else:
                x = r(x + _swiglu(h, w[p + "ffn.w1"], w[p + "ffn.w3"],
                                  w[p + "ffn.w2"], r))
        return _rms(x, w["ln_f"], eps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def embed(w: dict, sizes: dict, ids: torch.Tensor,
          scan_dtype=torch.float32, act_bits=None) -> torch.Tensor:
    """The review's feature: the mean of `hidden` over its positions,
    (d_model,) f32."""
    return hidden(w, sizes, ids, scan_dtype, act_bits).mean(0)


def last_logits(w: dict, sizes: dict, ids: torch.Tensor) -> torch.Tensor:
    """The logits at the review's last position, (vocab,) f32 (needs the
    head: `sizes["head"]`)."""
    return hidden(w, sizes, ids)[-1] @ w["out"].to(_F32)
