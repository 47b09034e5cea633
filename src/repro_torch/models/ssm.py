"""State-space and recurrent mixers of the port: Mamba (Jamba) and
mLSTM/sLSTM (xLSTM). Counterpart of `repro.models.ssm`.

  * Mamba runs a chunked selective scan: a Python loop over chunks of
    `cfg.mamba_chunk` positions, a log-depth (Hillis-Steele) scan inside a
    chunk. The reference scans each chunk with `lax.associative_scan`, so
    the f32 sums round in another order. The discretized dA and dB*x are
    computed one chunk at a time (the reference materializes them for the
    whole sequence), so a prefill holds one chunk's (b, c, d_inner, state)
    tensors at a time.
  * mLSTM is gated linear attention with a matrix memory in its stabilized
    chunkwise form (the reference's chunk body, chunk by chunk), the last
    chunk padded as the reference pads it (log input gate -1e30).
  * sLSTM is sequential over time: one step a position, as the
    reference's `lax.scan` (a host-side loop here).

Decode carries O(1) state per layer: Mamba (conv window, ssm state),
mLSTM (C, n, m), sLSTM (h, c, n, m).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import PD, ModelConfig

__all__ = [
    "mamba_desc", "mamba_forward", "mamba_decode_step", "mamba_init_state",
    "MambaState",
    "mlstm_desc", "mlstm_forward", "mlstm_decode_step", "mlstm_init_state",
    "MLSTMState",
    "slstm_desc", "slstm_forward", "slstm_decode_step", "slstm_init_state",
    "SLSTMState",
]

_NEG = -1e30
_F32 = torch.float32


# =====================================================================
# Mamba (S6)
# =====================================================================
class MambaState(NamedTuple):
    conv: torch.Tensor  # (b, dconv-1, di) recent inputs of the causal conv
    ssm: torch.Tensor   # (b, di, dstate) f32


def mamba_desc(cfg: ModelConfig):
    di, ds, dc, dr = (cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_conv_dim,
                      cfg.dt_rank_)
    return {
        "in_proj": PD((cfg.d_model, 2 * di), ("embed", "inner")),
        "conv_w": PD((dc, di), ("conv", "inner"), scale=0.5),
        "conv_b": PD((di,), ("inner",), init="zeros"),
        "x_proj": PD((di, dr + 2 * ds), ("inner", None)),
        "dt_proj": PD((dr, di), (None, "inner")),
        "dt_bias": PD((di,), ("inner",), init="zeros"),
        "A_log": PD((di, ds), ("inner", "state"), init="ones"),
        "D": PD((di,), ("inner",), init="ones"),
        "out_proj": PD((di, cfg.d_model), ("inner", "embed")),
    }


def _scan_chunk(h_in, dA, dBx):
    """h_t = dA_t * h_{t-1} + dBx_t over one chunk, by a Hillis-Steele
    inclusive scan of the pairs (dA, dBx) in log2(c) steps. dA, dBx:
    (b, c, di, ds) f32; h_in (b, di, ds). Returns every h_t."""
    a, bx = dA, dBx
    c = a.shape[1]
    off = 1
    while off < c:
        # compose (a[t-off], bx[t-off]) then (a[t], bx[t]) for t >= off
        bx = torch.cat([bx[:, :off], a[:, off:] * bx[:, :-off] + bx[:, off:]],
                       dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a * h_in[:, None] + bx


def _mamba_inner(p, xz, cfg: ModelConfig, state: MambaState | None):
    """xz: (b, s, 2*di) pre-projected input -> (y (b, s, di), state)."""
    b, s, _ = xz.shape
    di, ds, dc = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_conv_dim
    x, z = torch.chunk(xz, 2, dim=-1)
    # causal depthwise conv over time (window dc)
    if state is None:
        hist = torch.zeros((b, dc - 1, di), dtype=x.dtype, device=x.device)
    else:
        hist = state.conv.to(x.dtype)
    xc = torch.cat([hist, x], dim=1)
    conv_hist = xc[:, xc.shape[1] - (dc - 1):, :]
    w = p["conv_w"].to(x.dtype)  # (dc, di)
    xconv = sum(xc[:, i:i + s, :] * w[i] for i in range(dc))
    xconv = F.silu(xconv + p["conv_b"].to(x.dtype))

    proj = xconv @ p["x_proj"].to(x.dtype)  # (b, s, dr + 2 ds)
    dr = cfg.dt_rank_
    dt, B, C = proj[..., :dr], proj[..., dr:dr + ds], proj[..., dr + ds:]
    dt = F.softplus(dt @ p["dt_proj"].to(x.dtype)
                    + p["dt_bias"].to(x.dtype)).to(_F32)  # (b, s, di)
    A = -torch.exp(p["A_log"].to(_F32))  # (di, ds)
    dtx = dt * xconv.to(_F32)
    Bf, Cf = B.to(_F32), C.to(_F32)

    h = (torch.zeros((b, di, ds), dtype=_F32, device=x.device)
         if state is None else state.ssm)
    chunk = min(cfg.mamba_chunk, s)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        dA = torch.exp(dt[:, sl, :, None] * A)  # (b, c, di, ds)
        dBx = dtx[:, sl, :, None] * Bf[:, sl, None, :]
        h_all = _scan_chunk(h, dA, dBx)
        h = h_all[:, -1]
        ys.append(torch.sum(h_all * Cf[:, sl, None, :], dim=-1))
    y = torch.cat(ys, dim=1) + xconv.to(_F32) * p["D"].to(_F32)
    y = y.to(xz.dtype) * F.silu(z)
    return y, MambaState(conv=conv_hist.to(_F32), ssm=h)


def mamba_forward(p, x, cfg: ModelConfig, state: MambaState | None = None):
    """x: (b, s, d_model) -> (y (b, s, d_model), final state)."""
    xz = x @ p["in_proj"].to(x.dtype)
    y, st = _mamba_inner(p, xz, cfg, state)
    return y @ p["out_proj"].to(x.dtype), st


def mamba_decode_step(p, x, cfg: ModelConfig, state: MambaState):
    return mamba_forward(p, x, cfg, state)


def mamba_init_state(cfg: ModelConfig, b: int, device="cpu") -> MambaState:
    return MambaState(
        conv=torch.zeros((b, cfg.ssm_conv_dim - 1, cfg.d_inner), dtype=_F32,
                         device=device),
        ssm=torch.zeros((b, cfg.d_inner, cfg.ssm_state_dim), dtype=_F32,
                        device=device),
    )


# =====================================================================
# mLSTM (xLSTM): gated linear attention with matrix memory
# =====================================================================
class MLSTMState(NamedTuple):
    C: torch.Tensor  # (b, h, dk, dv) f32 matrix memory, scaled by exp(-m)
    n: torch.Tensor  # (b, h, dk) f32 normalizer, scaled by exp(-m)
    m: torch.Tensor  # (b, h) f32 running log-scale stabilizer


def mlstm_desc(cfg: ModelConfig):
    h = cfg.num_heads
    dk = cfg.d_model // h
    dv = cfg.d_model // h
    return {
        "wq": PD((cfg.d_model, h * dk), ("embed", None)),
        "wk": PD((cfg.d_model, h * dk), ("embed", None)),
        "wv": PD((cfg.d_model, h * dv), ("embed", "dv")),
        "wi": PD((cfg.d_model, h), ("embed", None), scale=0.02),
        "wf": PD((cfg.d_model, h), ("embed", None), scale=0.02),
        "wo_gate": PD((cfg.d_model, cfg.d_model), ("embed", "dv")),
        "w_out": PD((cfg.d_model, cfg.d_model), ("dv", "embed")),
        "f_bias": PD((h,), (None,), init="ones"),
    }


def _mlstm_gates(p, x):
    xf = x.to(_F32)
    lf = F.logsigmoid(xf @ p["wf"].to(_F32) + p["f_bias"].to(_F32))  # <= 0
    li = xf @ p["wi"].to(_F32)  # log input gate
    return lf, li


def _mlstm_chunk(C, n, m_in, qb, kb, vb, lfb, lib):
    """Stabilized chunkwise mLSTM (xLSTM appendix), the reference's chunk
    body: the carried (C, n) is scaled by exp(-m_in); every exponent is
    shifted by a per-position stabilizer m_t = max(intra log-weights,
    m_in + cum_t), which cancels in the output ratio and never
    overflows. qb, kb, vb: (b, c, h, d); lfb, lib: (b, c, h)."""
    chunk = qb.shape[1]
    cum = torch.cumsum(lfb, dim=1)  # (b, c, h) within-chunk log decay
    total = cum[:, -1]  # (b, h)
    qf, kf, vf = qb.to(_F32), kb.to(_F32), vb.to(_F32)
    # intra log-weights: dec[t, s] = cum_t - cum_s + li_s  (s <= t)
    dec = (cum[:, :, None, :] - cum[:, None, :, :]
           + lib[:, None, :, :]).permute(0, 3, 1, 2)  # (b, h, t, s)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=qb.device))
    dec = torch.where(tri, dec, _NEG)
    inter_log = m_in[:, :, None] + cum.transpose(1, 2)  # (b, h, t)
    m_t = torch.maximum(dec.amax(-1), inter_log)  # (b, h, t)
    wgt = torch.exp(dec - m_t[..., None])  # <= 1
    wgt_inter = torch.exp(inter_log - m_t)  # (b, h, t)
    logits = torch.einsum("bthd,bshd->bhts", qf, kf)
    intra = torch.einsum("bhts,bshd->bthd", logits * wgt, vf)
    den_k = torch.einsum("bhts,bshd->bthd", wgt, kf)
    inter = torch.einsum("bthd,bhdv,bht->bthv", qf, C, wgt_inter)
    num = intra + inter
    den = (torch.einsum("bthd,bhd,bht->bth", qf, n, wgt_inter)
           + torch.einsum("bthd,bthd->bth", qf, den_k))
    mt_bth = m_t.transpose(1, 2)  # (b, t, h)
    out = num / torch.maximum(den.abs(), torch.exp(-mt_bth))[..., None]
    # the state update in the new scale m_out
    s_log = total[:, None] - cum + lib  # (b, c, h) per-key exponent
    m_out = torch.maximum(m_in + total, s_log.amax(1))  # (b, h)
    sdecay = torch.exp(s_log - m_out[:, None, :])
    carryscale = torch.exp(m_in + total - m_out)
    kv = torch.einsum("bshd,bshv,bsh->bhdv", kf, vf, sdecay)
    ksum = torch.einsum("bshd,bsh->bhd", kf, sdecay)
    C_new = carryscale[:, :, None, None] * C + kv
    n_new = carryscale[:, :, None] * n + ksum
    return C_new, n_new, m_out, out


def mlstm_forward(p, x, cfg: ModelConfig, state: MLSTMState | None = None):
    """Chunkwise mLSTM. x: (b, s, d_model) -> (y, final state)."""
    b, s, dm = x.shape
    h = cfg.num_heads
    dk = dm // h
    dv = dm // h
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, h, dk) / (dk ** 0.5)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, h, dk)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, h, dv)
    lf, li = _mlstm_gates(p, x)  # (b, s, h)

    chunk = min(cfg.mlstm_chunk, s)
    nchunk = -(-s // chunk)
    pad = nchunk * chunk - s
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        lf = F.pad(lf, (0, 0, 0, pad))
        li = F.pad(li, (0, 0, 0, pad), value=_NEG)

    if state is None:
        C = torch.zeros((b, h, dk, dv), dtype=_F32, device=x.device)
        n = torch.zeros((b, h, dk), dtype=_F32, device=x.device)
        m = torch.full((b, h), _NEG, dtype=_F32, device=x.device)
    else:
        C, n, m = state.C, state.n, state.m
    outs = []
    for c0 in range(0, nchunk * chunk, chunk):
        sl = slice(c0, c0 + chunk)
        C, n, m, o = _mlstm_chunk(C, n, m, q[:, sl], k[:, sl], v[:, sl],
                                  lf[:, sl], li[:, sl])
        outs.append(o)
    out = torch.cat(outs, dim=1).reshape(b, nchunk * chunk, h * dv)[:, :s]
    gate = torch.sigmoid(x.to(_F32) @ p["wo_gate"].to(_F32))
    y = (out * gate).to(x.dtype) @ p["w_out"].to(x.dtype)
    return y, MLSTMState(C, n, m)


def mlstm_decode_step(p, x, cfg: ModelConfig, state: MLSTMState):
    """Single-token recurrent step (O(1) memory), stabilized form."""
    b, _, dm = x.shape
    h = cfg.num_heads
    dk = dm // h
    q = (x @ p["wq"].to(x.dtype)).reshape(b, h, dk).to(_F32) / (dk ** 0.5)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, h, dk).to(_F32)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, h, dk).to(_F32)
    lf, li = _mlstm_gates(p, x)  # (b, 1, h)
    lf, li = lf[:, 0], li[:, 0]  # (b, h)
    m_new = torch.maximum(lf + state.m, li)
    f = torch.exp(lf + state.m - m_new)[..., None, None]
    i = torch.exp(li - m_new)[..., None, None]
    C = f * state.C + i * k[..., :, None] * v[..., None, :]
    n = f[..., 0] * state.n + i[..., 0] * k
    num = torch.einsum("bhd,bhdv->bhv", q, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(),
                        torch.exp(-m_new))[..., None]
    out = (num / den).reshape(b, 1, dm)
    gate = torch.sigmoid(x.to(_F32) @ p["wo_gate"].to(_F32))
    y = (out * gate).to(x.dtype) @ p["w_out"].to(x.dtype)
    return y, MLSTMState(C, n, m_new)


def mlstm_init_state(cfg: ModelConfig, b: int, device="cpu") -> MLSTMState:
    h = cfg.num_heads
    dk = cfg.d_model // h
    return MLSTMState(
        C=torch.zeros((b, h, dk, dk), dtype=_F32, device=device),
        n=torch.zeros((b, h, dk), dtype=_F32, device=device),
        m=torch.full((b, h), _NEG, dtype=_F32, device=device),
    )


# =====================================================================
# sLSTM (xLSTM): scalar memory, exponential gating, sequential over time
# =====================================================================
class SLSTMState(NamedTuple):
    h: torch.Tensor  # (b, d)
    c: torch.Tensor  # (b, d)
    n: torch.Tensor  # (b, d)
    m: torch.Tensor  # (b, d) stabilizer


def slstm_desc(cfg: ModelConfig):
    d = cfg.d_model
    return {
        "w_in": PD((d, 4 * d), ("embed", None)),   # i, f, z, o pre-acts
        "r": PD((d, 4 * d), (None, None), scale=0.02),  # recurrent
        "b": PD((4 * d,), (None,), init="zeros"),
    }


def _slstm_step(r, bias, carry: SLSTMState, x_t):
    """x_t: (b, 4d) pre-projected input; r, bias in x_t's type. An h of
    another type is promoted as JAX promotes it (bf16 @ f32 -> f32)."""
    h, c, n, m = carry
    hr = h.to(torch.promote_types(h.dtype, r.dtype)) @ r
    pre = x_t + hr + bias
    i_p, f_p, z_p, o_p = torch.chunk(pre.to(_F32), 4, dim=-1)
    m_new = torch.maximum(f_p + m, i_p)  # exponential-gate stabilizer
    i = torch.exp(i_p - m_new)
    f = torch.exp(f_p + m - m_new)
    c_new = f * c + i * torch.tanh(z_p)
    n_new = f * n + i
    h_new = (torch.sigmoid(o_p) * c_new / torch.clamp_min(n_new, 1.0)).to(
        x_t.dtype)
    return SLSTMState(h_new, c_new, n_new, m_new)


def slstm_forward(p, x, cfg: ModelConfig, state: SLSTMState | None = None):
    b, s, d = x.shape
    xin = x @ p["w_in"].to(x.dtype)  # (b, s, 4d)
    if state is None:
        state = slstm_init_state(cfg, b, x.dtype, x.device)
    r, bias = p["r"].to(x.dtype), p["b"].to(x.dtype)
    hs = []
    for t in range(s):
        state = _slstm_step(r, bias, state, xin[:, t])
        hs.append(state.h)
    return torch.stack(hs, dim=1), state


def slstm_decode_step(p, x, cfg: ModelConfig, state: SLSTMState):
    xin = (x @ p["w_in"].to(x.dtype))[:, 0]
    st = _slstm_step(p["r"].to(x.dtype), p["b"].to(x.dtype), state, xin)
    return st.h[:, None, :], st


def slstm_init_state(cfg: ModelConfig, b: int, dtype=torch.bfloat16,
                     device="cpu") -> SLSTMState:
    """The reference's initial state; its h defaults to bf16 whatever the
    activation type (`repro.models.ssm.slstm_init_state`), which the
    decode caches keep (ROADMAP.md queue C 1.4)."""
    d = cfg.d_model
    return SLSTMState(
        h=torch.zeros((b, d), dtype=dtype, device=device),
        c=torch.zeros((b, d), dtype=_F32, device=device),
        n=torch.zeros((b, d), dtype=_F32, device=device),
        m=torch.zeros((b, d), dtype=_F32, device=device),
    )
