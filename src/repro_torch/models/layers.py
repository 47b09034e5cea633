"""Shared neural layers of the port: norms, RoPE, MLPs, embeddings
(counterpart of `repro.models.layers`).

Weights are stored in their own type (f32 by default) and cast to the
activation type at every use, as the JAX package does. Norms, RoPE and
the logits run in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import PD, ModelConfig

__all__ = [
    "norm_desc", "apply_norm", "rope", "mlp_desc", "apply_mlp",
    "embedding_desc", "embed_tokens", "logits_from_hidden", "cross_entropy",
]


# ------------------------------------------------------------------- norms
def norm_desc(cfg: ModelConfig, kind: str | None = None):
    kind = kind or cfg.norm_kind
    d = {"scale": PD((cfg.d_model,), ("embed",), init="ones")}
    if kind == "layernorm":
        d["bias"] = PD((cfg.d_model,), ("embed",), init="zeros")
    return d


def apply_norm(p, x, cfg: ModelConfig, kind: str | None = None):
    kind = kind or cfg.norm_kind
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, -1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].to(
            torch.float32)
    else:
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.var(xf, -1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return out.to(x.dtype)


# -------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding on split halves. x: (..., s, h, hd), positions:
    (..., s); angles in f32."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- mlp
def mlp_desc(cfg: ModelConfig, d_ff: int | None = None,
             axes=("embed", "mlp")):
    f = d_ff or cfg.d_ff
    a_in, a_out = axes
    d = {
        "w1": PD((cfg.d_model, f), (a_in, a_out)),
        "w2": PD((f, cfg.d_model), (a_out, a_in)),
    }
    if cfg.act == "silu":  # gated (SwiGLU)
        d["w3"] = PD((cfg.d_model, f), (a_in, a_out))
    return d


def apply_mlp(p, x, cfg: ModelConfig):
    h = x @ p["w1"].to(x.dtype)
    if cfg.act == "silu":
        h = F.silu(h) * (x @ p["w3"].to(x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h @ p["w2"].to(x.dtype)


# --------------------------------------------------------------- embeddings
def embedding_desc(cfg: ModelConfig):
    d = {"tok": PD((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                   init="embed")}
    if not cfg.tie_embeddings:
        d["out"] = PD((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))
    return d


def embed_tokens(p, tokens, cfg: ModelConfig):
    return p["tok"][tokens].to(cfg.dtype)


def logits_from_hidden(p, x, cfg: ModelConfig):
    """(..., d_model) -> (..., padded_vocab) f32 logits; the padded vocab
    columns are -1e30, so they never receive probability mass."""
    w = p["tok"].T if cfg.tie_embeddings else p["out"]
    if cfg.logits_f32:
        logits = x.to(torch.float32) @ w.to(torch.float32)
    else:
        # bf16 operands, f32 accumulation: a product of two bf16 values is
        # exact in f32, so widening the rounded operands and multiplying in
        # f32 is that contraction
        logits = x.to(cfg.dtype).to(torch.float32) @ w.to(cfg.dtype).to(
            torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
