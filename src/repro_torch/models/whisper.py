"""Whisper-style encoder-decoder of the port (counterpart of
`repro.models.whisper`). The audio conv frontend is a stub, as in the
reference: the caller passes precomputed frame embeddings (b, enc_seq,
d_model); the encoder is a non-causal transformer over them (its
self-attention through the flash-attention kernel when no gradient is
needed), the decoder the causal LM of `models.transformer` with a
cross-attention sub-block in every block.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import PD, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["whisper_desc", "encode", "whisper_forward"]


def _enc_block_desc(cfg: ModelConfig):
    return {
        "ln1": L.norm_desc(cfg),
        "attn": A.attn_desc(cfg),
        "ln2": L.norm_desc(cfg),
        "ffn": L.mlp_desc(cfg),
    }


def whisper_desc(cfg: ModelConfig):
    return {
        "enc_pos": PD((cfg.encoder_seq, cfg.d_model), (None, "embed"),
                      init="embed"),
        "enc_groups": T._stack_desc(_enc_block_desc(cfg), cfg.encoder_layers),
        "enc_ln_f": L.norm_desc(cfg),
        "decoder": T.model_desc(cfg),
    }


def encode(params, cfg: ModelConfig, frames):
    """frames: (b, enc_seq, d_model) stub embeddings -> the encoder output
    (b, enc_seq, d_model) in cfg.dtype. Each block is recomputed in the
    backward pass (`cfg.remat`) when grad is on."""
    if frames is None:
        raise ValueError(
            f"{cfg.name} encodes audio frames: the batch needs 'frames', "
            f"(b, {cfg.encoder_seq}, {cfg.d_model}) frame embeddings")
    x = frames.to(cfg.dtype) + params["enc_pos"].to(cfg.dtype)[None]

    def block(x, gp):
        h = L.apply_norm(gp["ln1"], x, cfg)
        x = x + A.attention(gp["attn"], h, cfg, causal=False, use_rope=False)
        h = L.apply_norm(gp["ln2"], x, cfg)
        return x + L.apply_mlp(gp["ffn"], h, cfg)

    if cfg.remat != "none" and torch.is_grad_enabled():
        block = T._remat(block, cfg)
    for gp in T._unstack(params["enc_groups"], cfg.encoder_layers):
        x = block(x, gp)
    return L.apply_norm(params["enc_ln_f"], x, cfg)


def whisper_forward(params, cfg: ModelConfig, tokens, frames=None, *,
                    mode="train", caches=None, index=None, enc_out=None,
                    kv_block=1024):
    """Full enc-dec forward -> `transformer.forward`'s (logits, hidden,
    caches, aux). In decode mode the encoder is not re-run: the cross k/v
    live in the caches (built at prefill)."""
    if mode != "decode" and enc_out is None:
        enc_out = encode(params, cfg, frames)
    return T.forward(params["decoder"], cfg, tokens, mode=mode,
                     caches=caches, index=index, enc_out=enc_out,
                     kv_block=kv_block)
