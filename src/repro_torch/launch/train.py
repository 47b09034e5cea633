"""Training launcher of the port. Training itself (the loss, the optimizer
and the flash-attention backward) comes with a later slice (ROADMAP.md
queue A 11); this module holds `reduced_config`, which the serve launcher
and the tests use, as `repro.launch.train` does."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["reduced_config"]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """~100M-param member of the same family for a local run: the dense
    fields of `repro.launch.train.reduced_config`, f32."""
    kw = dict(d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
              vocab_size=min(cfg.vocab_size, 32000), tp_pad_heads=1,
              dtype=torch.float32)
    kw["num_layers"] = cfg.group_size * max(2, 16 // cfg.group_size)
    kw["d_ff"] = 0 if cfg.d_ff == 0 else 1536
    if cfg.sliding_window:
        kw["sliding_window"] = 512
    return cfg.replace(**kw)
