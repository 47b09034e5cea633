"""Model factory of the port: one train/prefill/decode/embed API per
config (counterpart of `repro.models.model`), for every family: dense,
MoE, SSM and hybrid decoders, the audio encoder-decoder and the VLM.

Batch conventions (labels[i] = next token at position i):
  dense/moe/ssm/hybrid : {"tokens": (B, S) int, "labels": (B, S) int}
  vlm    : + {"patch_embeds": (B, P, D)}; loss on the text segment only
  audio  : {"frames": (B, E, D), "tokens": (B, S) int, "labels": (B, S) int}
  prefill / embed: the same without "labels"
  decode : {"tokens": (B, 1), "caches": ..., "index": int}
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import (
    PD, ModelConfig, abstract_params, init_params, spec_tree, tree_leaves)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W

__all__ = ["Model", "build_model"]

AUX_COEF = 0.01  # MoE load-balance loss weight (aux is 0 without experts)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def desc(self):
        if self.cfg.family == "audio":
            return W.whisper_desc(self.cfg)
        return T.model_desc(self.cfg)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda"):
        """Parameters drawn from `generator` (see `configs.base.
        init_params`), on `device`."""
        return init_params(self.desc(), generator, dtype, device)

    def abstract(self, dtype=torch.float32):
        """The parameter tree on the meta device (shapes, no storage)."""
        return abstract_params(self.desc(), dtype)

    def param_spec(self, rules):
        """Per leaf, the mesh-axis names of its dimensions under `rules`
        (`configs.base.spec_tree`)."""
        return spec_tree(self.desc(), rules)

    def _fwd(self, params, batch, mode, caches=None, index=None):
        cfg = self.cfg
        if cfg.family == "audio":
            return W.whisper_forward(
                params, cfg, batch["tokens"], batch.get("frames"),
                mode=mode, caches=caches, index=index)
        return T.forward(params, cfg, batch["tokens"], mode=mode,
                         caches=caches, index=index,
                         extra_embeds=batch.get("patch_embeds"),
                         kv_block=cfg.kv_block)

    def loss_fn(self, params, batch):
        """Mean next-token cross entropy of `batch` (the text segment only
        for the VLM) plus AUX_COEF times the MoE load-balancing loss summed
        over the MoE blocks -> (loss, {"ce", "aux"}), 0-d f32 tensors;
        differentiate it with torch.autograd."""
        logits, _, _, aux = self._fwd(params, batch, "train")
        if self.cfg.family == "vlm":
            logits = logits[:, batch["patch_embeds"].shape[1]:, :]
        loss = L.cross_entropy(logits, batch["labels"])
        return loss + AUX_COEF * aux, {"ce": loss, "aux": aux}

    def prefill(self, params, batch):
        """-> (logits at the last position (B, 1, V), stacked caches)."""
        logits, _, caches, _ = self._fwd(params, batch, "prefill")
        return logits[:, -1:], caches

    def decode_step(self, params, batch):
        """-> (logits (B, 1, V), caches written in place; an SSM state
        whose type changes is rebound in the returned caches)."""
        logits, _, caches, _ = self._fwd(
            params, batch, "decode", caches=batch["caches"],
            index=batch["index"])
        return logits, caches

    def embed(self, params, batch):
        """Pooled features for STI-KNN valuation (the paper's extractor
        role): the f32 mean over positions of the final hidden state (the
        VLM's patch positions included), or for audio of the encoder
        output."""
        cfg = self.cfg
        if cfg.family == "audio":
            return torch.mean(
                W.encode(params, cfg, batch["frames"]).to(torch.float32), 1)
        _, hidden, _, _ = T.forward(params, cfg, batch["tokens"],
                                    mode="train",
                                    extra_embeds=batch.get("patch_embeds"))
        return torch.mean(hidden.to(torch.float32), dim=1)

    def init_caches(self, batch_size: int, max_len: int, dtype=None,
                    device="cuda"):
        cfg = self.cfg
        enc_len = cfg.encoder_seq if cfg.family == "audio" else 0
        return T.init_caches(cfg, batch_size, max_len, enc_len=enc_len,
                             dtype=dtype, device=device)

    def num_params(self) -> int:
        total = 0
        for pd in tree_leaves(self.desc(),
                              is_leaf=lambda x: isinstance(x, PD)):
            n = 1
            for s in pd.shape:
                n *= s
            total += n
        return total


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
