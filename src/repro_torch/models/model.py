"""Model factory of the port: one train/prefill/decode/embed API per
config (counterpart of `repro.models.model`), for the dense, MoE, SSM
and hybrid decoder families.

Batch conventions (labels[i] = next token at position i):
  {"tokens": (B, S) int, "labels": (B, S) int}    train (loss_fn)
  {"tokens": (B, S) int}                          prefill / embed
  {"tokens": (B, 1), "caches": ..., "index": int} decode
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import PD, ModelConfig, init_params, tree_leaves
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["Model", "build_model"]

AUX_COEF = 0.01  # MoE load-balance loss weight (aux is 0 without experts)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def desc(self):
        return T.model_desc(self.cfg)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda"):
        """Parameters drawn from `generator` (see `configs.base.
        init_params`), on `device`."""
        return init_params(self.desc(), generator, dtype, device)

    def _fwd(self, params, batch, mode, caches=None, index=None):
        return T.forward(params, self.cfg, batch["tokens"], mode=mode,
                         caches=caches, index=index,
                         kv_block=self.cfg.kv_block)

    def loss_fn(self, params, batch):
        """Mean next-token cross entropy of `batch` ("tokens", "labels")
        plus AUX_COEF times the MoE load-balancing loss summed over the
        MoE blocks -> (loss, {"ce", "aux"}), 0-d f32 tensors; differentiate
        it with torch.autograd."""
        logits, _, _, aux = self._fwd(params, batch, "train")
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
        role): the f32 mean over positions of the final hidden state."""
        _, hidden, _, _ = self._fwd(params, batch, "train")
        return torch.mean(hidden.to(torch.float32), dim=1)

    def init_caches(self, batch_size: int, max_len: int, dtype=None,
                    device="cuda"):
        return T.init_caches(self.cfg, batch_size, max_len, dtype=dtype,
                             device=device)

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
