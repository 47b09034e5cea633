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
from repro_torch.tracing import count, span

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

    def one_row(self, params) -> T.Rows:
        """`params` (a whole tree on one device) as the `Rows` of one
        row."""
        if self.cfg.family == "audio":
            return T.one_row(params["decoder"], self.cfg, encoder={
                k: v for k, v in params.items() if k != "decoder"})
        return T.one_row(params, self.cfg)

    def forward_rows(self, rows: T.Rows, batches: list, mode: str,
                     caches=None, index=None):
        """The family's forward over the data rows of `rows`, `batches`
        one batch per row (on the row's device) -> `T.forward_rows`'
        (logits, hidden, caches, aux), all but aux one entry per row. The
        audio family encodes each row's frames first (not in decode: the
        cross k/v live in the caches), at `whisper_forward`'s kv_block."""
        cfg = self.cfg
        enc = None
        if cfg.family == "audio" and mode != "decode":
            enc = [W.encode(p, cfg, b.get("frames"))
                   for p, b in zip(rows.encoder(), batches)]
        return T.forward_rows(
            rows, cfg, [b["tokens"] for b in batches], mode=mode,
            caches=caches, index=index,
            extra_embeds=([b["patch_embeds"] for b in batches]
                          if "patch_embeds" in batches[0] else None),
            kv_block=1024 if cfg.family == "audio" else cfg.kv_block,
            enc_out=enc)

    def _fwd(self, params, batch, mode, caches=None, index=None):
        logits, hidden, caches, aux = self.forward_rows(
            self.one_row(params), [batch], mode,
            None if caches is None else [caches], index)
        return logits[0], hidden[0], None if caches is None else caches[0], \
            aux

    def loss_rows(self, rows: T.Rows, batches: list):
        """`loss_fn` over the data rows of `rows` (`batches` one per row,
        of equal size): the rows' mean cross entropies averaged, on row
        0's device."""
        logits, _, _, aux = self.forward_rows(rows, batches, "train")
        ces = []
        for lg, b in zip(logits, batches):
            if self.cfg.family == "vlm":
                lg = lg[:, b["patch_embeds"].shape[1]:, :]
            ces.append(L.cross_entropy(lg, b["labels"]).to(aux.device))
        ce = ces[0] if len(ces) == 1 else torch.stack(ces).mean()
        return ce + AUX_COEF * aux, {"ce": ce, "aux": aux}

    def loss_fn(self, params, batch):
        """Mean next-token cross entropy of `batch` (the text segment only
        for the VLM) plus AUX_COEF times the MoE load-balancing loss summed
        over the MoE blocks -> (loss, {"ce", "aux"}), 0-d f32 tensors;
        differentiate it with torch.autograd."""
        return self.loss_rows(self.one_row(params), [batch])

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
        """Pooled features for KNN valuation (the paper's extractor role),
        (B, d_model) f32, computed with no autograd and no logits.

        Without "lengths": the mean over every position of the final
        hidden state (the VLM's patch positions included), or for audio
        of the encoder output. With "lengths" (B,) ints, `batch["tokens"]`
        (B, S) is right-padded (any id past a row's length, -1 among
        them): the mean over each row's real positions only. Padding
        then routes to no expert (`models.moe.apply_moe_dropless`), the
        card's Mamba scan stops at each length, and causal attention and
        the conv never carry a padded position into a real one, so a
        real row's features do not depend on how far it is padded.

        Spans: `embed.forward` (the layers and the final norm) and
        `embed.pool`; counters `lm.tokens` (real positions) and
        `lm.positions` (positions computed)."""
        cfg = self.cfg
        with torch.no_grad():
            if cfg.family == "audio":
                return torch.mean(W.encode(params, cfg, batch["frames"])
                                  .to(torch.float32), 1)
            tokens, lengths = batch["tokens"], batch.get("lengths")
            if lengths is not None:
                lengths = lengths.to(tokens.device)
                tokens = tokens.clamp_min(0)
                count("lm.tokens", lengths.sum())
            count("lm.positions", tokens.numel())
            pe = batch.get("patch_embeds")
            with span("embed.forward"):
                hidden = T.forward_rows(
                    self.one_row(params), cfg, [tokens], mode="train",
                    extra_embeds=None if pe is None else [pe],
                    kv_block=1024,
                    lengths=None if lengths is None else [lengths],
                    logits=False)[1][0]
            with span("embed.pool"):
                hf = hidden.to(torch.float32)
                if lengths is None:
                    return torch.mean(hf, dim=1)
                real = (torch.arange(hf.shape[1], device=hf.device)[None, :]
                        < lengths[:, None])
                return (hf * real[..., None]).sum(1) / torch.clamp_min(
                    lengths, 1)[:, None].to(torch.float32)

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
