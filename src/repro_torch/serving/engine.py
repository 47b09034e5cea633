"""Batched serving engine of the port (counterpart of
`repro.serving.engine`): per-slot prefill into the pooled caches (KV
caches, SSM states), then one decode over the whole slot pool per step,
greedy or temperature sampling.

Finished slots are refilled from the queue between steps. The decode step
runs every slot at ONE shared index, the largest position in the pool
(`self.pos.max()`, finished slots included), as the JAX engine does
(`repro/serving/engine.py:62`): a slot whose own position is smaller
decodes at the wrong rotary position and writes its K/V at the wrong
cache slot. That is a fault of the reference (ROADMAP.md queue C), and
the port reproduces it, so that both engines give the same tokens. So it
does two more of the reference's: an MoE decode routes the whole pool as
one group, empty slots included, with capacity int(slots * k * cf / E) + 1
(queue C 1.5); and a prefilled sLSTM h is rounded into the pool's bf16
leaf until the first decode step rebinds that leaf in the activation type
(queue C 1.4).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, tree_leaves
from repro_torch.models import build_model
from repro_torch.models.attention import EMPTY_POS

__all__ = ["ServeConfig", "Engine"]


@dataclass
class ServeConfig:
    max_slots: int = 8
    max_len: int = 256
    temperature: float = 0.0
    eos_id: int = 1
    seed: int = 0


@dataclass
class _Slot:
    request_id: int = -1
    generated: list = field(default_factory=list)
    done: bool = True


class Engine:
    """Serves token requests with `params` on their own device (the card
    when the caller built them there)."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params):
        self.cfg = cfg
        self.scfg = scfg
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.model = build_model(cfg)
        self.slots = [_Slot() for _ in range(scfg.max_slots)]
        self.caches = self.model.init_caches(scfg.max_slots, scfg.max_len,
                                             device=self.device)
        self.pos = np.zeros(scfg.max_slots, np.int32)
        self.queue: list[tuple[int, np.ndarray]] = []
        self.results: dict[int, list[int]] = {}
        self._next_id = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(scfg.seed)

    # ------------------------------------------------------------ public
    def submit(self, prompt_tokens) -> int:
        # sync-point: prompt staging copies the client's tokens once
        prompt = np.asarray(prompt_tokens, np.int64)
        if prompt.ndim != 1 or not 0 < len(prompt) <= self.scfg.max_len:
            raise ValueError(f"a prompt is 1 to {self.scfg.max_len} tokens, "
                             f"got shape {prompt.shape}")
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, prompt))
        return rid

    def run(self, max_steps: int = 10**6) -> dict[int, list[int]]:
        """Drive until queue and slots drain (or step budget)."""
        step = 0
        while step < max_steps and (self.queue or
                                    any(not s.done for s in self.slots)):
            self._admit()
            self._step()
            step += 1
        return self.results

    # ----------------------------------------------------------- internal
    @torch.no_grad()
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(b, V) f32 logits -> (b,) token ids."""
        if self.scfg.temperature > 0:
            probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.argmax(logits, dim=-1)

    @torch.no_grad()
    def _admit(self):
        for i, slot in enumerate(self.slots):
            if not slot.done or not self.queue:
                continue
            rid, prompt = self.queue.pop(0)
            # prefill one slot (batch 1) and write it into the pool at i
            toks = torch.from_numpy(prompt[None, :]).to(self.device)
            last_logits, caches1 = self.model.prefill(self.params,
                                                      {"tokens": toks})
            first = int(self._sample(last_logits[:, 0])[0])
            n = len(prompt)
            for pool, one in zip(self.caches, caches1):
                if "kv" in pool:
                    pk, ok = pool["kv"], one["kv"]
                    pk.k[:, i].zero_()
                    pk.v[:, i].zero_()
                    pk.pos[:, i] = EMPTY_POS
                    pk.k[:, i, :, :n] = ok.k[:, 0]
                    pk.v[:, i, :, :n] = ok.v[:, 0]
                    pk.pos[:, i, :n] = ok.pos[:, 0]
                else:  # an SSM state: each leaf whole, in the pool's type
                    for leaf, new in zip(pool["ssm"], one["ssm"]):
                        leaf[:, i].copy_(new[:, 0])
            self.slots[i] = _Slot(rid, [first], False)
            self.pos[i] = n
            if first == self.scfg.eos_id:
                self.slots[i].done = True
                self.results[rid] = [first]

    @torch.no_grad()
    def _step(self):
        tokens = np.zeros((self.scfg.max_slots, 1), np.int64)
        for i, s in enumerate(self.slots):
            if not s.done and s.generated:
                tokens[i, 0] = s.generated[-1]
        logits, self.caches = self.model.decode_step(
            self.params, {"tokens": torch.from_numpy(tokens).to(self.device),
                          "caches": self.caches,
                          "index": int(self.pos.max())})
        # sync-point: the sampled tokens feed the host's slot bookkeeping,
        # one sync per decode step
        nxt = self._sample(logits[:, 0]).cpu().numpy()
        for i, s in enumerate(self.slots):
            if s.done:
                continue
            tok = int(nxt[i])
            s.generated.append(tok)
            self.pos[i] += 1
            if tok == self.scfg.eos_id or self.pos[i] >= self.scfg.max_len - 1:
                s.done = True
                self.results[s.request_id] = s.generated
