"""Named spans at the layer boundaries of the streaming step and of the
LM's embedding, and counters of what the LM computed.

    from repro_torch.tracing import span
    with span("step.rank"):
        order, ranks = rank_order(d2)

While `torch.profiler` records, `span(name)` opens a range in its trace,
on the profiler's clock, so every range lines up with the device
timeline the profiler records beside it: a kernel's launch, an idle gap
of the card or a runtime call that waits on it falls inside the ranges
open at that moment. With no profiler recording it returns one shared
no-op context and costs a flag check. Nothing is kept or written here:
the events stay in the profiler's memory.

The ranges are function-scope events (`cpu_op` in the profiler's trace),
not user annotations: the profiler mirrors a user annotation onto the
device timeline, and a reader of the trace that takes every device event
for device work would count that mirror as busy time. Which range holds
what is read by name, from `SPANS`.

`SPANS` is every name the package opens, in the order a step opens them:

  * `session.update`: `ValuationSession.update`, the host's enqueue of
    one call (one or more steps);
  * `embed.forward`: `Model.embed`'s forward through the layers, the
    final norm included (inside `session.update` where the session's
    `embed_fn` embeds each test batch);
  * `lm.attn`, `lm.mamba`, `lm.mlp`, `lm.moe`: one block's mixer
    (attention or Mamba) or FFN (dense or experts), its norm included;
  * `lm.scan`: the selective scan alone, inside `lm.mamba`
    (`csrc/selective_scan.cu` on a card);
  * `embed.pool`: the mean over each row's real positions;
  * `session.pad`: `pad_test_batch`, the padding and mask of one slice;
  * `step.distance`: the distance stage (the CUDA kernel on a card);
  * `step.rank`: the rank stage, which writes each row's stable order
    and the ranks (`csrc/rank_sort.cu`'s segmented radix sort on a
    card; `torch.sort` and the rank scatter on the CPU);
  * `step.contrib`: the sorted label match and the method's
    contribution u;
  * `step.g`: the interaction methods' superdiagonal g;
  * `step.update`: the method's update of the state (the fill and the
    diagonal; the point methods' values and their sum).

`count(name, value)` adds a device tensor into the accumulator `name`
while the profiler records, with no host sync (and does nothing
otherwise); `counters()` returns every accumulator as Python numbers
(or lists) and clears them. The LM counts:

  * `lm.tokens`: the real positions entering the layers (`Model.embed`
    with lengths);
  * `lm.positions`: the positions the layers computed, padding included;
  * `lm.routed`: the (token, choice) pairs each expert got, (E,),
    summed over the MoE layers (`models.moe.apply_moe_dropless`).
"""

from __future__ import annotations

import contextlib

import torch

SPANS = ("session.update", "embed.forward", "lm.attn", "lm.mamba",
         "lm.scan", "lm.mlp", "lm.moe", "embed.pool", "session.pad",
         "step.distance", "step.rank", "step.contrib", "step.g",
         "step.update")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as a range of the running profiler's
    trace; the shared no-op context while no profiler records."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


_COUNTS: dict = {}


def count(name: str, value) -> None:
    """Add `value` (a tensor or a number) into the accumulator `name`
    while the profiler records; nothing otherwise. The sum stays on
    `value`'s device: nothing waits on the card."""
    if not torch.autograd._profiler_enabled():
        return
    prev = _COUNTS.get(name)
    value = torch.as_tensor(value).detach()
    _COUNTS[name] = value.clone() if prev is None else prev + value


def counters() -> dict:
    """Every accumulator as a number (a list for a vector), then all
    cleared. Reading them waits for the card."""
    out = {k: v.tolist() for k, v in _COUNTS.items()}
    _COUNTS.clear()
    return out
