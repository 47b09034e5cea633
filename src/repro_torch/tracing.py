"""Named spans at the layer boundaries of the streaming step.

    from repro_torch.tracing import span
    with span("step.rank"):
        order = torch.sort(d2, dim=-1, stable=True).indices

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
  * `session.pad`: `pad_test_batch`, the padding and mask of one slice;
  * `step.distance`: the distance stage (the CUDA kernel on a card);
  * `step.rank`: the stable sort and the rank scatter;
  * `step.contrib`: the sorted label match and the method's
    contribution u;
  * `step.g`: the interaction methods' superdiagonal g;
  * `step.update`: the method's update of the state (the fill and the
    diagonal; the point methods' values and their sum).
"""

from __future__ import annotations

import contextlib

import torch

SPANS = ("session.update", "session.pad", "step.distance", "step.rank",
         "step.contrib", "step.g", "step.update")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as a range of the running profiler's
    trace; the shared no-op context while no profiler records."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
