"""session.blocking_ms: host milliseconds a step of the runtime calls
that wait on the card or the allocator (`spans.BLOCKING`) inside the
program's spans, from the trace."""

from portbench.spans import reading


def read(records):
    return reading(records, "session.blocking_ms")
