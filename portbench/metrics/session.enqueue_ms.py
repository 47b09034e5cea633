"""session.enqueue_ms: host milliseconds a step inside the program's span
`session.update` (`ValuationSession.update` enqueueing its steps), from
the trace."""

from portbench.spans import reading


def read(records):
    return reading(records, "session.enqueue_ms")
