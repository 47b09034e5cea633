"""rank.ms: device milliseconds a step of the ops launched under the
program's span `step.rank` (the rank stage: `csrc/rank_sort.cu` on a
card), from the trace; None where no such span ran."""

from portbench.spans import reading


def read(records):
    return reading(records, "rank.ms")
