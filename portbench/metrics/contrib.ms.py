"""contrib.ms: device milliseconds a step of the ops launched under the
program's spans `step.contrib` and `step.g` (the sorted label match, the
contributions and the interaction methods' g), from the trace."""

from portbench.spans import reading


def read(records):
    return reading(records, "contrib.ms")
