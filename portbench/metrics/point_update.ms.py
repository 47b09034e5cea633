"""point_update.ms: device milliseconds a step of the ops launched under
the program's span `step.update` in a point-value cell (the values'
gathers, scan and sum), from the trace."""

from portbench.spans import reading


def read(records):
    return reading(records, "point_update.ms")
