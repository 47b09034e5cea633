"""device.idle.program: the share of the traced window in which the card
was idle while a program span was the innermost open, in %."""

from portbench.spans import reading


def read(records):
    return reading(records, "device.idle.program")
