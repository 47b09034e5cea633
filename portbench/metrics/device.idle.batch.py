"""device.idle.batch: the share of the traced window in which no kernel,
copy or set ran on the card, in % (closed-loop cells)."""


def read(records):
    w, busy = records.get("trace_window_s"), records.get("busy_s")
    if not w or not busy:
        return None
    return 100.0 * (1.0 - busy / w)
