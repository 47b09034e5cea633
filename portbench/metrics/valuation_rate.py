"""valuation_rate: test points folded in the window over the window's
seconds; the window ends on a card sync, so every step it counts has
finished inside it."""


def read(records):
    if "steps" not in records or records["window_s"] <= 0:
        return None
    return records["points"] / records["window_s"]
