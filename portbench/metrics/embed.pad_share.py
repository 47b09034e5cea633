"""embed.pad_share: the share of the positions the LM computed that were
padding, 1 - `lm.tokens` / `lm.positions` (the program's counters), in
%; None without them."""


def read(records):
    c = records.get("counters") or {}
    if not c.get("lm.positions") or "lm.tokens" not in c:
        return None
    return 100.0 * (1.0 - c["lm.tokens"] / c["lm.positions"])
