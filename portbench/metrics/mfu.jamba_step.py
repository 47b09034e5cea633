"""mfu.jamba_step: the period's operations at the window's real tokens
(`costs_jamba.period_bound_ms`: every matrix product of the 8 layers at
the card's bf16 peak) over the window's seconds, in %: the whole step's
share of the peak (host clock)."""

from portbench.costs_jamba import period_bound_ms


def read(records):
    tokens = records.get("window_tokens")
    if not tokens or not records.get("window_s"):
        return None
    bound = period_bound_ms(tokens, records.get("window_pairs", 0.0))
    return 100.0 * bound / (1e3 * records["window_s"])
