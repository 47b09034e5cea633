"""scan.roofline: `costs_jamba.scan_cost` (the fused scan's bound at the
window's real tokens, every Mamba layer) over the device time of the ops
launched under the program's span `lm.scan`, in %; None where no such
span ran."""

from portbench.costs_jamba import scan_cost


def read(records):
    r = (records.get("spans") or {}).get("lm.scan")
    tokens = records.get("window_tokens")
    if not r or not r["device_s"] or not tokens:
        return None
    return 100.0 * scan_cost(tokens).bound_ms() / (1e3 * r["device_s"])
