"""embed.ms: device milliseconds a step of the ops launched under the
program's LM spans (`embed.*`: the forward and the pooling; `lm.*`: the
blocks and the scan), from the trace; None where none ran."""

PREFIXES = ("embed.", "lm.")


def read(records):
    spans, steps = records.get("spans") or {}, records.get("steps")
    got = [r["device_s"] for nm, r in spans.items()
           if nm.startswith(PREFIXES)]
    if not got or not steps:
        return None
    return 1e3 * sum(got) / steps
