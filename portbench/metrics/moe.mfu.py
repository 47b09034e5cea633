"""moe.mfu: the experts' operations at the window's real tokens, each
routed to top_k experts in every MoE layer of the period
(`costs_jamba.routed_pairs`, 2 x 3 x d x f a pair), over the device time
of the ops launched under the program's span `lm.moe`, as a share of the
card's bf16 peak, in %; None without the tokens or the span."""

from portbench.costs import BF16_FLOP_PER_S
from portbench.costs_jamba import expert_flops_per_pair, routed_pairs


def read(records):
    tokens = records.get("window_tokens")
    r = (records.get("spans") or {}).get("lm.moe")
    if not tokens or not r or not r["device_s"]:
        return None
    flops = expert_flops_per_pair() * routed_pairs(tokens)
    return 100.0 * flops / r["device_s"] / BF16_FLOP_PER_S
