"""The frozen yardstick of the Jamba2-Mini cell: operations and bytes of
one 8-layer period at its published widths, counted at **real** tokens,
so that a change that stops computing padding (packing, varlen) reads as
time saved and not as work removed. The peaks are `costs`'s.

Per real token (`PERIOD`, the cell's period: Mamba at 7 layers,
attention at 1, a dense SwiGLU at 4 and 16 experts top-2 at 4), matrix
products at 2 operations a multiply-add:

  * attention: q, k, v and o projections, 2 d (hq + 2 hkv) + 2 hq d; and
    per review of L tokens the causal scores and the weighted sum,
    2 hq L (L + 1) (`period_flops`' second argument is the sum of
    L (L + 1) over the reviews);
  * Mamba: in_proj 2 d (2 di), x_proj 2 di (dt_rank + 2 ds), dt_proj
    2 dt_rank di, out_proj 2 di d;
  * dense SwiGLU: 3 x 2 d f; the experts: top_k x 3 x 2 d f, and the
    router 2 d E.

The selective scan is not a matrix product and is left out of the
period's operations; `scan_cost` is its own bound. Reading a weight is
not counted: the cell's bound is the products' operations.
"""

from __future__ import annotations

from portbench.costs import (
    BF16_FLOP_PER_S, SIMPLE_OPS_PER_S, KernelCost)

PERIOD = {"d": 4096, "heads": 32, "kv_heads": 8, "head_dim": 128,
          "f": 14336, "experts": 16, "top_k": 2, "di": 8192, "ds": 16,
          "dt_rank": 256, "attn_layers": 1, "mamba_layers": 7,
          "mlp_layers": 4, "moe_layers": 4}
SCAN_OPS = 6  # per channel-state and token: one exp and ~5 operations


def expert_flops_per_pair(p: dict = PERIOD) -> float:
    """One (token, choice) pair through one expert's SwiGLU."""
    return 3 * 2.0 * p["d"] * p["f"]


def routed_pairs(tokens: float, p: dict = PERIOD) -> float:
    """The (token, choice) pairs of `tokens` real tokens over the period's
    MoE layers: dropless routing sends each to top_k experts."""
    return float(tokens) * p["top_k"] * p["moe_layers"]


def flops_per_token(p: dict = PERIOD) -> float:
    """The period's matrix-product operations for one real token, less
    attention's quadratic part."""
    d, di = p["d"], p["di"]
    hq, hkv = p["heads"] * p["head_dim"], p["kv_heads"] * p["head_dim"]
    attn = 2.0 * d * (hq + 2 * hkv) + 2.0 * hq * d
    mamba = (2.0 * d * 2 * di + 2.0 * di * (p["dt_rank"] + 2 * p["ds"])
             + 2.0 * p["dt_rank"] * di + 2.0 * di * d)
    mlp = 3 * 2.0 * d * p["f"]
    moe = p["top_k"] * expert_flops_per_pair(p) + 2.0 * d * p["experts"]
    return (p["attn_layers"] * attn + p["mamba_layers"] * mamba
            + p["mlp_layers"] * mlp + p["moe_layers"] * moe)


def period_flops(tokens: float, pairs_sum: float = 0.0,
                 p: dict = PERIOD) -> float:
    """The period's operations for `tokens` real tokens whose reviews'
    L (L + 1) sum to `pairs_sum`."""
    hq = p["heads"] * p["head_dim"]
    return (tokens * flops_per_token(p)
            + p["attn_layers"] * 2.0 * hq * pairs_sum)


def period_bound_ms(tokens: float, pairs_sum: float = 0.0,
                    p: dict = PERIOD) -> float:
    """The least time the card could take the period's products, ms."""
    return 1e3 * period_flops(tokens, pairs_sum, p) / BF16_FLOP_PER_S


def scan_cost(tokens: float, p: dict = PERIOD) -> KernelCost:
    """The fused scan over `tokens` real tokens in every Mamba layer: x,
    z and dt read in bf16 and B and C in f32, y written in bf16, per
    token and layer (8 di + 8 ds bytes); `SCAN_OPS` operations per
    channel-state, at the CUDA cores' instruction rate."""
    layers = p["mamba_layers"]
    ops = float(SCAN_OPS) * tokens * p["di"] * p["ds"] * layers
    nbytes = float(tokens) * (3 * 2 * p["di"] + 2 * 4 * p["ds"]
                              + 2 * p["di"]) * layers
    return KernelCost(ops, nbytes, ops / SIMPLE_OPS_PER_S)
