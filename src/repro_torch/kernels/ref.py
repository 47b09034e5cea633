"""Pure-PyTorch oracles for the port's kernels (counterpart of
`repro.kernels.ref`). Each kernel's plain version and tests are held
against these."""

from __future__ import annotations

import math

import torch

__all__ = ["sti_fill_ref", "distance_ref", "flash_attention_ref"]


def sti_fill_ref(g: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Sum over test points p of g[p, max(ranks[p, a], ranks[p, b])].

    Args:
      g: (t, n) f32 super-diagonal tables.
      ranks: (t, n) integer per-test train-point ranks (row-wise
        permutations).

    Returns:
      (n, n) f32. Materializes the (t, n, n) gather.
    """
    t, n = g.shape
    r = ranks.long()
    m = torch.maximum(r[:, :, None], r[:, None, :]).reshape(t, n * n)
    return torch.gather(g, 1, m).reshape(t, n, n).sum(0).to(torch.float32)


def distance_ref(x_test: torch.Tensor, x_train: torch.Tensor) -> torch.Tensor:
    """(t, d), (n, d) -> (t, n) squared L2 distances, f32 accumulation."""
    xt = x_test.to(torch.float32)
    xn = x_train.to(torch.float32)
    d2 = (
        torch.sum(xt * xt, -1, keepdim=True)
        - 2.0 * (xt @ xn.T)
        + torch.sum(xn * xn, -1)[None, :]
    )
    return torch.clamp_min(d2, 0.0)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None
                        ) -> torch.Tensor:
    """(b, h, s, d) attention oracle with optional sliding window: f32
    logits scaled by 1/sqrt(d), key k visible to query q when k <= q
    (causal) and k > q - window (window), masked logits set to -1e30, a
    softmax over keys, the f32 product with v, rounded once to q's type.
    K/V heads are already repeated to match Q's."""
    s, sk = q.shape[-2], k.shape[-2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)
