"""Pure-PyTorch oracles for the port's kernels (counterpart of
`repro.kernels.ref`). Each kernel's plain version and tests are held
against these."""

from __future__ import annotations

import torch

__all__ = ["sti_fill_ref", "distance_ref"]


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
