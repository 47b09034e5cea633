"""Plain PyTorch reference of the two valuations the benchmark times.

It follows the papers' definitions and shares no code with the program:

  * sti -- the Shapley-Taylor pair interactions of the KNN utility
    (Belaid et al., arXiv:2304.01224, Eqs. 4 and 6-8): per test point,
    u[j] = 1[y(alpha_j) == y_test] / k in distance order, g[n-1] = -2(n-k)
    / (n(n-1)) u[n-1], g[j-1] = g[j] + 1[j > k] 2(j-k) / ((j-1) j) (u[j] -
    u[j-1]) (0-based j >= 2), phi_ab = mean over test points of
    g[max(rank a, rank b)] for a != b, and phi_aa = mean of u at a's rank;
  * knn_shapley -- the exact Shapley values of the KNN utility (Jia et
    al., arXiv:1908.08619, Theorem 1): s[n] = m[n] / n, s[i] = s[i+1] +
    (m[i] - m[i+1]) / k * min(k, i) / i (1-based), m the label match in
    distance order.

Distances are worked out in float64 and rounded once to float32, the
precision the configurations state, then ranked by a stable sort, so
ties fall to the lower index. Every sum is float64. The control
(`precision="tf32"`) is the same reference with the cross term computed
as TensorFloat-32 does it: both operands rounded to 10 mantissa bits,
products exact, sums in float32.

An sti reference keeps, of the (n, n) matrix, a sample of whole rows,
every row's sum and the off-diagonal part times a few seeded vectors
(`StiReference`); a knn_shapley reference keeps the whole (n,) vector
(`KnnShapleyReference`). Both fold test batches one at a time, so they
fit beside nothing else on the card.
"""

from __future__ import annotations

import torch

PRECISIONS = ("f64", "tf32")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 `x` rounded to TensorFloat-32 (10 mantissa bits), to nearest,
    ties to even, as the tensor cores read their operands."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    return ((bits + 0xFFF + keep) & ~0x1FFF).view(torch.float32)


class Distances:
    """Squared L2 distances of test rows to a fixed train set, (t, n) f32.

    "f64": ||a||^2 + ||b||^2 - 2 a.b in float64, clamped at 0, rounded
    once to float32. "tf32": the norms in float32 and the cross term from
    TF32-rounded operands with float32 sums."""

    def __init__(self, x_train: torch.Tensor, precision: str = "f64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.precision = precision
        if precision == "f64":
            self.xt = x_train.to(torch.float64)
            self.norms = (self.xt ** 2).sum(1)
        else:
            x32 = x_train.to(torch.float32)
            self.xt = _tf32(x32)
            self.norms = (x32 ** 2).sum(1)

    def __call__(self, xb: torch.Tensor) -> torch.Tensor:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            if self.precision == "f64":
                a = xb.to(torch.float64)
                b = a
            else:
                a = xb.to(torch.float32)
                b = _tf32(a)
            d2 = torch.addmm(self.norms[None, :], b, self.xt.T, alpha=-2.0)
            d2.add_((a * a).sum(1)[:, None])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return d2.clamp_min_(0.0).to(torch.float32)


def _order(d2: torch.Tensor) -> torch.Tensor:
    """The stable argsort of each row, closest first."""
    return torch.sort(d2, dim=1, stable=True).indices


def _ranks(order: torch.Tensor) -> torch.Tensor:
    """The inverse of each row's order (rank 0 = closest)."""
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(order.shape[1], device=order.device)
                   .expand_as(order))
    return ranks


def sti_g(u: torch.Tensor, k: int) -> torch.Tensor:
    """(b, n) u in distance order -> (b, n) f64 g (g[:, 0] unused, 0)."""
    b, n = u.shape
    u = u.to(torch.float64)
    if n < 2 or n <= k:
        return torch.zeros_like(u)
    j = torch.arange(n, dtype=torch.float64, device=u.device)
    active = (j > k) & (j >= 2)
    step = torch.where(active, 2.0 * (j - k) / torch.where(
        active, (j - 1.0) * j, torch.ones_like(j)), torch.zeros_like(j))
    term = step * (u - torch.roll(u, 1, dims=1))
    term[:, 0] = 0.0
    # g[j-1] = g[n-1] + sum_{m >= j} term[m]
    suffix = torch.flip(torch.cumsum(torch.flip(term, [1]), 1), [1])
    last = -2.0 * (n - k) / (n * (n - 1.0)) * u[:, -1:]
    g = torch.empty_like(u)
    g[:, :-1] = last + suffix[:, 1:]
    g[:, -1:] = last
    g[:, 0] = 0.0
    return g


def knn_shapley_sorted(m: torch.Tensor, k: int) -> torch.Tensor:
    """(b, n) label match in distance order -> (b, n) f64 Shapley values
    in distance order."""
    m = m.to(torch.float64)
    b, n = m.shape
    out = torch.empty_like(m)
    out[:, -1:] = m[:, -1:] * (min(k, n) / (k * n))
    if n > 1:
        i1 = torch.arange(1, n, dtype=torch.float64, device=m.device)
        step = (m[:, :-1] - m[:, 1:]).mul_(torch.clamp_max(i1, float(k))
                                           / (i1 * k))
        # s[i] = s[n-1] + sum_{j >= i} step[j]
        out[:, :-1] = (step.sum(1, keepdim=True) - step.cumsum(1)).add_(
            step).add_(out[:, -1:])
    return out


class StiReference:
    """Folds test batches into the sti result's sampled rows, row sums
    and projections.

    `rows` are the train indices whose whole rows of phi are kept; `vecs`
    (n, m) are the vectors the off-diagonal part of phi is multiplied
    by, so every entry of phi reaches the check. `result()` gives
    {"rows": (len(rows), n) f64 rows of phi, each with its diagonal
    entry, "rowsums": (n,) f64 row sums of phi, "proj": (n, m) f64
    (phi - diag(phi)) @ vecs, "t": test points folded}."""

    def __init__(self, x_train, y_train, k: int, rows: torch.Tensor,
                 vecs: torch.Tensor, precision: str = "f64",
                 row_chunk: int = 4):
        self.dist = Distances(x_train, precision)
        self.y = y_train
        self.k = int(k)
        self.rows = rows.to(x_train.device)
        self.row_chunk = int(row_chunk)
        n = x_train.shape[0]
        dev = x_train.device
        self.vecs = vecs.to(dev, torch.float64)
        self.acc_rows = torch.zeros((len(rows), n), dtype=torch.float64,
                                    device=dev)
        self.off_sums = torch.zeros((n,), dtype=torch.float64, device=dev)
        self.proj = torch.zeros_like(self.vecs)
        self.diag = torch.zeros((n,), dtype=torch.float64, device=dev)
        self.t = 0

    def add(self, xb: torch.Tensor, yb: torch.Tensor) -> None:
        n = self.y.shape[0]
        order = _order(self.dist(xb))
        ranks = _ranks(order)
        match = (self.y[order] == yb[:, None]).to(torch.float64)
        g = sti_g(match / self.k, self.k)                     # (b, n) sorted
        gt = torch.gather(g, 1, ranks)                        # train order
        self.diag += (self.y[None, :] == yb[:, None]).to(
            torch.float64).sum(0) / self.k
        # sum over b != a of g[max(r_a, r_b)]: the r_a points closer than
        # a give g[r_a] each, the farther ones their own g
        after = torch.flip(torch.cumsum(torch.flip(g, [1]), 1), [1])
        after = torch.cat([after[:, 1:], torch.zeros_like(after[:, :1])], 1)
        pos = torch.arange(n, dtype=torch.float64, device=g.device)
        self.off_sums += torch.gather(after + pos * g, 1, ranks).sum(0)
        # the same with b weighted by v[b]: the closer ones give g[r_a]
        # times their v, the farther ones their own g times v
        for j in range(self.vecs.shape[1]):
            w = self.vecs[:, j][order]                        # (b, n) sorted
            gw = g * w
            later = torch.flip(torch.cumsum(torch.flip(gw, [1]), 1), [1])
            val = g * (torch.cumsum(w, 1) - w) + later - gw
            self.proj[:, j].index_add_(0, order.reshape(-1), val.reshape(-1))
        ra, ga = ranks[:, self.rows], gt[:, self.rows]        # (b, R)
        for c0 in range(0, len(self.rows), self.row_chunk):
            sl = slice(c0, c0 + self.row_chunk)
            far = ranks[:, None, :] > ra[:, sl, None]         # (b, c, n)
            self.acc_rows[sl] += torch.where(far, gt[:, None, :],
                                             ga[:, sl, None]).sum(0)
        self.t += int(xb.shape[0])

    def result(self) -> dict:
        t = float(self.t)
        rows = self.acc_rows / t
        idx = torch.arange(len(self.rows), device=rows.device)
        rows[idx, self.rows] = self.diag[self.rows] / t
        return {"rows": rows, "rowsums": (self.off_sums + self.diag) / t,
                "proj": self.proj / t, "t": self.t}


class KnnShapleyReference:
    """Folds test batches into the (n,) knn_shapley values; `result()`
    gives {"values": (n,) f64 mean values, "t": test points folded}."""

    def __init__(self, x_train, y_train, k: int, precision: str = "f64"):
        self.dist = Distances(x_train, precision)
        self.y = y_train
        self.k = int(k)
        self.vec = torch.zeros((x_train.shape[0],), dtype=torch.float64,
                               device=x_train.device)
        self.t = 0

    def add(self, xb: torch.Tensor, yb: torch.Tensor) -> None:
        order = _order(self.dist(xb))
        match = self.y[order] == yb[:, None]
        s = knn_shapley_sorted(match, self.k)
        self.vec.index_add_(0, order.reshape(-1), s.reshape(-1))
        self.t += int(xb.shape[0])

    def result(self) -> dict:
        return {"values": self.vec / float(self.t), "t": self.t}

