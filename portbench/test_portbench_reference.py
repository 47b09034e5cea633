"""The plain reference against the definitions, the port's CPU path and
the frozen costs.

  * sti and knn_shapley of `portbench.reference` against the O(2^n)
    definitions at n <= 10 (enumeration written here, in numpy);
  * the reference against `repro_torch`'s CPU path at a tiny size (the
    test only: no run of the benchmark compares with it);
  * the frozen costs against the bounds of the kernel table in PERF.md.
"""

from itertools import combinations
from math import comb, factorial

import numpy as np
import pytest
import torch

from portbench import costs
from portbench.reference import (KnnShapleyReference, StiReference,
                                 _tf32)


def _data(n, t, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = rng.integers(0, 2, size=n)
    xt = rng.normal(size=(t, d))
    yt = rng.integers(0, 2, size=t)
    return x, y, xt, yt


def _utility(order, match, k):
    """v(S) for a subset given as a set of train ids."""
    def v(s):
        near = [j for j in order if j in s][:k]
        return sum(match[j] for j in near) / k
    return v


def _brute(x, y, xt, yt, k):
    """(phi, shapley) of the KNN utility by enumerating every subset."""
    n = len(x)
    phi = np.zeros((n, n))
    shap = np.zeros(n)
    for p in range(len(xt)):
        d2 = ((x - xt[p]) ** 2).sum(1)
        order = list(np.argsort(d2, kind="stable"))
        v = _utility(order, y == yt[p], k)
        for i in range(n):
            phi[i, i] += v({i}) - v(set())
            rest = [b for b in range(n) if b != i]
            for s in range(n):
                w = factorial(s) * factorial(n - s - 1) / factorial(n)
                for sub in combinations(rest, s):
                    shap[i] += w * (v(set(sub) | {i}) - v(set(sub)))
        for i, j in combinations(range(n), 2):
            rest = [b for b in range(n) if b not in (i, j)]
            tot = 0.0
            for s in range(n - 1):
                for sub in combinations(rest, s):
                    S = set(sub)
                    delta = (v(S | {i, j}) - v(S | {i}) - v(S | {j})
                             + v(S))
                    tot += 2.0 / n / comb(n - 1, s) * delta
            phi[i, j] += tot
            phi[j, i] += tot
    return phi / len(xt), shap / len(xt)


def _tensors(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("n,k", [(6, 2), (8, 3), (9, 5)])
def test_reference_matches_the_definitions(n, k):
    x, y, xt, yt = _data(n, 5, 3, seed=n * 10 + k)
    phi, shap = _brute(x, y, xt, yt, k)
    tx, ty, txt, tyt = _tensors(x.astype(np.float32), y.astype(np.int32),
                                xt.astype(np.float32), yt.astype(np.int32))
    vecs = torch.randn((n, 3), generator=torch.Generator().manual_seed(n),
                       dtype=torch.float64)
    sti = StiReference(tx, ty, k, rows=torch.arange(n), vecs=vecs)
    knn = KnnShapleyReference(tx, ty, k)
    for ref in (sti, knn):
        ref.add(txt[:2], tyt[:2])
        ref.add(txt[2:], tyt[2:])
    got = sti.result()
    assert got["t"] == 5
    np.testing.assert_allclose(got["rows"].numpy(), phi, atol=1e-12)
    np.testing.assert_allclose(got["rowsums"].numpy(), phi.sum(1),
                               atol=1e-12)
    off = phi - np.diag(np.diag(phi))
    np.testing.assert_allclose(got["proj"].numpy(), off @ vecs.numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(knn.result()["values"].numpy(), shap,
                               atol=1e-12)


def test_sti_rows_are_a_sample_of_the_whole_matrix():
    x, y, xt, yt = _data(10, 4, 3, seed=5)
    tx, ty, txt, tyt = _tensors(x.astype(np.float32), y.astype(np.int32),
                                xt.astype(np.float32), yt.astype(np.int32))
    vecs = torch.randn((10, 2), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(6))
    full = StiReference(tx, ty, 3, rows=torch.arange(10), vecs=vecs)
    part = StiReference(tx, ty, 3, rows=torch.tensor([1, 4, 9]),
                        vecs=vecs, row_chunk=2)
    for ref in (full, part):
        ref.add(txt, tyt)
    a, b = full.result(), part.result()
    torch.testing.assert_close(b["rows"], a["rows"][[1, 4, 9]])
    torch.testing.assert_close(b["rowsums"], a["rowsums"])
    off = a["rows"] - torch.diag(torch.diagonal(a["rows"]))
    torch.testing.assert_close(a["proj"], off @ vecs)


@pytest.mark.parametrize("method", ["sti", "knn_shapley"])
def test_reference_matches_the_port_on_the_cpu(method):
    from repro_torch import ValuationSession

    gen = torch.Generator().manual_seed(4)
    n, d, k, tb = 96, 8, 5, 16
    x = torch.randn((n, d), generator=gen)
    y = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32)
    sess = ValuationSession(x, y, k=k, mode=method, test_batch=tb,
                            device="cpu")
    if method == "sti":
        ref = StiReference(x, y, k, rows=torch.arange(n),
                           vecs=torch.ones((n, 1), dtype=torch.float64))
    else:
        ref = KnnShapleyReference(x, y, k)
    for _ in range(3):
        xb = torch.randn((tb, d), generator=gen)
        yb = torch.randint(0, 2, (tb,), generator=gen, dtype=torch.int32)
        sess.update(xb, yb)
        ref.add(xb, yb)
    res = sess.finalize()
    if method == "sti":
        got = res.phi.double()
        want = ref.result()["rows"]
    else:
        got = res.point_values.double()
        want = ref.result()["values"]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(10000, generator=torch.Generator().manual_seed(1))
    r = _tf32(x)
    rel = ((r - x).abs() / x.abs()).max()
    assert 0 < float(rel) <= 2.0 ** -11
    assert torch.equal(_tf32(r), r)
    exact = torch.tensor([1.0, -0.5, 3.0, 1024.0])
    assert torch.equal(_tf32(exact), exact)


@pytest.mark.parametrize("cost,bound_ms,by", [
    (costs.fill_cost(256, 65536), 49.36, "operations"),
    (costs.distance_cost(256, 65536, 768, 4), 0.0804, "bytes"),
    (costs.sti_megakernel_cost(256, 65536, 768), 49.36, "operations"),
])
def test_frozen_costs_give_the_kernel_tables_bounds(cost, bound_ms, by):
    assert cost.bound_ms() == pytest.approx(bound_ms, abs=0.005)
    assert cost.bound_by() == by


def test_point_step_cost_at_the_knn_cell():
    c = costs.point_megakernel_cost(256, 2 ** 20, 768)
    # 3 GiB of train features read once: bytes, not the 412 GFLOP, bound it
    assert c.bound_by() == "bytes"
    assert c.bound_ms() == pytest.approx(0.9656, abs=0.001)
