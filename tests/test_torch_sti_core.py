"""`repro_torch.core` against `repro.core` on the CPU.

The same numpy inputs go through the JAX function and its PyTorch
counterpart. Tolerances: recurrence coefficients and ranks bit-equal;
`superdiagonal_g` within 1e-6 relative (XLA and torch take the cumsum in
another order); fills within 1e-6 (the repo's fill tolerance; 1e-5 for
the one-hot matrix-product fill); whole methods within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import sti_baseline as jbase
from repro.core import sti_knn as jsk
from repro_torch.core import sti_baseline as tbase
from repro_torch.core import sti_knn as tsk

NS_KS = [(n, k) for n in (8, 64, 256) for k in (1, 5)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _problem(n, t, d, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-8, 9, (n, d)).astype(np.float32)
        xt = rng.integers(-8, 9, (t, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        xt = rng.normal(size=(t, d)).astype(np.float32)
    return (x, rng.integers(0, 2, n).astype(np.int32), xt,
            rng.integers(0, 2, t).astype(np.int32))


@pytest.mark.parametrize("n,k", NS_KS + [(4, 5), (5, 5)])
@pytest.mark.parametrize("mode", ["sti", "sii"])
def test_recurrence_coeffs_bit_equal(n, k, mode):
    jl, js = jsk._recurrence_coeffs(n, k, mode, jnp.float32)
    tl, ts = tsk._recurrence_coeffs(n, k, mode)
    assert np.asarray(jl).tobytes() == tl.numpy().tobytes()
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("n,k", NS_KS + [(1, 1), (3, 5)])
@pytest.mark.parametrize("mode", ["sti", "sii"])
def test_superdiagonal_g_matches(n, k, mode):
    rng = np.random.default_rng(n * 10 + k)
    u = (rng.integers(0, 2, (6, n)) / k).astype(np.float32)
    want = np.asarray(jsk.superdiagonal_g(jnp.asarray(u), k, mode=mode))
    got = tsk.superdiagonal_g(_t(u), k, mode=mode).numpy()
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    assert np.all(got[:, 0] == 0.0)


@pytest.mark.parametrize("n", [8, 64, 256])
def test_ranks_bit_equal(n):
    rng = np.random.default_rng(n)
    order = np.stack([rng.permutation(n) for _ in range(5)]).astype(np.int32)
    np.testing.assert_array_equal(
        tsk.ranks_from_order(_t(order)).numpy(),
        np.asarray(jsk.ranks_from_order(jnp.asarray(order))))
    # integer features: exact f32 distances with many ties (stable order)
    x, _, xt, _ = _problem(n, 7, 3, n + 1, integer=True)
    d2j = jsk.pairwise_sq_dists(jnp.asarray(xt), jnp.asarray(x))
    d2t = tsk.pairwise_sq_dists(_t(xt), _t(x))
    np.testing.assert_array_equal(d2t.numpy(), np.asarray(d2j))
    np.testing.assert_array_equal(
        tsk.ranks_from_distances(d2t).numpy(),
        np.asarray(jsk.ranks_from_distances(d2j)))


def test_pairwise_sq_dists_matches():
    x, _, xt, _ = _problem(50, 9, 16, 3)
    np.testing.assert_allclose(
        tsk.pairwise_sq_dists(_t(xt), _t(x)).numpy(),
        np.asarray(jsk.pairwise_sq_dists(jnp.asarray(xt), jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def _fill_inputs(t, n, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(t, n)).astype(np.float32)
    ranks = np.stack([rng.permutation(n) for _ in range(t)]).astype(np.int32)
    acc = rng.normal(size=(n, n)).astype(np.float32)
    return g, ranks, acc


@pytest.mark.parametrize("fill,params", [
    ("xla", {}), ("chunked", {"chunk": 1}), ("chunked", {"chunk": 3}),
    ("onehot", {"chunk": 1}), ("onehot", {"chunk": 4}),
])
@pytest.mark.parametrize("t,n", [(5, 8), (9, 33)])
def test_fills_match(fill, params, t, n):
    g, ranks, _ = _fill_inputs(t, n, t + n)
    want = np.asarray(jsk._FILL_FNS[fill](jnp.asarray(g), jnp.asarray(ranks),
                                          **params))
    got = tsk._FILL_FNS[fill](_t(g), _t(ranks).long(), **params).numpy()
    # the one-hot fill sums n telescoped differences in a matrix product,
    # so XLA's and torch's reduction orders differ by more: 1e-5, the
    # tolerance tests/test_sti_pipeline.py holds the fill variants to
    tol = 1e-5 if fill == "onehot" else 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("fill", ["chunked", "onehot", "xla"])
def test_accumulate_fill_in_place_matches(fill):
    """Registered accumulate forms and the `acc.add_` fallback ("xla" has
    no accumulate form) both update the caller's tensor; within 1e-6 of
    the largest value of the JAX result."""
    g, ranks, acc0 = _fill_inputs(7, 20, 11)
    acc = _t(acc0.copy())
    out = tsk.accumulate_fill(acc, _t(g), _t(ranks), fill, (("chunk", 2),)
                              if fill != "xla" else ())
    assert out.data_ptr() == acc.data_ptr()
    want = np.asarray(jsk.accumulate_fill(
        jnp.asarray(acc0), jnp.asarray(g), jnp.asarray(ranks), fill,
        (("chunk", 2),) if fill != "xla" else ()))
    assert np.abs(acc.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_resolve_fill():
    import repro_torch.kernels.ops  # noqa: F401  (registers "cuda")

    assert tsk.resolve_fill("auto", 64, 8, backend="cpu") == (
        "chunked", (("chunk", 1),))
    assert tsk.resolve_fill("auto", 64, 8, backend="cuda") == ("cuda", ())
    # an "auto" hint the winner does not take is dropped, not an error
    assert tsk.resolve_fill("auto", 64, 8, fill_params={"chunk": 4},
                            backend="cuda") == ("cuda", ())
    assert tsk.resolve_fill("onehot", 64, 8, fill_params={"chunk": 2}) == (
        "onehot", (("chunk", 2),))
    with pytest.raises(ValueError, match="unknown fill"):
        tsk.resolve_fill("pallas", 64, 8)
    with pytest.raises(ValueError, match="does not accept"):
        tsk.resolve_fill("xla", 64, 8, fill_params={"chunk": 2})


def test_register_fill_fn_roundtrip():
    calls = []

    def fill(g, ranks):
        calls.append("fill")
        return tsk._fill_xla(g, ranks)

    def acc_fill(acc, g, ranks):
        calls.append("acc")
        return acc.add_(tsk._fill_xla(g, ranks))

    tsk.register_fill_fn("test_double", fill)
    tsk.register_acc_fill_fn("test_double", acc_fill)
    try:
        g, ranks, _ = _fill_inputs(3, 6, 2)
        acc = torch.zeros(6, 6)
        tsk.accumulate_fill(acc, _t(g), _t(ranks), "test_double")
        assert calls == ["acc"]
        torch.testing.assert_close(acc, tsk._fill_xla(_t(g), _t(ranks)))
    finally:
        tsk._FILL_FNS.pop("test_double")
        tsk._ACC_FILL_FNS.pop("test_double")


@pytest.mark.parametrize("mode", ["sti", "sii"])
@pytest.mark.parametrize("fill", ["chunked", "onehot", "xla"])
def test_scan_engine_matches_with_partial_batch(mode, fill):
    """t = 13 in batches of 5: two full batches and a trailing partial
    batch of 3, within 1e-5."""
    x, y, xt, yt = _problem(40, 13, 3, 21)
    want = np.asarray(jsk.sti_knn_interactions(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt), jnp.asarray(yt), 3,
        mode=mode, test_batch=5, fill=fill))
    got = tsk.sti_knn_interactions(x, y, xt, yt, 3, mode=mode, test_batch=5,
                                   fill=fill, device="cpu")
    assert got.shape == (40, 40) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["sti", "sii"])
def test_one_test_matrix_matches(mode):
    u = (np.random.default_rng(4).integers(0, 2, 17) / 5).astype(np.float32)
    want = np.asarray(jsk.sti_knn_matrix_one_test(jnp.asarray(u), 5,
                                                  mode=mode))
    got = tsk.sti_knn_matrix_one_test(_t(u), 5, mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_oracle_copy_matches_original():
    x, y, xt, yt = _problem(9, 3, 2, 8)
    np.testing.assert_array_equal(tbase.sorted_orders(x, xt),
                                  jbase.sorted_orders(x, xt))
    for name in ("brute_force_sti", "brute_force_sii", "brute_force_shapley"):
        np.testing.assert_array_equal(
            getattr(tbase, name)(x, y, xt, yt, 3),
            getattr(jbase, name)(x, y, xt, yt, 3))
    np.testing.assert_array_equal(
        tbase.brute_force_wknn_shapley(x, y, xt, yt, 3, weights="inverse"),
        jbase.brute_force_wknn_shapley(x, y, xt, yt, 3, weights="inverse"))


@pytest.mark.parametrize("mode", ["sti", "sii"])
def test_scan_engine_matches_oracle(mode):
    """The O(2^n) definition at n = 10 (integer features, so distance ties
    break identically in numpy and torch), within 1e-5."""
    x, y, xt, yt = _problem(10, 4, 2, 31, integer=True)
    oracle = tbase.brute_force_sti if mode == "sti" else tbase.brute_force_sii
    got = tsk.sti_knn_interactions(x, y, xt, yt, 3, mode=mode, test_batch=3,
                                   device="cpu").numpy()
    np.testing.assert_allclose(got, oracle(x, y, xt, yt, 3), atol=1e-5)
