"""The port's approximate top-m engine (`engine="approx"`) against the JAX
package (CPU), and its own contracts.

The same numpy inputs go through `repro` and `repro_torch`. The LSH planes
are the one input the packages cannot share by seed (JAX draws them with
`jax.random`), so the parity cases pass planes explicitly:

  * integer features and planes on the 1/16 grid in [-4, 4] make every
    product and sum exact in f32, so codes, tables, candidate pools,
    candidate ids and COO coordinates are held BIT-equal;
  * with JAX's own normal planes, codes are held equal wherever the margin
    |proj . x| exceeds 1e-4 |proj| |x|;
  * float results (probe recall, moments, recurrences, values) within
    1e-6 (1e-5 of max |ref| for wknn's analytic bandwidth, as
    tests/test_approx_engine.py has it), the float64 error bounds
    bit-equal.

Every contract of tests/test_approx_engine.py is repeated on the port:
options refused off the engine, top_m < k+1 refused, top_m = n
bit-identical to the exact engine, the certified bound, a symmetric phi
with the exact diagonal, the recall target, two runs bit-identical, a
checkpoint/restore bit-identical, and a cross-package approx restore
refused both ways. The `cuda` cases run the same on a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_approx.py -q
"""

import types

import numpy as np
import pytest
import torch

from repro_torch import ApproxValuationSession, ENGINES, get_method
from repro_torch.core import approx as tapprox
from repro_torch.core.results import ValuationResult
from repro_torch.core.sti_knn import superdiagonal_g_topm
from repro_torch.data import make_moons
from repro_torch.kernels import ann as tann
from repro_torch.kernels.distance import candidate_sq_dists, distance_cuda
from repro_torch.kernels.stream_kernels import (
    make_approx_values, scatter_point_update)
from repro_torch.kernels.sti_pipeline import (
    ApproxPairAccumulator, make_approx_interaction_step,
    make_approx_point_step)

# the geometry of tests/test_approx_engine.py
N, D, T, K, M = 192, 6, 48, 5, 96
APPROX_PARAMS = dict(window=96, n_tables=8, recall_sample=T, recall_k=64)
POINT_METHODS = ("knn_shapley", "wknn", "loo")
INTERACTION_METHODS = ("sti", "sii")
EXACT_ENGINE = {**{m: "fused" for m in INTERACTION_METHODS},
                **{m: "streamed" for m in POINT_METHODS}}
SLACK = {"wknn": 1e-5}
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's approx engine (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import repro  # noqa: F401
    from repro.core import approx as japprox
    from repro.core import get_method as jget
    from repro.core.results import ValuationResult as JResult
    from repro.core.session import ApproxValuationSession as JSession
    from repro.core.sti_knn import superdiagonal_g_topm as jg_topm
    from repro.data.synthetic import make_moons as jmoons
    from repro.kernels import ann as jann
    from repro.kernels import sti_pipeline as jpipe
    from repro.kernels.distance import candidate_sq_dists as jcand
    from repro.kernels.stream_kernels import (
        make_approx_values as jvalues, scatter_point_update as jscatter)

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, approx=japprox, get=jget, Result=JResult,
        Session=JSession, g_topm=jg_topm, moons=jmoons, ann=jann, pipe=jpipe,
        cand=jcand, values=jvalues, scatter=jscatter)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


def _data(seed=0, n=N, t=T, d=D, classes=3, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-8, 9, (n, d)).astype(np.float32)
        xt = rng.integers(-8, 9, (t, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        xt = rng.normal(size=(t, d)).astype(np.float32)
    return (x, rng.integers(0, classes, size=n).astype(np.int32), xt,
            rng.integers(0, classes, size=t).astype(np.int32))


def _grid_planes(n_tables, n_bits, d, seed=3):
    """Planes on the 1/16 grid in [-4, 4]: with integer features every
    product and partial sum of proj . x is exact in f32."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-64, 65, (n_tables, n_bits, d)) / 16.0).astype(
        np.float32)


def _jax_tables(jx, x, proj):
    """A JAX `LSHTables` under explicit planes, built as
    `repro.kernels.ann.build_tables` builds it from its drawn ones."""
    jnp = jx.jnp
    xj = jnp.asarray(x)
    codes = jx.ann.lsh_codes(jnp.asarray(proj), xj)
    sort_idx = jnp.argsort(codes, axis=-1, stable=True).astype(jnp.int32)
    norms = jnp.sum(xj * xj, axis=-1)
    return jx.ann.LSHTables(
        proj=jnp.asarray(proj),
        sorted_codes=jnp.take_along_axis(codes, sort_idx, axis=-1),
        sort_idx=sort_idx, train_norms=norms, train_mean=jnp.mean(xj, 0),
        mean_sq_norm=jnp.mean(norms))


def _t(a):
    return torch.from_numpy(np.array(a))


def _arr(res):
    a = res.phi if res.phi is not None else res.point_values
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _run(method, engine, data, **opts):
    xtr, ytr, xte, yte = data
    return get_method(method)(xtr, ytr, xte, yte, k=K, engine=engine,
                              test_batch=T, device="cpu", **opts)


@pytest.fixture(scope="module")
def data():
    return _data()


# ------------------------------------------------ candidate stage, bitwise
def test_candidate_sq_dists_bit_equal_on_integer_features(jx):
    x, _, xt, _ = _data(integer=True)
    rng = np.random.default_rng(1)
    cand = rng.integers(0, N, (T, 40))
    norms = (x * x).sum(-1)
    want = np.asarray(jx.cand(jx.jnp.asarray(xt), jx.jnp.asarray(x),
                              jx.jnp.asarray(cand.astype(np.int32))))
    for tn in (None, _t(norms)):
        got = candidate_sq_dists(_t(xt), _t(x), _t(cand), train_norms=tn)
        np.testing.assert_array_equal(got.numpy(), want)


def test_lsh_codes_and_tables_bit_equal_on_the_grid(jx):
    x, _, xt, _ = _data(integer=True)
    proj = _grid_planes(8, 16, D)
    want = _jax_tables(jx, x, proj)
    got = tann.build_tables(_t(x), _t(proj))
    np.testing.assert_array_equal(
        tann.lsh_codes(_t(proj), _t(xt)).numpy(),
        np.asarray(jx.ann.lsh_codes(jx.jnp.asarray(proj),
                                    jx.jnp.asarray(xt))))
    for field in ("proj", "sorted_codes", "sort_idx", "train_norms"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    # the moments divide by n, which the two packages round apart
    for field in ("train_mean", "mean_sq_norm"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-6, err_msg=field)
    assert got.sorted_codes.dtype == torch.int32
    # tables carried from JAX are JAX's tables, bit for bit
    carried = tann.tables_from_jax(want, device="cpu")
    for field in want._fields:
        np.testing.assert_array_equal(getattr(carried, field).numpy(),
                                      np.asarray(getattr(want, field)))


def test_lsh_codes_match_jax_normal_planes_off_the_sign_boundary(jx):
    """With JAX's own N(0, 1) planes the sign of proj . x near zero hangs
    on the summation order; every bit whose margin exceeds 1e-4 |proj| |x|
    agrees."""
    x, *_ = _data(n=400, d=16)
    jtab = jx.ann.build_tables(jx.jnp.asarray(x), key=jx.jax.random.key(5),
                               n_tables=6, n_bits=20)
    proj = np.asarray(jtab.proj)
    got = tann.lsh_codes(_t(proj), _t(x)).numpy()
    want = np.asarray(jx.ann.lsh_codes(jtab.proj, jx.jnp.asarray(x)))
    dots = np.einsum("lbd,pd->lpb", proj.astype(np.float64),
                     x.astype(np.float64))
    scale = (np.linalg.norm(proj, axis=-1)[:, None, :]
             * np.linalg.norm(x, axis=-1)[None, :, None])
    clear = np.abs(dots) > 1e-4 * scale
    bits = 1 << np.arange(20)
    same = ((got[..., None] & bits) != 0) == ((want[..., None] & bits) != 0)
    assert clear.mean() > 0.99
    assert same[clear].all()


@pytest.mark.parametrize("window", [5, 24, 96, 500])
def test_candidate_pool_dedup_and_topm_bit_equal(jx, window):
    x, _, xt, _ = _data(integer=True)
    proj = _grid_planes(4, 12, D)
    jt = _jax_tables(jx, x, proj)
    tt = tann.build_tables(_t(x), _t(proj))
    jxt = jx.jnp.asarray(xt)
    pool = tann.candidate_pool(tt, _t(xt), window)
    jpool = np.asarray(jx.ann.candidate_pool(jt, jxt, window))
    np.testing.assert_array_equal(pool.numpy(), jpool)
    np.testing.assert_array_equal(
        tann._dedup_mask(pool).numpy(),
        np.asarray(jx.ann._dedup_mask(jx.jnp.asarray(jpool))))
    m = min(M, pool.shape[1])
    got = tann.topm_candidates(_t(xt), _t(x), tt, m, window)
    want = jx.ann.topm_candidates(jxt, jx.jnp.asarray(x), jt, m, window)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="smaller than top_m"):
        tann.topm_candidates(_t(xt), _t(x), tt, pool.shape[1] + 1, window)


def test_probe_and_moments_match_jax(jx):
    x, _, xt, _ = _data()
    proj = _grid_planes(8, 16, D)
    tt = tann.build_tables(_t(x), _t(proj))
    jt = _jax_tables(jx, x, proj)
    cand, _, _ = tann.topm_candidates(_t(xt), _t(x), tt, M, 96)
    for kk in (1, 16, 64):
        p, r = tann.matched_prefix_and_recall(cand, _t(xt), _t(x), kk)
        jp, jr = jx.ann.matched_prefix_and_recall(
            jx.jnp.asarray(cand.numpy().astype(np.int32)), jx.jnp.asarray(xt),
            jx.jnp.asarray(x), kk)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6)
    np.testing.assert_allclose(
        tann.full_mean_sq_dist(_t(xt), tt).numpy(),
        np.asarray(jx.ann.full_mean_sq_dist(jx.jnp.asarray(xt), jt)),
        rtol=1e-6)
    # the analytic bandwidth is the dense row mean of d2
    np.testing.assert_allclose(
        tann.full_mean_sq_dist(_t(xt), tt).numpy()[:, 0],
        distance_cuda(_t(xt), _t(x)).numpy().mean(-1), rtol=1e-5)


def test_draw_planes_is_one_index_per_seed():
    a = tann.draw_planes(7, 4, 16, 32)
    assert a.shape == (4, 16, 32) and a.dtype == torch.float32
    assert torch.equal(a, tann.draw_planes(7, 4, 16, 32))
    assert not torch.equal(a, tann.draw_planes(8, 4, 16, 32))
    with pytest.raises(ValueError, match="n_bits"):
        tann.draw_planes(0, 4, 31, 8)
    with pytest.raises(ValueError, match="planes"):
        tann.build_tables(torch.zeros((10, 8)), torch.zeros((2, 4, 9)))


# --------------------------------------------------------- recurrences
@pytest.mark.parametrize("mode", INTERACTION_METHODS)
@pytest.mark.parametrize("m,n_total,k", [(12, 12, 3), (16, 200, 5),
                                         (7, 9, 5), (1, 50, 3), (40, 4, 5)])
def test_superdiagonal_g_topm_matches_jax(jx, mode, m, n_total, k):
    rng = np.random.default_rng(m * n_total + k)
    u = (rng.integers(0, 2, (3, m)) / k).astype(np.float32)
    got = superdiagonal_g_topm(_t(u), k, n_total, mode=mode).numpy()
    want = np.asarray(jx.g_topm(jx.jnp.asarray(u), k, n_total, mode=mode))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("method,opts", [
    ("knn_shapley", {}), ("wknn", {"weights": "rbf"}),
    ("wknn", {"weights": "inverse"}), ("loo", {})])
def test_approx_values_match_jax(jx, method, opts):
    rng = np.random.default_rng(4)
    d2m = np.sort(rng.random((6, 20)).astype(np.float32) * 9, -1)
    d2m[1, 15:] = tann.INVALID_D2
    valid = (d2m < 1e29).astype(np.float32)
    match = rng.integers(0, 2, (6, 20)).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    sigma2 = rng.random((6, 1)).astype(np.float32) + 1.0
    got = make_approx_values(method, K, opts=opts)(
        *map(_t, (d2m, match, valid, mask, sigma2))).numpy()
    want = np.asarray(jx.values(method, K, opts=opts)(
        *map(jx.jnp.asarray, (d2m, match, valid, mask, sigma2))))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="no approx"):
        make_approx_values("sti", K)


def test_scatter_point_update_matches_jax_and_is_deterministic(jx):
    rng = np.random.default_rng(5)
    n, tb, m = 50, 9, 12
    cand = np.stack([rng.permutation(n)[:m] for _ in range(tb)])
    vals = rng.normal(size=(tb, m)).astype(np.float32)
    valid = (rng.random((tb, m)) > 0.2).astype(np.float32)
    vec0 = rng.normal(size=(n,)).astype(np.float32)
    want = np.asarray(jx.scatter(jx.jnp.asarray(vec0),
                                 jx.jnp.asarray(cand.astype(np.int32)),
                                 jx.jnp.asarray(vals), jx.jnp.asarray(valid)))
    outs = []
    for _ in range(2):
        vec = _t(vec0.copy())
        ret = scatter_point_update(vec, _t(cand), _t(vals), _t(valid))
        assert ret is vec
        outs.append(vec.numpy())
    np.testing.assert_allclose(outs[0], want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_pair_accumulator_matches_jax(jx):
    rng = np.random.default_rng(6)
    n = 30
    acc, jacc = ApproxPairAccumulator(n), jx.pipe.ApproxPairAccumulator(n)
    for _ in range(3):
        rows = rng.integers(0, n + 1, 200)
        cols = rng.integers(0, n, 200)
        vals = rng.normal(size=200).astype(np.float32)
        acc.add(_t(rows), _t(cols), _t(vals))
        jacc.add(rows.astype(np.int32), cols.astype(np.int32), vals)
    for g, w in zip(acc.state(), jacc.state()):
        np.testing.assert_array_equal(g, w)
    assert acc.nnz == jacc.nnz
    diag = rng.normal(size=n).astype(np.float32)
    np.testing.assert_array_equal(acc.to_dense(_t(diag), 7).numpy(),
                                  np.asarray(jacc.to_dense(diag, 7)))


# ------------------------------------------------------- steps vs JAX
def _step_inputs(jx, proj_tables=8, integer=True):
    x, y, xt, yt = _data(integer=integer)
    proj = _grid_planes(proj_tables, 16, D)
    mask = np.ones(T, np.float32)
    mask[-5:] = 0.0                     # a ragged batch: padded rows last
    return (x, y, xt, yt, mask, tann.build_tables(_t(x), _t(proj)),
            _jax_tables(jx, x, proj))


@pytest.mark.parametrize("method,opts", [
    ("knn_shapley", ()), ("wknn", (("weights", "rbf"),)),
    ("wknn", (("weights", "inverse"),)), ("loo", ())])
def test_approx_point_step_matches_jax(jx, method, opts):
    x, y, xt, yt, mask, tt, jt = _step_inputs(jx)
    vec0 = np.zeros(N, np.float32)
    step = make_approx_point_step(method, K, N, M, 96, T, 64, opts)
    jstep = jx.pipe.make_approx_point_step(method, K, N, M, 96, T, 64, opts,
                                           donate=False)
    vec, prefix, recall = step(_t(vec0.copy()), _t(xt), _t(yt), _t(mask),
                               _t(x), _t(y), tt)
    jvec, jprefix, jrecall = jstep(*map(jx.jnp.asarray, (
        vec0, xt, yt, mask, x, y)), jt)
    want = np.asarray(jvec)
    np.testing.assert_allclose(vec.numpy(), want, rtol=0,
                               atol=SLACK.get(method, 1e-6)
                               * np.abs(want).max())
    np.testing.assert_array_equal(prefix.numpy(), np.asarray(jprefix))
    np.testing.assert_allclose(recall.numpy(), np.asarray(jrecall),
                               rtol=1e-6)
    p = int(prefix.numpy()[:T - 5].min())
    assert tapprox.error_bound(method, n=N, k=K, m=M, prefix=p) == \
        jx.approx.error_bound(method, n=N, k=K, m=M, prefix=p)


@pytest.mark.parametrize("mode", INTERACTION_METHODS)
def test_approx_interaction_step_matches_jax(jx, mode):
    x, y, xt, yt, mask, tt, jt = _step_inputs(jx)
    diag0 = np.zeros(N, np.float32)
    step = make_approx_interaction_step(mode, K, N, M, 96, T, 64)
    jstep = jx.pipe.make_approx_interaction_step(mode, K, N, M, 96, T, 64,
                                                 donate=False)
    got = step(_t(diag0.copy()), _t(xt), _t(yt), _t(mask), _t(x), _t(y), tt)
    want = jstep(*map(jx.jnp.asarray, (diag0, xt, yt, mask, x, y)), jt)
    diag, rows, cols, vals, prefix, _ = got
    jdiag, jrows, jcols, jvals, jprefix, _ = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(rows.numpy(), jrows)
    np.testing.assert_array_equal(cols.numpy(), jcols)
    np.testing.assert_allclose(vals.numpy(), jvals, rtol=0,
                               atol=1e-6 * np.abs(jvals).max())
    # the diagonal sums the batch in torch's order (bit-equal to the
    # port's exact engine, test_interaction_matrix_symmetric_and_diag_exact)
    np.testing.assert_allclose(diag.numpy(), jdiag, rtol=0,
                               atol=1e-6 * np.abs(jdiag).max())
    np.testing.assert_array_equal(prefix.numpy(), jprefix)
    p = int(prefix.numpy()[:T - 5].min())
    assert tapprox.error_bound(mode, n=N, k=K, m=M, prefix=p) == \
        jx.approx.error_bound(mode, n=N, k=K, m=M, prefix=p)


# --------------------------------------------- the copy of core/approx.py
def test_approx_bounds_copy_matches_the_original(jx):
    ja = jx.approx
    for x in (0, 1, 2, 7, 100, 4096, (1 << 22) + 3):
        assert tapprox.harmonic_number(x) == ja.harmonic_number(x)
    for method in (*POINT_METHODS, *INTERACTION_METHODS):
        for n, k, m in ((160, 2, 64), (192, 5, 96), (1024, 5, 256),
                        (65536, 5, 64), (1 << 20, 5, 256), (50, 6, 50)):
            for p in sorted({0, 1, k, k + 1, m // 2, m - 1, m, m + 3}):
                assert tapprox.error_bound(
                    method, n=n, k=k, m=m, prefix=p) == ja.error_bound(
                    method, n=n, k=k, m=m, prefix=p), (method, n, k, m, p)
    for a, n, k in ((1, 200, 5), (6, 200, 5), (300, 200, 5)):
        assert tapprox.shapley_tail(a, n, k) == ja.shapley_tail(a, n, k)
    for mode in INTERACTION_METHODS:
        assert tapprox.step_coef_sum(3, 100, 5, mode) == \
            ja.step_coef_sum(3, 100, 5, mode)
    assert tapprox.point_coef(3, 5) == ja.point_coef(3, 5)
    with pytest.raises(ValueError):
        tapprox.error_bound("nope", n=10, k=2, m=5, prefix=1)


# ----------------------------------- the contracts of test_approx_engine
def test_engines_table_has_approx_everywhere():
    for method in (*INTERACTION_METHODS, *POINT_METHODS):
        assert "approx" in ENGINES[method]


@pytest.mark.parametrize("method,engine,opt", [
    ("sti", "fused", {"top_m": M}), ("knn_shapley", "streamed",
                                     {"top_m": M}),
    ("sii", "scan", {"recall_target": 0.5}),
    ("loo", "eager", {"approx_params": {"window": 8}})])
def test_approx_options_rejected_off_engine(method, engine, opt, data):
    with pytest.raises(ValueError, match="approx"):
        _run(method, engine, data, **opt)


def test_top_m_below_k_plus_one_rejected(data):
    with pytest.raises(ValueError, match="top_m"):
        ApproxValuationSession(data[0], data[1], k=K, mode="knn_shapley",
                               top_m=K, test_batch=T, **CPU)


@pytest.mark.parametrize("method", (*INTERACTION_METHODS, *POINT_METHODS))
def test_full_m_is_bit_identical_to_exact(method, data):
    r_exact = _run(method, EXACT_ENGINE[method], data)
    r_full = _run(method, "approx", data, top_m=N)
    assert r_full.meta["approx_exact"] is True
    assert r_full.meta["error_bound"] == 0.0
    assert np.array_equal(_arr(r_exact), _arr(r_full))


@pytest.mark.parametrize("method", (*INTERACTION_METHODS, *POINT_METHODS))
def test_truncated_m_error_within_certified_bound(method, data):
    r_exact = _run(method, EXACT_ENGINE[method], data)
    r_ap = _run(method, "approx", data, top_m=M,
                approx_params=APPROX_PARAMS)
    meta = r_ap.meta
    assert meta["approx_exact"] is False and meta["top_m"] == M
    assert 0.0 <= meta["recall_estimate"] <= 1.0
    assert meta["probed_rows"] == T
    err = float(np.max(np.abs(_arr(r_exact) - _arr(r_ap))))
    assert err <= meta["error_bound"] + SLACK.get(method, 1e-6)


def test_interaction_matrix_symmetric_and_diag_exact(data):
    r_exact = _run("sti", "fused", data)
    r_ap = _run("sti", "approx", data, top_m=M, approx_params=APPROX_PARAMS)
    phi = _arr(r_ap)
    assert np.array_equal(phi, phi.T)
    np.testing.assert_array_equal(np.diag(phi), np.diag(_arr(r_exact)))
    # every nonzero off-diagonal entry is a stored pair, stored both ways
    off = phi[~np.eye(N, dtype=bool)]
    stored = r_ap.meta["pairs_stored"]
    assert 0 < int((off != 0).sum()) <= stored and stored % 2 == 0


def test_recall_target_reported(data):
    r = _run("knn_shapley", "approx", data, top_m=M, recall_target=0.5,
             approx_params=APPROX_PARAMS)
    assert r.meta["recall_target"] == 0.5
    assert r.meta["recall_target_met"] == (r.meta["recall_estimate"] >= 0.5)


@pytest.mark.parametrize("method", ("sti", "knn_shapley"))
def test_two_runs_bit_identical(method, data):
    runs = [_run(method, "approx", data, top_m=M, seed=7,
                 approx_params=APPROX_PARAMS) for _ in range(2)]
    assert np.array_equal(_arr(runs[0]), _arr(runs[1]))
    for key in ("recall_estimate", "matched_prefix", "error_bound"):
        assert runs[0].meta[key] == runs[1].meta[key]


@pytest.mark.parametrize("mode", ("sti", "knn_shapley"))
def test_checkpoint_restore_bit_identical(mode, data, tmp_path):
    xtr, ytr, xte, yte = data
    kw = dict(k=K, mode=mode, test_batch=16, top_m=64, seed=7, window=64,
              n_tables=4, recall_sample=16, **CPU)
    straight = ApproxValuationSession(xtr, ytr, **kw)
    r_straight = straight.update(xte, yte).finalize()
    first = ApproxValuationSession(xtr, ytr, **kw)
    first.update(xte[:32], yte[:32])
    first.checkpoint(tmp_path / "ck")
    resumed = ApproxValuationSession.restore(tmp_path / "ck", xtr, ytr,
                                             **CPU)
    r_resumed = resumed.update(xte[32:], yte[32:]).finalize()
    assert np.array_equal(_arr(r_straight), _arr(r_resumed))
    for key in ("recall_estimate", "matched_prefix", "error_bound",
                "n_tables", "window"):
        assert r_straight.meta[key] == r_resumed.meta[key]


def test_restore_keeps_explicit_planes(data, tmp_path):
    """A session on explicit planes checkpoints them: the restore rebuilds
    the same index, not one from the seed."""
    xtr, ytr, xte, yte = data
    kw = dict(k=K, mode="knn_shapley", test_batch=16, top_m=64, window=64,
              proj=tann.draw_planes(99, 4, 12, D), recall_sample=16, **CPU)
    straight = ApproxValuationSession(xtr, ytr, **kw).update(xte, yte)
    first = ApproxValuationSession(xtr, ytr, **kw).update(xte[:16], yte[:16])
    first.checkpoint(tmp_path / "ck")
    resumed = ApproxValuationSession.restore(tmp_path / "ck", xtr, ytr,
                                             **CPU)
    assert resumed.n_bits == 12
    resumed.update(xte[16:], yte[16:])
    assert torch.equal(straight.finalize().point_values,
                       resumed.finalize().point_values)


@pytest.mark.parametrize("mode", ("sti", "knn_shapley"))
def test_cross_package_approx_restore_raises(jx, mode, data, tmp_path):
    """The planes cannot cross: a JAX approx checkpoint is refused by the
    port, and the port's by the JAX package (its array names differ)."""
    xtr, ytr, xte, yte = data
    kw = dict(k=K, mode=mode, test_batch=16, top_m=64, seed=7, window=64,
              n_tables=4, recall_sample=16)
    jsess = jx.Session(jx.jnp.asarray(xtr), jx.jnp.asarray(ytr), **kw)
    jsess.update(jx.jnp.asarray(xte[:16]), jx.jnp.asarray(yte[:16]))
    jsess.checkpoint(tmp_path / "jax")
    with pytest.raises(ValueError, match="JAX package"):
        ApproxValuationSession.restore(tmp_path / "jax", xtr, ytr, **CPU)
    tsess = ApproxValuationSession(xtr, ytr, **kw, **CPU)
    tsess.update(xte[:16], yte[:16]).checkpoint(tmp_path / "torch")
    with pytest.raises(KeyError):
        jx.Session.restore(tmp_path / "torch", jx.jnp.asarray(xtr),
                           jx.jnp.asarray(ytr))


def test_exact_dispatch_checkpoints_cross_load(jx, data, tmp_path):
    """top_m >= n runs the exact step in both packages: those checkpoints
    hold no planes and cross-load both ways."""
    xtr, ytr, xte, yte = data
    kw = dict(k=K, mode="knn_shapley", test_batch=16, top_m=N)
    jsess = jx.Session(jx.jnp.asarray(xtr), jx.jnp.asarray(ytr),
                       distance="xla", **kw)
    jsess.update(jx.jnp.asarray(xte), jx.jnp.asarray(yte))
    jsess.checkpoint(tmp_path / "jax")
    got = ApproxValuationSession.restore(tmp_path / "jax", xtr, ytr, **CPU)
    np.testing.assert_allclose(got.finalize().point_values.numpy(),
                               np.asarray(jsess.finalize().point_values),
                               rtol=1e-5, atol=1e-7)


def test_session_matches_jax_session_on_jax_planes(jx):
    """The whole engine, with JAX's own drawn planes carried across
    (approx_params proj): same candidates on integer features, so the same
    matched prefix, recall, bound and pairs, values within 1e-6 of max
    |ref|."""
    x, y, xt, yt = _data(integer=True, seed=11)
    for mode in ("sti", "knn_shapley", "wknn"):
        kw = dict(k=K, mode=mode, test_batch=32, top_m=M, seed=7,
                  window=96, n_tables=8, recall_sample=32, recall_k=64)
        jsess = jx.Session(jx.jnp.asarray(x), jx.jnp.asarray(y), **kw)
        jres = jsess.update(jx.jnp.asarray(xt), jx.jnp.asarray(yt)).finalize()
        tsess = ApproxValuationSession(
            x, y, proj=np.asarray(jsess._tables.proj), **kw, **CPU)
        np.testing.assert_array_equal(tsess._tables.sorted_codes.numpy(),
                                      np.asarray(jsess._tables.sorted_codes))
        tres = tsess.update(xt, yt).finalize()
        want = _arr(jres)
        np.testing.assert_allclose(_arr(tres), want, rtol=0,
                                   atol=SLACK.get(mode, 1e-6)
                                   * np.abs(want).max())
        for key in ("matched_prefix", "recall_estimate", "error_bound",
                    "pairs_stored", "probed_rows", "n_tables", "window"):
            assert tres.meta.get(key) == jres.meta.get(key), (mode, key)


def test_data_valuator_and_launcher_run_approx(monkeypatch, capsys):
    from repro_torch import DataValuator
    from repro_torch.launch import valuate

    x, y, xt, yt = _data()
    dv = DataValuator(k=K, mode="knn_shapley", engine="approx",
                      test_batch=T, device="cpu")
    res = dv.run(x, y, xt, yt, top_m=M)
    assert res.meta["engine"] == "approx" and res.meta["top_m"] == M
    sess = dv.session(x, y, top_m=M)
    assert isinstance(sess, ApproxValuationSession)
    monkeypatch.setattr("sys.argv", [
        "valuate", "--device", "cpu", "--n", "96", "--t", "16", "--engine",
        "approx", "--method", "sti", "--top-m", "24", "--recall-target",
        "0.5"])
    valuate.main()
    out = capsys.readouterr().out
    assert "approx: top_m=24 exact=False" in out and "certified" in out


def test_approx_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    x, y, xt, yt = _data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ApproxValuationSession(x, y, mode="knn_shapley", top_m=M)
    for method in ("sti", "knn_shapley"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_method(method)(x, y, xt, yt, engine="approx", top_m=M)
    from repro_torch.kernels import autotune as at

    with pytest.raises(RuntimeError, match="device='cpu'"):
        at.autotune_fill(64, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tann.tables_from_jax(tann.build_tables(
            torch.from_numpy(x), tann.draw_planes(0, 2, 4, x.shape[1])))


# ------------------------------------------------ leftovers of the API
def test_restrict_matches_jax(jx):
    rng = np.random.default_rng(8)
    phi = rng.normal(size=(12, 12)).astype(np.float32)
    pv = rng.normal(size=12).astype(np.float32)
    idx = [7, 2, 2, 11, 0]
    got = ValuationResult("sti", phi=_t(phi), point_values=_t(pv),
                          meta={"n": 12}).restrict(idx)
    want = jx.Result("sti", phi=jx.jnp.asarray(phi),
                     point_values=jx.jnp.asarray(pv),
                     meta={"n": 12}).restrict(idx)
    np.testing.assert_array_equal(got.phi.numpy(), np.asarray(want.phi))
    np.testing.assert_array_equal(got.point_values.numpy(),
                                  np.asarray(want.point_values))
    assert got.meta == want.meta == {"n": 5, "restricted_from": 12}
    only = ValuationResult("loo", point_values=_t(pv)).restrict(
        np.array([3]))
    assert only.phi is None and only.point_values.tolist() == [pv[3]]


def test_make_moons_bit_identical_to_jax(jx):
    for args in ((50,), (7, 0.2, 3)):
        x, y = make_moons(*args)
        jxx, jy = jx.moons(*args)
        np.testing.assert_array_equal(x.numpy(), np.asarray(jxx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        assert x.dtype == torch.float32


# --------------------------------------------------------------- the card
@pytest.mark.cuda
def test_approx_engine_on_the_card_matches_the_cpu(cuda):
    """Same planes, integer features: the same candidates, prefix and
    pairs on the card as on the CPU; two card runs are bit-identical."""
    x, y, xt, yt = _data(integer=True, seed=12)
    for mode in ("sti", "knn_shapley"):
        kw = dict(k=K, mode=mode, test_batch=32, top_m=M, seed=7,
                  window=96, n_tables=8, recall_sample=32, recall_k=64)
        cpu = ApproxValuationSession(x, y, **kw, **CPU).update(xt, yt)
        runs = [ApproxValuationSession(x, y, device=cuda, **kw).update(
            xt, yt).finalize() for _ in range(2)]
        assert torch.equal(_t(_arr(runs[0])), _t(_arr(runs[1])))
        want = cpu.finalize()
        for key in ("matched_prefix", "recall_estimate", "pairs_stored"):
            assert runs[0].meta.get(key) == want.meta.get(key), key
        ref = _arr(want)
        np.testing.assert_allclose(_arr(runs[0]), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


@pytest.mark.cuda
def test_scatter_is_deterministic_on_the_card(cuda):
    rng = np.random.default_rng(13)
    n, tb, m = 4096, 256, 64
    cand = np.stack([rng.permutation(256)[:m] for _ in range(tb)])
    vals = rng.normal(size=(tb, m)).astype(np.float32)
    valid = (rng.random((tb, m)) > 0.1).astype(np.float32)
    outs = []
    for _ in range(3):
        vec = torch.zeros(n, device=cuda)
        scatter_point_update(vec, _t(cand).to(cuda), _t(vals).to(cuda),
                             _t(valid).to(cuda))
        outs.append(vec.cpu())
    vec = torch.zeros(n)
    scatter_point_update(vec, _t(cand), _t(vals), _t(valid))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    # the card's reduction adds in another order than the CPU's
    np.testing.assert_allclose(outs[0].numpy(), vec.numpy(), rtol=0,
                               atol=1e-6 * float(vec.abs().max()))
