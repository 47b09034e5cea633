"""The port's kernels (`repro_torch.kernels`) against the JAX package.

On the CPU: each kernel's plain PyTorch version is held against
`repro.kernels.ref` and against the Pallas kernel in interpret mode, at
the shapes of tests/test_kernels.py, the wrappers' argument checks are
exercised on meta tensors, and a copy of the fill kernel's tile walk
(upper tiles of the square, mirrored) is held to write every element
once and to give the plain version's bits. On a CUDA card (tests marked
`cuda`, skipped elsewhere; each under a watchdog): each CUDA kernel is
held against its plain version. Run those on a card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels.py -q

The JAX-side tests skip where JAX is not installed (the card's machine).
"""

import faulthandler
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.distance import distance_cuda, distance_plain
from repro_torch.kernels.sti_fill import (
    TILE,
    fill_tile_walk,
    sti_fill_acc_cuda,
    sti_fill_acc_plain,
    sti_fill_cuda,
    sti_fill_plain,
)

from _fill_tiles import emulate_fill, write_counts

FILL_SHAPES = [  # (t, n, block_n, block_t) of tests/test_kernels.py
    (4, 16, 8, 2),
    (7, 33, 16, 3),
    (16, 64, 64, 16),
    (3, 128, 128, 1),
    (12, 60, 32, 4),
    (5, 37, 32, 2),
]
DIST_SHAPES = [  # (t, n, d, dtype name) of tests/test_kernels.py
    (8, 16, 4, "float32"),
    (33, 65, 7, "float32"),
    (16, 16, 128, "bfloat16"),
    (128, 64, 512, "float32"),
]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels and oracles (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.distance import distance_pallas
    from repro.kernels.sti_fill import sti_fill_acc_pallas, sti_fill_pallas

    return types.SimpleNamespace(
        jnp=jnp, ref=jref, distance_pallas=distance_pallas,
        sti_fill_pallas=sti_fill_pallas,
        sti_fill_acc_pallas=sti_fill_acc_pallas,
    )


# seconds a `cuda` test may take: past it the process ends with a
# traceback (a hung kernel blocks in C, where no Python timeout reaches)
CUDA_TEST_LIMIT_S = 300


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    faulthandler.dump_traceback_later(CUDA_TEST_LIMIT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _fill_problem(t, n, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(t, n)).astype(np.float32)
    ranks = np.stack([rng.permutation(n) for _ in range(t)]).astype(np.int32)
    acc = rng.normal(size=(n, n)).astype(np.float32)
    return g, ranks, acc


# ------------------------------------------------------------ CPU parity
@pytest.mark.parametrize("t,n,bn,bt", FILL_SHAPES)
def test_plain_fill_matches_jax_ref_and_pallas(jx, t, n, bn, bt):
    """Tolerance 1e-6, as tests/test_kernels.py holds the Pallas fill:
    the sums over p run in another order."""
    g, ranks, _ = _fill_problem(t, n, t * 100 + n)
    got = sti_fill_plain(torch.from_numpy(g), torch.from_numpy(ranks))
    want_ref = np.asarray(jx.ref.sti_fill_ref(jx.jnp.asarray(g),
                                              jx.jnp.asarray(ranks)))
    want_pl = np.asarray(jx.sti_fill_pallas(
        jx.jnp.asarray(g), jx.jnp.asarray(ranks), block_n=bn, block_t=bt,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want_pl, rtol=1e-6, atol=1e-6)
    port_ref = ref.sti_fill_ref(torch.from_numpy(g), torch.from_numpy(ranks))
    np.testing.assert_allclose(port_ref.numpy(), want_ref, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("t,n,bn,bt", FILL_SHAPES[:3] + FILL_SHAPES[5:])
def test_plain_acc_fill_matches_pallas_in_place(jx, t, n, bn, bt):
    """The accumulate form adds into the caller's tensor and returns it;
    equal to the aliased Pallas kernel within 1e-6 of the largest value
    (with block_t < t Pallas adds one sum per block of test points, the
    plain version one sum over all of them)."""
    g, ranks, acc0 = _fill_problem(t, n, t + 7 * n)
    acc = torch.from_numpy(acc0.copy())
    out = sti_fill_acc_plain(acc, torch.from_numpy(g), torch.from_numpy(ranks))
    assert out.data_ptr() == acc.data_ptr()
    want = np.asarray(jx.sti_fill_acc_pallas(
        jx.jnp.asarray(acc0), jx.jnp.asarray(g), jx.jnp.asarray(ranks),
        block_n=bn, block_t=bt, interpret=True))
    assert np.abs(acc.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("t,n,d,dtype", DIST_SHAPES)
def test_plain_distance_matches_jax(jx, t, n, d, dtype):
    """f32 within 1e-5 and bf16 inputs within 3e-2, the tolerances of
    tests/test_kernels.py."""
    rng = np.random.default_rng(n + d)
    xt = rng.normal(size=(t, d)).astype(np.float32)
    xn = rng.normal(size=(n, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = distance_plain(torch.from_numpy(xt).to(tdt),
                         torch.from_numpy(xn).to(tdt)).numpy()
    jdt = getattr(jx.jnp, dtype)
    jt, jn = jx.jnp.asarray(xt).astype(jdt), jx.jnp.asarray(xn).astype(jdt)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, np.asarray(jx.ref.distance_ref(jt, jn)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(
        got, np.asarray(jx.distance_pallas(jt, jn, block_t=16, block_n=16,
                                           block_d=64, interpret=True)),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(
        ref.distance_ref(torch.from_numpy(xt).to(tdt),
                         torch.from_numpy(xn).to(tdt)).numpy(),
        got, rtol=0, atol=0)


def test_integer_feature_distances_are_exact(jx):
    """On integer features in [-8, 8] every product and sum is exact in
    f32: the plain distance equals the Pallas kernel bit for bit."""
    rng = np.random.default_rng(5)
    xt = rng.integers(-8, 9, (16, 40)).astype(np.float32)
    xn = rng.integers(-8, 9, (48, 40)).astype(np.float32)
    got = distance_plain(torch.from_numpy(xt), torch.from_numpy(xn)).numpy()
    want = np.asarray(jx.distance_pallas(
        jx.jnp.asarray(xt), jx.jnp.asarray(xn), block_t=16, block_n=16,
        block_d=64, interpret=True))
    np.testing.assert_array_equal(got, want)

@pytest.mark.parametrize("t,n,bn", [(4, 16, 8), (7, 33, 16), (16, 64, 64),
                                    (12, 60, 32), (5, 37, 32)])
def test_plain_acc_fill_order_is_the_pallas_acc_kernels(jx, t, n, bn):
    """With block_t >= t the Pallas acc kernel adds the tile's sum over p,
    taken from zero, to the seeded output once: the plain version's (and
    the CUDA kernel's) order. Held to 1e-6 of the largest value, and
    bit-equal on this CPU."""
    g, ranks, acc0 = _fill_problem(t, n, 5 * t + n)
    acc = sti_fill_acc_plain(torch.from_numpy(acc0.copy()),
                             torch.from_numpy(g), torch.from_numpy(ranks))
    want = np.asarray(jx.sti_fill_acc_pallas(
        jx.jnp.asarray(acc0), jx.jnp.asarray(g), jx.jnp.asarray(ranks),
        block_n=bn, block_t=t, interpret=True))
    assert np.abs(acc.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(acc.numpy(), want)


# ---------------------------------------------- the kernel's tile walk
@pytest.mark.parametrize("n", [1, 127, 128, 129, 4099])
def test_square_tile_walk_writes_each_element_once(n):
    """The square computes only the T(T+1)/2 tiles on and above the
    diagonal, T = ceil(n / 128), and with their mirrors writes each of
    the n^2 elements exactly once."""
    tiles, counts = write_counts(n, n, 0)
    big = -(-n // TILE)
    assert tiles == big * (big + 1) // 2
    assert counts.min() == 1 and counts.max() == 1
    walk = list(fill_tile_walk(n, n, 0))
    assert all(i <= j for i, j, _ in walk)
    assert [(i, j) for i, j, m in walk if m is None] == [
        (i, i) for i in range(big)]


@pytest.mark.parametrize("t,n", [(5, 129), (17, 300), (3, 260)])
def test_square_tile_walk_gives_the_plain_bits(t, n):
    """A numpy copy of the kernel's dataflow -- each upper tile's sum from
    zero added to its tile and, transposed, to its mirror -- gives the
    plain version's bits on a non-symmetric accumulator."""
    g, ranks, acc0 = _fill_problem(t, n, 11 * n + t)
    got = emulate_fill(acc0.copy(), g, ranks, ranks, 0)
    want = sti_fill_acc_plain(torch.from_numpy(acc0.copy()),
                              torch.from_numpy(g), torch.from_numpy(ranks))
    np.testing.assert_array_equal(got, want.numpy())


# ------------------------------------------------- wrappers on the CPU
def test_wrappers_take_the_plain_version_on_cpu():
    g, ranks, acc0 = _fill_problem(6, 20, 1)
    g_t, r_t = torch.from_numpy(g), torch.from_numpy(ranks)
    before = (distance_cuda.launches, sti_fill_acc_cuda.launches)
    acc = torch.from_numpy(acc0.copy())
    assert sti_fill_acc_cuda(acc, g_t, r_t) is acc
    assert torch.equal(acc, sti_fill_acc_plain(torch.from_numpy(acc0.copy()),
                                               g_t, r_t))
    assert torch.equal(sti_fill_cuda(g_t, r_t), sti_fill_plain(g_t, r_t))
    x, y = torch.randn(5, 3), torch.randn(9, 3)
    assert torch.equal(distance_cuda(x, y), distance_plain(x, y))
    assert (distance_cuda.launches, sti_fill_acc_cuda.launches) == before


@pytest.mark.parametrize("case", ["dtype", "dims", "shape", "contig"])
def test_distance_wrapper_checks_arguments(case):
    """Non-CPU tensors are checked before any build or launch (meta
    tensors stand in for CUDA ones here)."""
    m = torch.device("meta")
    xt, xn = torch.empty(4, 8, device=m), torch.empty(6, 8, device=m)
    if case == "dtype":
        xn, err = xn.to(torch.float16), TypeError
    elif case == "dims":
        xn, err = torch.empty(6, 9, device=m), ValueError
    elif case == "shape":
        xt, err = torch.empty(4, 8, 1, device=m), ValueError
    else:
        xt, err = torch.empty(8, 4, device=m).T, ValueError
    with pytest.raises(err):
        distance_cuda(xt, xn)


@pytest.mark.parametrize("case", ["acc_shape", "ranks_shape", "g_dtype",
                                  "float_ranks", "device"])
def test_fill_wrapper_checks_arguments(case):
    m = torch.device("meta")
    acc = torch.empty(10, 10, device=m)
    g = torch.empty(3, 10, device=m)
    ranks = torch.empty(3, 10, dtype=torch.int64, device=m)
    err = ValueError
    if case == "acc_shape":
        acc = torch.empty(10, 11, device=m)
    elif case == "ranks_shape":
        ranks = torch.empty(3, 9, dtype=torch.int64, device=m)
    elif case == "g_dtype":
        g, err = g.to(torch.float64), TypeError
    elif case == "float_ranks":
        ranks, err = torch.empty(3, 10, device=m), TypeError
    else:
        g = torch.empty(3, 10)
    with pytest.raises(err):
        sti_fill_acc_cuda(acc, g, ranks)


def test_no_fallback_when_the_build_is_impossible(monkeypatch, tmp_path):
    """Without nvcc a non-CPU tensor raises: nothing falls back to the
    plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernels build and launch there")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    m = torch.device("meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        distance_cuda(torch.empty(4, 8, device=m), torch.empty(6, 8, device=m))


# ---------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("t,n", [(4, 16), (7, 33), (5, 37), (12, 60),
                                 (37, 130), (16, 300)])
def test_cuda_fill_matches_plain(cuda, t, n):
    """The kernel adds the test points in the plain version's order, so
    1e-6 (the repo's fill tolerance) admits only rounding."""
    g, ranks, acc0 = _fill_problem(t, n, 3 * n + t)
    g_d, r_d = torch.from_numpy(g).to(cuda), torch.from_numpy(ranks).to(cuda)
    before = sti_fill_acc_cuda.launches
    acc = torch.from_numpy(acc0).to(cuda)
    out = sti_fill_acc_cuda(acc, g_d, r_d)
    assert out is acc and sti_fill_acc_cuda.launches == before + 1
    want = sti_fill_acc_plain(torch.from_numpy(acc0).to(cuda), g_d, r_d)
    torch.cuda.synchronize()
    torch.testing.assert_close(acc, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sti_fill_cuda(g_d, r_d.long()),
                               sti_fill_plain(g_d, r_d), rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n", [(37, 129), (20, 4099), (33, 8192)])
def test_cuda_square_fill_mirror_is_bit_equal(cuda, t, n):
    """Upper tiles mirrored into the lower half, on a non-symmetric
    accumulator and ragged t: bit-equal to the plain version, and the
    increment is exactly symmetric."""
    g, ranks, _ = _fill_problem(t, n, n + 2 * t)
    g_d, r_d = torch.from_numpy(g).to(cuda), torch.from_numpy(ranks).to(cuda)
    acc0 = torch.randn((n, n), generator=torch.Generator(cuda).manual_seed(n),
                       device=cuda)
    got = sti_fill_acc_cuda(acc0.clone(), g_d, r_d)
    want = sti_fill_acc_plain(acc0.clone(), g_d, r_d)
    zero = sti_fill_cuda(g_d, r_d)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(zero, zero.T)
    assert torch.equal(got, acc0 + zero)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,d,dtype", DIST_SHAPES + [
    (256, 1000, 768, "float32"), (70, 129, 33, "bfloat16")])
def test_cuda_distance_matches_plain(cuda, t, n, d, dtype):
    """Within 1e-5 of the largest distance for f32 and bf16 inputs alike:
    both sides read the same tensors, form exact products in f32 and sum
    them in f32, in another order."""
    rng = np.random.default_rng(n + d)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32)).to(
        cuda, tdt)
    xn = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(
        cuda, tdt)
    before = distance_cuda.launches
    got = distance_cuda(xt, xn)
    assert distance_cuda.launches == before + 1
    want = distance_plain(xt, xn)
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
def test_cuda_distance_exact_on_integer_features(cuda):
    rng = np.random.default_rng(9)
    xt = torch.from_numpy(rng.integers(-8, 9, (40, 768)).astype(
        np.float32)).to(cuda)
    xn = torch.from_numpy(rng.integers(-8, 9, (500, 768)).astype(
        np.float32)).to(cuda)
    assert torch.equal(distance_cuda(xt, xn), distance_plain(xt, xn))
