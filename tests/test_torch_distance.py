"""The distance kernel's arithmetic (3xTF32 on the tensor cores) and its
TMA input contract (`repro_torch.kernels.distance`).

On the CPU: an emulation of what `csrc/distance_tile.cuh` computes -- the
TF32 truncation by bit mask, lo = x - hi read as TF32 again, three
products per 8-column step in the kernel's order into one f32
accumulator, the norm epilogue -- is held against the plain version, the
Pallas kernel in interpret mode and a float64 reference; the wrapper's
zero padding of d is held against the plain version. On a CUDA card
(tests marked `cuda`, skipped elsewhere) the kernel is held against its
plain version at ragged shapes, bit for bit on integer features, its SASS
is checked for `wgmma` (HGMMA) and TMA (UTMALDG), and the megakernel's
rank phase, which runs the same tile, is held bit for bit against
`torch.sort` of the kernel's distances. Run those on a card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_distance.py -q

The JAX-side test skips where JAX is not installed (the card's machine).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.distance import (
    distance_cuda,
    distance_plain,
    tma_operands,
)
from repro_torch.kernels.sti_megakernel import (
    _features,
    megakernel_rank_phase_cuda,
)

HI_MASK = np.int32(-8192)  # 0xffffe000: sign, exponent, 10 mantissa bits


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


def _tf32(x: np.ndarray) -> np.ndarray:
    """x as the tensor cores read a TF32 operand: the low 13 mantissa bits
    cleared."""
    return (x.astype(np.float32).view(np.int32) & HI_MASK).view(np.float32)


def _split(x: np.ndarray):
    """hi (the TF32 part of x) and lo = x - hi (exact in f32), as the
    kernel forms them."""
    hi = _tf32(x)
    return hi, (x.astype(np.float32) - hi).astype(np.float32)


def _norms(x: np.ndarray) -> np.ndarray:
    """The pre-pass's squared norms: lane-strided f32 FMA chains over 32
    lanes, then a butterfly (emulated with f32 adds in the same order)."""
    x = x.astype(np.float32)
    rows, d = x.shape
    lanes = np.zeros((rows, 32), np.float32)
    for j in range(d):
        lanes[:, j % 32] = (lanes[:, j % 32].astype(np.float64)
                            + x[:, j].astype(np.float64) ** 2
                            ).astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[:, np.arange(32) ^ o]).astype(np.float32)
    return lanes[:, 0]


def emulate(x_test: np.ndarray, x_train: np.ndarray) -> np.ndarray:
    """(t, d), (n, d) f32 -> (t, n) f32: the kernel's arithmetic. Per
    8-column step, lo_test . hi_train, hi_test . lo_train, hi . hi, each
    product's eight terms summed exactly (float64) and added to the f32
    accumulator once, lo read as TF32; then max(nt - 2 acc + nn, 0)."""
    a_hi, a_lo = _split(x_test)
    b_hi, b_lo = _split(x_train)
    a_lo, b_lo = _tf32(a_lo), _tf32(b_lo)
    acc = np.zeros((x_test.shape[0], x_train.shape[0]), np.float32)
    for k0 in range(0, x_test.shape[1], 8):
        s = slice(k0, k0 + 8)
        for a, b in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            part = a[:, s].astype(np.float64) @ b[:, s].astype(np.float64).T
            acc = (acc + part).astype(np.float32)
    nt, nn = _norms(x_test), _norms(x_train)
    cross = (np.float32(2) * acc).astype(np.float32)
    d2 = ((nt[:, None] - cross).astype(np.float32) + nn[None, :]).astype(
        np.float32)
    return np.maximum(d2, np.float32(0))


# ------------------------------------------------------------ CPU parity
@pytest.mark.parametrize("d", [7, 33, 768])
def test_emulation_within_tolerance_of_plain(d):
    """On normal data the dropped lo . lo term and lo's TF32 truncation
    move each product by ~2^-22 of |a||b|: far inside the 1e-5 of the
    largest distance that the kernel is held to on the card."""
    rng = np.random.default_rng(d)
    xt = rng.normal(size=(24, d)).astype(np.float32)
    xn = rng.normal(size=(40, d)).astype(np.float32)
    want = distance_plain(torch.from_numpy(xt), torch.from_numpy(xn)).numpy()
    got = emulate(xt, xn)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_emulation_is_bit_equal_to_plain_and_pallas_on_integers():
    """Integer features in [-8, 8]: hi = x, lo = 0, every product and sum
    exact, so the emulation, the plain version and the Pallas kernel agree
    bit for bit."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.distance import distance_pallas

    rng = np.random.default_rng(5)
    xt = rng.integers(-8, 9, (16, 40)).astype(np.float32)
    xn = rng.integers(-8, 9, (48, 40)).astype(np.float32)
    got = emulate(xt, xn)
    np.testing.assert_array_equal(
        got, distance_plain(torch.from_numpy(xt), torch.from_numpy(xn)).numpy())
    np.testing.assert_array_equal(got, np.asarray(distance_pallas(
        jnp.asarray(xt), jnp.asarray(xn), block_t=16, block_n=16,
        block_d=64, interpret=True)))


@pytest.mark.parametrize("lo,d", [(-2047, 1), (0, 3)])
def test_emulation_is_exact_for_integers_up_to_2047(lo, d):
    """|x| <= 2047 fits TF32's 11 significant bits, so hi = x and lo = 0.
    Where every sum stays below 2^24 (d = 1 for signed features, d = 3 for
    non-negative ones, whose cross terms cannot push nt - 2 acc past the
    norms) the distances are exact: equal to a float64 reference."""
    rng = np.random.default_rng(11 + d)
    xt = rng.integers(lo, 2048, (20, d)).astype(np.float32)
    xn = rng.integers(lo, 2048, (30, d)).astype(np.float32)
    xt[0], xn[0] = 2047, lo  # the extremes
    hi, rest = _split(np.concatenate([xt, xn]))
    np.testing.assert_array_equal(hi, np.concatenate([xt, xn]))
    assert not rest.any()
    want = ((xt.astype(np.float64)[:, None, :]
             - xn.astype(np.float64)[None, :, :]) ** 2).sum(-1)
    assert want.max() < 2.0 ** 24 and want.max() > 2.0 ** 21
    np.testing.assert_array_equal(emulate(xt, xn).astype(np.float64), want)


def test_split_is_exact():
    """hi keeps the sign, the exponent and 10 mantissa bits of x, and
    hi + lo = x exactly, for any f32 (normal and subnormal magnitudes)."""
    rng = np.random.default_rng(2)
    x = np.concatenate([
        rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096),
        rng.normal(size=64) * 1e-40]).astype(np.float32)
    hi, lo = _split(x)
    assert not (hi.view(np.int32) & ~HI_MASK).any()
    np.testing.assert_array_equal((hi + lo).astype(np.float32), x)
    np.testing.assert_array_equal(
        hi.astype(np.float64) + lo.astype(np.float64), x.astype(np.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 7, 33, 768])
def test_tma_padding_leaves_the_distances_unchanged(dtype, d):
    """The wrapper pads d with zero columns to a multiple of 16 bytes (4
    f32, 8 bf16), and hands a d that TMA can stride over as it is. Zero
    columns leave the kernel's arithmetic (the emulation) and the plain
    cross term bit for bit unchanged. The plain version's norms are a
    `torch.sum`, whose CPU reduction order depends on the row length, so
    the plain distances of the padded operands may round differently:
    they are held to 1e-6 of the largest distance."""
    rng = np.random.default_rng(d)
    xt = torch.from_numpy(rng.normal(size=(9, d)).astype(np.float32)).to(
        dtype)
    xn = torch.from_numpy(rng.normal(size=(13, d)).astype(np.float32)).to(
        dtype)
    pt, pn = tma_operands(xt, xn)
    per16 = 16 // xt.element_size()
    assert pt.shape[1] % per16 == 0 and pt.shape[1] - d < per16
    assert torch.equal(pt[:, :d], xt) and not pt[:, d:].any()
    assert torch.equal(pn[:, :d], xn) and not pn[:, d:].any()
    assert pt.data_ptr() % 16 == 0 and pn.data_ptr() % 16 == 0
    if d % per16 == 0:
        assert pt is xt and pn is xn
    f32 = [x.float().numpy() for x in (xt, xn, pt, pn)]
    np.testing.assert_array_equal(emulate(*f32[2:]), emulate(*f32[:2]))
    np.testing.assert_array_equal(_norms(f32[2]), _norms(f32[0]))
    assert torch.equal(pt.float() @ pn.float().T, xt.float() @ xn.float().T)
    want = distance_plain(xt, xn)
    torch.testing.assert_close(distance_plain(pt, pn), want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


def test_tma_operands_copy_a_misaligned_view():
    """A contiguous view 4 bytes into its storage is copied to an aligned
    allocation; its values are unchanged."""
    flat = torch.arange(1 + 2 * 8, dtype=torch.float32)
    x = flat[1:].view(2, 8)
    assert x.data_ptr() % 16
    px, _ = tma_operands(x, x)
    assert px.data_ptr() % 16 == 0 and torch.equal(px, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [7, 768])
def test_megakernel_features_take_the_distance_padding(dtype, d):
    """The megakernel's wrapper brings its features to f32 and then through
    `tma_operands`, so a ragged d reaches its distance phase padded exactly
    as it reaches `distance.cu`."""
    rng = np.random.default_rng(d + 1)
    xb = torch.from_numpy(rng.normal(size=(5, d)).astype(np.float32)).to(
        dtype)
    xs = torch.from_numpy(rng.normal(size=(11, d)).astype(np.float32)).to(
        dtype)
    fb, fs = _features(xb, xs)
    wb, ws = tma_operands(xb.float(), xs.float())
    assert fb.dtype == fs.dtype == torch.float32
    assert torch.equal(fb, wb) and torch.equal(fs, ws)
    assert fb.shape[1] % 4 == 0 and fb.data_ptr() % 16 == 0


def test_zero_features_give_zero_distances():
    """d = 0: every distance is 0, on the CPU as on the card."""
    got = distance_cuda(torch.zeros((3, 0)), torch.zeros((5, 0)))
    assert torch.equal(got, torch.zeros((3, 5)))


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_distance_zero_features(cuda, dtype):
    """d = 0 gives zeros, as the plain version does, with no launch."""
    xt = torch.zeros((4, 0), dtype=dtype, device=cuda)
    xn = torch.zeros((6, 0), dtype=dtype, device=cuda)
    before = distance_cuda.launches
    got = distance_cuda(xt, xn)
    assert distance_cuda.launches == before
    assert torch.equal(got, distance_plain(xt, xn))
    assert torch.equal(got, torch.zeros((4, 6), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [7, 33, 768])
@pytest.mark.parametrize("n", [65, 129, 1000])
@pytest.mark.parametrize("t", [33, 70, 256])
def test_cuda_distance_ragged_shapes(cuda, t, n, d, dtype):
    """Ragged t, n and d (TMA's zero fill, the padded d, the masked store)
    within 1e-5 of the largest distance, as chip_smoke.py holds it."""
    rng = np.random.default_rng(t * n + d)
    xt = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32)).to(
        cuda, dtype)
    xn = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(
        cuda, dtype)
    before = distance_cuda.launches
    got = distance_cuda(xt, xn)
    assert distance_cuda.launches == before + 1 and got.shape == (t, n)
    want = distance_plain(xt, xn)
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_distance_bit_equal_on_integer_features(cuda, dtype):
    """Integer features in [-8, 8] at ragged shapes: distances and ranks
    bit-equal to the plain version."""
    rng = np.random.default_rng(9)
    xt = torch.from_numpy(rng.integers(-8, 9, (70, 100)).astype(
        np.float32)).to(cuda, dtype)
    xn = torch.from_numpy(rng.integers(-8, 9, (1000, 100)).astype(
        np.float32)).to(cuda, dtype)
    got, want = distance_cuda(xt, xn), distance_plain(xt, xn)
    assert torch.equal(got, want)
    assert torch.equal(torch.sort(got, dim=-1, stable=True).indices,
                       torch.sort(want, dim=-1, stable=True).indices)


@pytest.mark.cuda
def test_cuda_distance_kernel_runs_on_wgmma_and_tma(cuda):
    """Both entry kernels (f32 and bf16) hold HGMMA and UTMALDG."""
    kernels = {n: t for n, t in build.sass("distance").items()
               if "sq_dist_kernel" in n}
    assert len(kernels) == 2, sorted(build.sass("distance"))
    for name, text in kernels.items():
        assert "HGMMA" in text and "UTMALDG" in text, name


@pytest.mark.cuda
def test_cuda_megakernel_distance_phase_runs_on_wgmma(cuda):
    kernels = build.sass("sti_megakernel")
    assert kernels and all("HGMMA" in t for t in kernels.values())


@pytest.mark.cuda
def test_cuda_rank_phase_bit_equal_to_sort_of_distance(cuda):
    """On continuous data the megakernel's distance phase gives the bits
    of `distance_cuda` (the same k-step function): its rank phase equals
    torch.sort(stable=True) of them, values and order."""
    rng = np.random.default_rng(4)
    xb = torch.from_numpy(rng.normal(size=(256, 768)).astype(
        np.float32)).to(cuda)
    xs = torch.from_numpy(rng.normal(size=(8192, 768)).astype(
        np.float32)).to(cuda)
    d2s, order = megakernel_rank_phase_cuda(xb, xs)
    want = torch.sort(distance_cuda(xb, xs), dim=-1, stable=True)
    assert torch.equal(d2s, want.values)
    assert torch.equal(order, want.indices)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [7, 32])
@pytest.mark.parametrize("misaligned", [False, True])
def test_cuda_rank_phase_bit_equal_at_ragged_d(cuda, d, misaligned):
    """A d that is no multiple of 4 (padded), and a view 4 bytes into its
    storage (copied), reach the rank phase through the same padding as `distance_cuda`: its
    values and order equal torch.sort(stable=True) of the kernel's
    distances."""
    rng = np.random.default_rng(d)
    xb = torch.from_numpy(rng.normal(size=(70, d)).astype(np.float32)).to(
        cuda)
    flat = torch.from_numpy(rng.normal(size=(1 + 1000 * d,)).astype(
        np.float32)).to(cuda)
    xs = (flat[1:] if misaligned else flat[:-1]).view(1000, d)
    assert (xs.data_ptr() % 16 != 0) == misaligned
    d2s, order = megakernel_rank_phase_cuda(xb, xs)
    want = torch.sort(distance_cuda(xb, xs), dim=-1, stable=True)
    assert torch.equal(d2s, want.values)
    assert torch.equal(order, want.indices)
