"""The port's fused megakernel (`repro_torch.kernels.sti_megakernel`)
against the JAX package.

On the CPU: the online merge's property tests, held bit for bit against
the JAX `streaming_merge_reference` and against `torch.sort(stable=True)`
on tie-heavy data; the plain megakernels against the JAX Pallas
megakernels in interpret mode (as tests/test_megakernel.py runs them),
row blocks included, within 1e-5; and `fill="megakernel"` end to end for
all five methods. On a CUDA card (tests marked `cuda`, skipped
elsewhere; each under a watchdog): each kernel against its plain version
and the rank phase bit for bit against `torch.sort` of `distance_cuda`.
Run those on a card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_megakernel.py -q

The JAX-side tests skip where JAX is not installed (the card's machine).
"""

import faulthandler
import importlib
import re
import types

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:
    from _hypothesis_fallback import given, settings, st

from _sort_tiles import keys_of, radix_sort_model
from repro_torch.core.sti_knn import ranks_from_order
from repro_torch.kernels.distance import distance_cuda
from repro_torch.kernels.sti_megakernel import (
    RADIX_BITS,
    SORT_KEYS_PER_THREAD,
    SORT_THREADS,
    SORT_TILE,
    megakernel_rank_phase_cuda,
    megakernel_rank_phase_plain,
    megakernel_static,
    merge_sorted_tile,
    point_megakernel_cuda,
    point_megakernel_plain,
    radix_passes,
    sti_megakernel_cuda,
    sti_megakernel_plain,
    streaming_merge_reference,
)

POINT_CASES = [("knn_shapley", None), ("wknn", {"weights": "rbf"}),
               ("wknn", {"weights": "inverse"}),
               ("wknn", {"weights": "uniform"}), ("loo", None)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's megakernel module and pipeline (skips where JAX
    is absent)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro  # noqa: F401
    from repro.kernels import sti_pipeline as jpipe

    # `repro.kernels` exports the function under the module's name
    jmk = importlib.import_module("repro.kernels.sti_megakernel")
    return types.SimpleNamespace(jnp=jnp, mk=jmk, pipe=jpipe)


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


def _problem(n, t, d=6, classes=2, seed=0, integer=False, lo=-8, hi=8):
    rng = np.random.default_rng(seed)
    if integer:
        xs = rng.integers(lo, hi + 1, size=(n, d)).astype(np.float32)
        xt = rng.integers(lo, hi + 1, size=(t, d)).astype(np.float32)
    else:
        xs = rng.normal(size=(n, d)).astype(np.float32)
        xt = rng.normal(size=(t, d)).astype(np.float32)
    ys = rng.integers(0, classes, size=(n,)).astype(np.int32)
    yt = rng.integers(0, classes, size=(t,)).astype(np.int32)
    return xs, ys, xt, yt


def _mask(t, real):
    m = np.zeros((t,), np.float32)
    m[:real] = 1.0
    return m


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


# ---------------------------------------------------- online merge property
def _merge_both(jx, d2, match, **kw):
    got = streaming_merge_reference(torch.from_numpy(d2),
                                    torch.from_numpy(match), **kw)
    want = jx.mk.streaming_merge_reference(jx.jnp.asarray(d2),
                                           jx.jnp.asarray(match), **kw)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@settings(max_examples=25, deadline=None)
@given(
    n=st.integers(3, 40),
    t=st.integers(1, 4),
    block_n=st.integers(1, 17),
    dup=st.booleans(),
    seed=st.integers(0, 2**31 - 1),
)
def test_streaming_full_width_matches_jax_and_stable_sort(jx, n, t, block_n,
                                                          dup, seed):
    """Full-width streaming is bit-equal to the JAX merge and to
    torch.sort(stable=True), for any tile width and with heavy ties."""
    rng = np.random.default_rng(seed)
    d2 = rng.normal(size=(t, n)).astype(np.float32) ** 2
    if dup:
        d2 = np.round(d2 * 2) / 2
    match = rng.integers(0, 2, size=(t, n)).astype(np.float32)
    (d2s, idx, ms), want = _merge_both(jx, d2, match, block_n=block_n)
    for a, b in zip((d2s, idx, ms), want):
        np.testing.assert_array_equal(a, b)
    srt = torch.sort(torch.from_numpy(d2), dim=-1, stable=True)
    np.testing.assert_array_equal(idx, srt.indices.numpy())
    np.testing.assert_array_equal(d2s, srt.values.numpy())
    np.testing.assert_array_equal(ms, np.take_along_axis(match, idx, -1))


def test_streaming_merge_deterministic_sweep(jx):
    """Hypothesis-free sweep: tie-heavy data, non-divisible tile widths,
    full width and truncated widths k in {1, 5} (a streaming top-k, held
    against the JAX merge and torch.topk's values)."""
    for seed, (n, t, block_n) in enumerate(
            [(5, 1, 2), (17, 3, 4), (31, 2, 7), (40, 4, 13), (48, 1, 48)]):
        rng = np.random.default_rng(100 + seed)
        d2 = np.round(rng.normal(size=(t, n)).astype(np.float32) ** 2, 1)
        match = rng.integers(0, 2, size=(t, n)).astype(np.float32)
        got, want = _merge_both(jx, d2, match, block_n=block_n)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        order = np.argsort(d2, axis=-1, kind="stable")
        np.testing.assert_array_equal(got[1], order)
        ranks = ranks_from_order(torch.from_numpy(order)).numpy()
        inv = np.zeros_like(order)
        np.put_along_axis(inv, order, np.broadcast_to(np.arange(n), (t, n)),
                          axis=-1)
        np.testing.assert_array_equal(ranks, inv)
        for k in (1, 5):
            if k > n:
                continue
            got, want = _merge_both(jx, d2, match, n_keep=k, block_n=block_n)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(got[1], order[:, :k])
            top = torch.topk(torch.from_numpy(d2), k, largest=False).values
            np.testing.assert_array_equal(got[0], top.numpy())


@pytest.mark.parametrize("block", [1, 4, 7, 16])
def test_merge_split_invariant_on_ragged_tiles(block):
    """Any split of the columns into tiles merges to the single-tile
    result."""
    rng = np.random.default_rng(3)
    d2 = torch.from_numpy(rng.normal(size=(3, 23)).astype(np.float32) ** 2)
    match = torch.from_numpy(rng.integers(0, 2, (3, 23)).astype(np.float32))
    want = streaming_merge_reference(d2, match, block_n=23)
    got = streaming_merge_reference(d2, match, block_n=block)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_merge_sorted_tile_padded_columns_sort_last():
    """+inf padding and the service's ~1e30 dead-slot distances never
    displace real entries."""
    run = (torch.full((1, 4), float("inf")), torch.full((1, 4), 9),
           torch.zeros((1, 4)))
    d2 = torch.tensor([[2.0, 1e30, 1.0, float("inf")]])
    idx = torch.tensor([[0, 1, 2, 3]])
    match = torch.tensor([[1.0, 1.0, 0.0, 1.0]])
    d2s, idxs, _ = merge_sorted_tile(*run, d2, idx, match)
    assert idxs[0].tolist()[:3] == [2, 0, 1]
    assert d2s[0].tolist()[:3] == [1.0, 2.0, float(np.float32(1e30))]


# ---------------------------------------- plain megakernels vs the Pallas ones
def _jax_sti(jx, acc, diag, x, y, xt, yt, mask, **kw):
    j = jx.jnp.asarray
    a, dg = jx.mk.sti_megakernel(j(acc), j(diag), j(xt), j(yt), j(mask),
                                 j(x), j(y), interpret=True, **kw)
    return np.asarray(a), np.asarray(dg)


@pytest.mark.parametrize("mode", ["sti", "sii"])
@pytest.mark.parametrize("n,t,real,row_block", [
    (64, 4, 4, None), (256, 4, 3, None), (48, 5, 5, (16, 16)),
    (37, 4, 2, (30, 7)),
])
def test_plain_sti_megakernel_matches_pallas(jx, mode, n, t, real,
                                             row_block):
    """One step on a live accumulator (and on a row block at row_offset)
    equals the Pallas kernel within 1e-5."""
    x, y, xt, yt = _problem(n, t, seed=n + t)
    mask = _mask(t, real)
    rng = np.random.default_rng(1)
    off, nr = row_block or (None, n)
    acc0 = rng.normal(size=(nr, n)).astype(np.float32)
    diag0 = rng.normal(size=(nr,)).astype(np.float32)
    want = _jax_sti(jx, acc0, diag0, x, y, xt, yt, mask, k=5, mode=mode,
                    row_offset=off)
    acc, diag, xb, yb, m, xs, ys = _torch(acc0, diag0, xt, yt, mask, x, y)
    out = sti_megakernel_cuda(acc, diag, xb, yb, m, xs, ys, k=5, mode=mode,
                              row_offset=off)
    assert out[0] is acc and out[1] is diag
    np.testing.assert_allclose(acc.numpy(), want[0], atol=1e-5)
    np.testing.assert_allclose(diag.numpy(), want[1], atol=1e-5)


@pytest.mark.parametrize("mode", ["sti", "sii"])
@pytest.mark.parametrize("n,t,row_block", [(64, 4, None), (200, 6, None),
                                           (300, 5, (128, 150)),
                                           (90, 3, (17, 40))])
def test_plain_sti_megakernel_order_is_the_pallas_kernels(jx, mode, n, t,
                                                          row_block):
    """One step on a live, non-symmetric accumulator with block_t >= t:
    the Pallas kernel adds the tile's sum over p, taken from zero, to the
    seeded output once, as the plain version now does. Held to 1e-6 of
    the largest value: the g tables come from two packages' scans (the
    JAX recurrence and torch.cumsum), so the bits part in most of these
    cases on this CPU, where the fills alone are bit-equal."""
    x, y, xt, yt = _problem(n, t, seed=3 * n + t)
    mask = _mask(t, t - 1)
    rng = np.random.default_rng(n)
    off, nr = row_block or (None, n)
    acc0 = rng.normal(size=(nr, n)).astype(np.float32)
    diag0 = rng.normal(size=(nr,)).astype(np.float32)
    want = _jax_sti(jx, acc0, diag0, x, y, xt, yt, mask, k=3, mode=mode,
                    row_offset=off, block_t=t)
    acc, diag, xb, yb, m, xs, ys = _torch(acc0, diag0, xt, yt, mask, x, y)
    sti_megakernel_plain(acc, diag, xb, yb, m, xs, ys, k=3, mode=mode,
                         row_offset=off)
    for got, w in ((acc.numpy(), want[0]), (diag.numpy(), want[1])):
        assert np.abs(got - w).max() <= 1e-6 * np.abs(w).max()


@pytest.mark.parametrize("method,opts", POINT_CASES)
@pytest.mark.parametrize("n,row_block", [(64, None), (256, None),
                                         (40, (24, 16))])
def test_plain_point_megakernel_matches_pallas(jx, method, opts, n,
                                               row_block):
    t, real = 4, 3
    x, y, xt, yt = _problem(n, t, classes=3, seed=20 + n)
    mask = _mask(t, real)
    off, nr = row_block or (None, n)
    vec0 = np.random.default_rng(2).normal(size=(nr,)).astype(np.float32)
    j = jx.jnp.asarray
    want = np.asarray(jx.mk.point_megakernel(
        j(vec0), j(xt), j(yt), j(mask), j(x), j(y), method=method, k=5,
        opts=opts, row_offset=off, interpret=True))
    vec, xb, yb, m, xs, ys = _torch(vec0, xt, yt, mask, x, y)
    assert point_megakernel_cuda(vec, xb, yb, m, xs, ys, method=method, k=5,
                                 opts=opts, row_offset=off) is vec
    np.testing.assert_allclose(vec.numpy(), want, atol=1e-5)


def test_plain_bf16_is_bit_equal_to_f32_on_integer_features():
    """Integers in [-8, 8] are exact in bf16 and every product is exact in
    f32, so the bf16 cross term changes no bit of any output."""
    x, y, xt, yt = _problem(64, 4, seed=11, integer=True)
    xb, yb, m, xs, ys = _torch(xt, yt, _mask(4, 4), x, y)
    out = {}
    for cd in ("float32", "bfloat16"):
        acc, diag = torch.zeros(64, 64), torch.zeros(64)
        sti_megakernel_plain(acc, diag, xb, yb, m, xs, ys, k=5,
                             compute_dtype=cd)
        vec = point_megakernel_plain(torch.zeros(64), xb, yb, m, xs, ys,
                                     method="wknn", k=5, compute_dtype=cd)
        out[cd] = (acc, diag, vec)
    for a, b in zip(out["float32"], out["bfloat16"]):
        assert torch.equal(a, b)


def test_plain_bf16_rounds_only_the_cross_term(jx):
    """On continuous data the bf16 distances are the JAX kernel's: norms
    from the f32 inputs, cross term on bf16 operands (within 1e-5)."""
    x, y, xt, yt = _problem(32, 4, seed=12)
    d2s, _ = megakernel_rank_phase_plain(torch.from_numpy(xt),
                                         torch.from_numpy(x),
                                         compute_dtype="bfloat16")
    jnp = jx.jnp
    xb, xs = jnp.asarray(xt), jnp.asarray(x)
    cross = jnp.dot(xb.astype(jnp.bfloat16), xs.astype(jnp.bfloat16).T,
                    preferred_element_type=jnp.float32)
    want = jnp.maximum(jnp.sum(xb * xb, -1, keepdims=True) - 2.0 * cross
                       + jnp.sum(xs * xs, -1)[None, :], 0.0)
    np.testing.assert_allclose(d2s.numpy(), np.sort(np.asarray(want), -1),
                               rtol=1e-5, atol=1e-5)


def test_megakernel_static_keeps_only_its_knobs():
    assert megakernel_static({"compute_dtype": "bfloat16", "block_t": 4,
                              "chunk": 2}) == (("compute_dtype", "bfloat16"),)
    assert megakernel_static(None) == ()


@pytest.mark.parametrize("case", ["acc_shape", "row_block", "dtype",
                                  "method", "labels"])
def test_megakernel_wrappers_check_arguments(case):
    """Non-CPU tensors are checked before any build or launch (meta
    tensors stand in for CUDA ones here)."""
    m = torch.device("meta")
    n, tb, d = 16, 4, 3
    acc, diag = torch.empty(n, n, device=m), torch.empty(n, device=m)
    xb, xs = torch.empty(tb, d, device=m), torch.empty(n, d, device=m)
    yb = torch.empty(tb, dtype=torch.int32, device=m)
    ys = torch.empty(n, dtype=torch.int32, device=m)
    mask = torch.empty(tb, device=m)
    kw = dict(k=3, mode="sti")
    err = ValueError
    if case == "acc_shape":
        acc = torch.empty(n, n + 1, device=m)
    elif case == "row_block":
        acc, diag = torch.empty(8, n, device=m), torch.empty(8, device=m)
        kw["row_offset"] = 12
    elif case == "dtype":
        diag, err = torch.empty(n, dtype=torch.float64, device=m), TypeError
    elif case == "labels":
        ys, err = torch.empty(n, device=m), TypeError
    if case == "method":
        with pytest.raises(ValueError, match="no table phase"):
            point_megakernel_cuda(diag, xb, yb, mask, xs, ys, method="shap",
                                  k=3)
        return
    with pytest.raises(err):
        sti_megakernel_cuda(acc, diag, xb, yb, mask, xs, ys, **kw)


def test_wrappers_take_the_plain_version_on_cpu():
    x, y, xt, yt = _problem(20, 3, seed=4)
    xb, yb, m, xs, ys = _torch(xt, yt, _mask(3, 3), x, y)
    before = (sti_megakernel_cuda.launches, point_megakernel_cuda.launches,
              megakernel_rank_phase_cuda.launches)
    a1, d1 = sti_megakernel_cuda(torch.zeros(20, 20), torch.zeros(20), xb,
                                 yb, m, xs, ys, k=3)
    a2, d2 = sti_megakernel_plain(torch.zeros(20, 20), torch.zeros(20), xb,
                                  yb, m, xs, ys, k=3)
    assert torch.equal(a1, a2) and torch.equal(d1, d2)
    v1 = point_megakernel_cuda(torch.zeros(20), xb, yb, m, xs, ys,
                               method="loo", k=3)
    v2 = point_megakernel_plain(torch.zeros(20), xb, yb, m, xs, ys,
                                method="loo", k=3)
    assert torch.equal(v1, v2)
    for a, b in zip(megakernel_rank_phase_cuda(xb, xs),
                    megakernel_rank_phase_plain(xb, xs)):
        assert torch.equal(a, b)
    assert (sti_megakernel_cuda.launches, point_megakernel_cuda.launches,
            megakernel_rank_phase_cuda.launches) == before


def test_build_target_hashes_the_included_headers(monkeypatch, tmp_path):
    """A changed `csrc/*.cuh` header renames the library, so a stale build
    is never reused; headers outside the source's "..." includes do
    not."""
    from repro_torch.kernels import build

    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "tile.cuh"\nint f();\n')
    (tmp_path / "tile.cuh").write_text('#pragma once\n#include "x.cuh"\n')
    (tmp_path / "x.cuh").write_text("// v1\n")
    (tmp_path / "unused.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._target("k")
    (tmp_path / "unused.cuh").write_text("// v2\n")
    assert build._target("k") == first
    (tmp_path / "x.cuh").write_text("// v2\n")
    assert build._target("k") != first
    assert "sti_megakernel" in build.SOURCES


# ------------------------------------------------- the kernel's radix sort
def _sort_row(case):
    """(n,) f32 distances for one sort-model case, and the passes the case
    must take where it fixes them (None where the data decides)."""
    rng = np.random.default_rng(len(case))
    if case in _RAGGED:
        return rng.uniform(1e3, 2.5e3, _RAGGED[case]).astype(np.float32), None
    if case == "all_equal":
        return np.full(5000, 3.5, np.float32), 2
    if case == "integer_ties":  # squared distances of integer features
        x = rng.integers(-2, 3, size=(6000, 8)).astype(np.float32)
        return ((x - x[0]) ** 2).sum(1).astype(np.float32), None
    if case == "constant_byte":  # bits 8-15 equal in every key - min
        hi = rng.integers(0, 64, 9000) << 16
        lo = rng.integers(0, 256, 9000)
        hi[0] = lo[0] = 0  # the minimum: its low byte is 0
        keys = (0x40000000 + hi + (0x5A << 8) + lo).astype(np.uint32)
        return keys.view(np.float32), 2
    if case == "inf_padding":
        d2 = rng.uniform(0.0, 50.0, 7000).astype(np.float32)
        d2[rng.random(7000) < 0.1] = np.inf
        return d2, None
    if case == "neg_zero":  # -0 sorts as +0, ties by index
        d2 = rng.choice(np.array([0.0, -0.0, 1.0, 2.5], np.float32), 6000)
        return d2, None
    raise ValueError(case)


_RAGGED = {"n=1": 1, "n=tile-1": SORT_TILE - 1, "n=tile+1": SORT_TILE + 1,
           "n=65536+3": 65536 + 3}
SORT_CASES = [*_RAGGED, "all_equal", "integer_ties", "constant_byte",
              "inf_padding", "neg_zero"]


@pytest.mark.parametrize("case", SORT_CASES)
def test_sort_model_is_torch_stable_sort(case):
    """The CPU model of the kernel's tiled radix sort (`tests/_sort_tiles.py`)
    gives torch.sort(stable=True)'s order, bit for bit, and takes the
    passes `radix_passes` counts: ragged rows around the tile, equal keys,
    ties, a constant digit (its pass skipped), inf padding and -0."""
    d2, fixed = _sort_row(case)
    keys, idx, passes = radix_sort_model(d2)
    want = torch.sort(torch.from_numpy(d2), stable=True)
    np.testing.assert_array_equal(idx, want.indices.numpy())
    np.testing.assert_array_equal(keys, keys_of(want.values.numpy()))
    assert passes == int(radix_passes(torch.from_numpy(d2)[None])[0])
    if fixed is not None:
        assert passes == fixed


def test_sort_constants_match_the_cuda_source():
    """The module's sort constants, which the CPU model runs on, are the
    kernel's."""
    from pathlib import Path

    import repro_torch

    src = (Path(repro_torch.__file__).parent / "csrc" /
           "sti_megakernel.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("RADIX_BITS"), const("KPT"), const("THREADS")) == (
        RADIX_BITS, SORT_KEYS_PER_THREAD, SORT_THREADS)
    assert SORT_TILE == SORT_THREADS * SORT_KEYS_PER_THREAD


def test_rank_phase_reports_the_plain_passes_on_cpu():
    x, _, xt, _ = _problem(300, 5, seed=9, integer=True, lo=-1, hi=1)
    xb, xs = _torch(xt, x)
    d2s, order, passes = megakernel_rank_phase_cuda(xb, xs, with_passes=True)
    want = megakernel_rank_phase_plain(xb, xs)
    assert torch.equal(d2s, want[0]) and torch.equal(order, want[1])
    d2 = torch.sort(d2s, dim=-1).values  # the passes do not see the order
    assert torch.equal(passes, radix_passes(d2))
    assert passes.dtype == torch.int32 and passes.shape == (5,)


# ------------------------------------------------ fill="megakernel" end to end
def _jax_points(jx, method, x, y, xt, yt, k, tb, **kw):
    j = jx.jnp.asarray
    return np.asarray(jx.pipe.stream_point_values(
        method, j(x), j(y), j(xt), j(yt), k, test_batch=tb, **kw))


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("mode", ["sti", "sii"])
def test_interaction_megakernel_end_to_end_matches_jax(jx, n, mode):
    """t % tb != 0 (a padded batch): the port's megakernel step against the
    JAX megakernel and the JAX three-stage step, within 1e-5."""
    from repro_torch.kernels.sti_pipeline import fused_sti_knn_interactions

    t, k, tb = 11, 5, 4
    x, y, xt, yt = _problem(n, t, seed=10 + n)
    j = jx.jnp.asarray
    got = fused_sti_knn_interactions(x, y, xt, yt, k, mode=mode, test_batch=tb,
                                     fill="megakernel", device="cpu").numpy()
    for fill in ("megakernel", "chunked"):
        want = np.asarray(jx.pipe.fused_sti_knn_interactions(
            j(x), j(y), j(xt), j(yt), k=k, mode=mode, fill=fill,
            test_batch=tb))
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("method,opts", POINT_CASES)
def test_point_megakernel_end_to_end_matches_jax(jx, n, method, opts):
    from repro_torch.kernels.sti_pipeline import stream_point_values

    t, k, tb = 11, 5, 4
    x, y, xt, yt = _problem(n, t, classes=3, seed=20 + n)
    got = stream_point_values(method, x, y, xt, yt, k, test_batch=tb,
                              fill="megakernel", method_opts=opts,
                              device="cpu").numpy()
    np.testing.assert_allclose(
        got, _jax_points(jx, method, x, y, xt, yt, k, tb, fill="megakernel",
                         method_opts=opts), atol=1e-5)
    np.testing.assert_allclose(
        got, _jax_points(jx, method, x, y, xt, yt, k, tb, method_opts=opts),
        atol=1e-5)


def test_megakernel_matches_bruteforce_oracle():
    """n = 12: the megakernel step equals the O(2^n) definitions."""
    from repro_torch.core.sti_baseline import (
        brute_force_shapley, brute_force_sii, brute_force_sti,
        brute_force_wknn_shapley)
    from repro_torch.kernels.sti_pipeline import (
        fused_sti_knn_interactions, stream_point_values)

    x, y, xt, yt = _problem(12, 5, d=4, seed=7, integer=True)
    for mode, oracle in (("sti", brute_force_sti), ("sii", brute_force_sii)):
        got = fused_sti_knn_interactions(x, y, xt, yt, 3, mode=mode,
                                         fill="megakernel", test_batch=4,
                                         device="cpu")
        np.testing.assert_allclose(got.numpy(), oracle(x, y, xt, yt, 3),
                                   atol=1e-5)
    got = stream_point_values("knn_shapley", x, y, xt, yt, 3, test_batch=4,
                              fill="megakernel", device="cpu")
    np.testing.assert_allclose(got.numpy(),
                               brute_force_shapley(x, y, xt, yt, 3),
                               atol=1e-5)
    got = stream_point_values("wknn", x, y, xt, yt, 3, test_batch=4,
                              fill="megakernel", device="cpu",
                              method_opts={"weights": "inverse"})
    np.testing.assert_allclose(
        got.numpy(),
        brute_force_wknn_shapley(x, y, xt, yt, 3, weights="inverse"),
        atol=1e-5)


def test_bf16_end_to_end_is_bit_equal_on_integer_features():
    from repro_torch.kernels.sti_pipeline import (
        fused_sti_knn_interactions, stream_point_values)

    x, y, xt, yt = _problem(64, 8, seed=11, integer=True)
    bf = {"compute_dtype": "bfloat16"}
    for mode in ("sti", "sii"):
        a, b = (fused_sti_knn_interactions(
            x, y, xt, yt, 5, mode=mode, fill="megakernel", test_batch=4,
            fill_params=p, device="cpu") for p in (None, bf))
        assert torch.equal(a, b), mode
    for method, opts in POINT_CASES:
        a, b = (stream_point_values(
            method, x, y, xt, yt, 5, test_batch=4, fill="megakernel",
            fill_params=p, method_opts=opts, device="cpu") for p in (None, bf))
        assert torch.equal(a, b), method


def test_megakernel_resolution_and_registry_route():
    """"megakernel" forces the fused step and reports its distance as
    "fused"; "auto" keeps the three-stage step; the registry's fused
    engine reaches it through fill=."""
    from repro_torch import get_method
    from repro_torch.kernels.sti_pipeline import prepare_stream_step

    _, res, _ = prepare_stream_step("sti", 64, 4, 3, fill="megakernel",
                                    device="cpu")
    assert res == {"fill": "megakernel", "distance": "fused"}
    _, res, _ = prepare_stream_step("sti", 64, 4, 3, device="cpu")
    assert res == {"fill": "chunked", "distance": "plain"}
    _, res, spec = prepare_stream_step("loo", 64, 4, 3, fill="megakernel",
                                       device="cpu")
    assert res == {"fill": "megakernel", "distance": "fused"}
    assert spec.kind == "point"
    _, res, _ = prepare_stream_step("loo", 64, 4, 3, device="cpu")
    assert res == {"fill": None, "distance": "plain"}
    x, y, xt, yt = _problem(30, 6, seed=3)
    r = get_method("sii")(x, y, xt, yt, k=3, engine="fused", test_batch=4,
                          fill="megakernel", device="cpu")
    assert r.meta["fill"] == "megakernel" and r.meta["distance"] == "fused"
    want = get_method("sii")(x, y, xt, yt, k=3, test_batch=4, device="cpu")
    np.testing.assert_allclose(r.phi.numpy(), want.phi.numpy(), atol=1e-5)


def test_mid_stream_checkpoint_roundtrips_megakernel(tmp_path):
    from repro_torch.core.session import ValuationSession

    x, y, xt, yt = _problem(48, 12, seed=5)
    ref = ValuationSession(x, y, k=3, mode="sti", test_batch=4,
                           fill="chunked", device="cpu")
    want = ref.update(xt, yt).finalize().phi.numpy()
    sess = ValuationSession(x, y, k=3, mode="sti", test_batch=4,
                            fill="megakernel", device="cpu")
    sess.update(xt[:8], yt[:8])
    p = sess.checkpoint(tmp_path / "ckpt.npz")
    restored = ValuationSession.restore(p, x, y, device="cpu")
    assert restored._resolved == {"fill": "megakernel", "distance": "fused"}
    got = restored.update(xt[8:], yt[8:]).finalize().phi.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("mode", ["sti", "wknn"])
def test_megakernel_checkpoint_cross_loads_between_packages(jx, tmp_path,
                                                            mode):
    """"megakernel" round-trips as-is in both directions."""
    from repro.core.session import ValuationSession as JSession

    from repro_torch.core.session import ValuationSession

    x, y, xt, yt = _problem(40, 10, seed=6)
    attr = "phi" if mode == "sti" else "point_values"
    want = np.asarray(getattr(JSession(
        x, y, k=3, mode=mode, test_batch=4, fill="chunked",
        distance="xla").update(xt, yt).finalize(), attr))
    jsess = JSession(x, y, k=3, mode=mode, test_batch=4, fill="megakernel")
    jp = jsess.update(xt[:6], yt[:6]).checkpoint(tmp_path / "jax")
    tres = ValuationSession.restore(jp, x, y, device="cpu")
    assert tres._resolved["fill"] == "megakernel"
    got = getattr(tres.update(xt[6:], yt[6:]).finalize(), attr).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    tsess = ValuationSession(x, y, k=3, mode=mode, test_batch=4,
                             fill="megakernel", device="cpu")
    tp = tsess.update(xt[:6], yt[:6]).checkpoint(tmp_path / "port")
    jres = JSession.restore(tp, x, y)
    assert jres._resolved["fill"] == "megakernel"
    got = np.asarray(getattr(jres.update(xt[6:], yt[6:]).finalize(), attr))
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------- on the card
CUDA_SHAPES = [(4, 16, 3, 4), (11, 64, 6, 7), (33, 65, 7, 20),
               (8, 300, 5, 8), (5, 1000, 768, 5)]


def _cuda_problem(cuda, t, n, d, real, integer, seed, lo=-8, hi=8):
    """Kernel-vs-plain comparisons use integer features: their distances
    are exact on both sides, so the ranks (ties included) must agree and
    only the order of float sums differs. On continuous data the plain
    version's cuBLAS product rounds otherwise than the kernel's FMA chain
    and may swap near-equal neighbours."""
    x, y, xt, yt = _problem(n, t, d=d, classes=3, seed=seed,
                            integer=integer, lo=lo, hi=hi)
    return _torch(xt, yt, _mask(t, real), x, y, device=cuda)


def _close(got, want):
    """Within 1e-6 of the largest |value| (rounding only): the kernel's
    suffix scans add in another order than torch.cumsum. The state starts
    at zero, so that scale is the steps' own increment."""
    tol = 1e-6 * max(float(want.abs().max()), 1e-6)
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sti", "sii"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,n,d,real", CUDA_SHAPES)
@pytest.mark.parametrize("lo,hi", [(-8, 8), (-2, 2)])
def test_cuda_sti_megakernel_matches_plain(cuda, mode, cd, t, n, d, real,
                                           lo, hi):
    """Two steps from zero, so the second adds into what the first left."""
    xb, yb, m, xs, ys = _cuda_problem(cuda, t, n, d, real, True, n + t, lo,
                                      hi)
    kw = dict(k=5, mode=mode, compute_dtype=cd)
    before = sti_megakernel_cuda.launches
    acc, diag = torch.zeros((n, n), device=cuda), torch.zeros(n, device=cuda)
    want = torch.zeros((n, n), device=cuda), torch.zeros(n, device=cuda)
    for _ in range(2):
        sti_megakernel_cuda(acc, diag, xb, yb, m, xs, ys, **kw)
        sti_megakernel_plain(*want, xb, yb, m, xs, ys, **kw)
    assert sti_megakernel_cuda.launches == before + 2
    torch.cuda.synchronize()
    _close(acc, want[0])
    _close(diag, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sti", "sii"])
@pytest.mark.parametrize("off,nr", [(0, 100), (130, 170), (256, 44)])
def test_cuda_sti_megakernel_row_block(cuda, mode, off, nr):
    xb, yb, m, xs, ys = _cuda_problem(cuda, 9, 300, 5, 7, True, 3)
    acc, diag = torch.zeros(nr, 300, device=cuda), torch.zeros(nr,
                                                               device=cuda)
    sti_megakernel_cuda(acc, diag, xb, yb, m, xs, ys, k=3, mode=mode,
                        row_offset=off)
    full = sti_megakernel_plain(torch.zeros(300, 300, device=cuda),
                                torch.zeros(300, device=cuda), xb, yb, m, xs,
                                ys, k=3, mode=mode)
    torch.cuda.synchronize()
    _close(acc, full[0][off:off + nr])
    _close(diag, full[1][off:off + nr])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sti", "sii"])
@pytest.mark.parametrize("off,nr", [(0, 600), (128, 300), (256, 344),
                                    (77, 200), (384, 100)])
def test_cuda_sti_megakernel_row_offsets_on_a_live_block(cuda, mode, off,
                                                         nr):
    """Row blocks at aligned offsets (the window's diagonal square
    mirrored, the whole square at 0) and a misaligned one: from zero
    within 1e-6 of the plain version at the same offset, and on a
    non-symmetric live block exactly that block plus the increment, so
    each element is read and written once; the whole square's increment
    is exactly symmetric."""
    n = 600
    xb, yb, m, xs, ys = _cuda_problem(cuda, 19, n, 8, 17, True, off + nr)
    kw = dict(k=3, mode=mode, row_offset=off)
    zero = torch.zeros(nr, n, device=cuda), torch.zeros(nr, device=cuda)
    want = torch.zeros(nr, n, device=cuda), torch.zeros(nr, device=cuda)
    sti_megakernel_cuda(*zero, xb, yb, m, xs, ys, **kw)
    sti_megakernel_plain(*want, xb, yb, m, xs, ys, **kw)
    gen = torch.Generator(cuda).manual_seed(off)
    live0 = (torch.randn((nr, n), generator=gen, device=cuda),
             torch.randn((nr,), generator=gen, device=cuda))
    live = tuple(x.clone() for x in live0)
    sti_megakernel_cuda(*live, xb, yb, m, xs, ys, **kw)
    torch.cuda.synchronize()
    _close(zero[0], want[0])
    _close(zero[1], want[1])
    assert torch.equal(live[0], live0[0] + zero[0])
    assert torch.equal(live[1], live0[1] + zero[1])
    if nr == n:
        assert torch.equal(zero[0], zero[0].T)


@pytest.mark.cuda
@pytest.mark.parametrize("method,opts", POINT_CASES)
@pytest.mark.parametrize("t,n,d,real", CUDA_SHAPES + [
    (9, SORT_TILE, 16, 9), (9, 2 * SORT_TILE + 1, 16, 7)])
@pytest.mark.parametrize("row_block", [None, (40, 30)])
def test_cuda_point_megakernel_matches_plain(cuda, method, opts, t, n, d,
                                             real, row_block):
    xb, yb, m, xs, ys = _cuda_problem(cuda, t, n, d, real, True, 7 * n)
    off, nr = row_block or (None, n)
    if nr > n or (off or 0) + nr > n:
        pytest.skip("row block wider than the train set")
    kw = dict(method=method, k=5, opts=opts, row_offset=off)
    before = point_megakernel_cuda.launches
    got, want = torch.zeros(nr, device=cuda), torch.zeros(nr, device=cuda)
    for _ in range(2):  # the second step adds into what the first left
        point_megakernel_cuda(got, xb, yb, m, xs, ys, **kw)
        point_megakernel_plain(want, xb, yb, m, xs, ys, **kw)
    assert point_megakernel_cuda.launches == before + 2
    torch.cuda.synchronize()
    _close(got, want)


@pytest.mark.cuda
def test_cuda_empty_batch_launches_nothing(cuda):
    """A step with no test points has nothing to do: it leaves the state
    as it was and counts no launch."""
    xb, yb, m, xs, ys = _cuda_problem(cuda, 4, 16, 3, 4, True, 1)
    acc, diag, vec = (torch.ones((16, 16), device=cuda),
                      torch.ones(16, device=cuda), torch.ones(16, device=cuda))
    before = (sti_megakernel_cuda.launches, point_megakernel_cuda.launches)
    sti_megakernel_cuda(acc, diag, xb[:0], yb[:0], m[:0], xs, ys, k=3)
    point_megakernel_cuda(vec, xb[:0], yb[:0], m[:0], xs, ys,
                          method="knn_shapley", k=3)
    torch.cuda.synchronize()
    assert (sti_megakernel_cuda.launches,
            point_megakernel_cuda.launches) == before
    assert bool((acc == 1).all() and (diag == 1).all() and (vec == 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,d,lo,hi,rows", [
    (4, 16, 3, -2, 2, "drawn"), (33, 65, 7, -2, 2, "drawn"),
    (16, 5000, 8, -2, 2, "drawn"), (8, 3000, 768, -8, 8, "drawn"),
    (7, SORT_TILE - 1, 16, -2, 2, "drawn"),
    (7, SORT_TILE + 1, 16, -2, 2, "drawn"),
    (9, 5000, 16, -8, 8, "equal_rows"), (9, 6001, 16, -8, 8, "one_value"),
])
def test_cuda_rank_phase_is_a_stable_sort(cuda, t, n, d, lo, hi, rows):
    """Tie-heavy integer features: the sorted stream is bit-equal to
    torch.sort(stable=True) of distance_cuda's d2, and bf16 gives the same
    bits as f32 (integers in [-8, 8] are exact in bf16); each row takes
    the passes `radix_passes` counts. Rows below one sort tile and one past
    it, every test row the same point ("equal_rows"), and rows of a single
    value (every train point the same, "one_value": the two passes that
    every row takes at the least)."""
    xb, _, _, xs, _ = _cuda_problem(cuda, t, n, d, t, True, n, lo, hi)
    if rows == "equal_rows":
        xb = xb[:1].repeat(t, 1)
    elif rows == "one_value":
        xs = xs[:1].repeat(n, 1)
    want = torch.sort(distance_cuda(xb, xs), dim=-1, stable=True)
    for cd in ("float32", "bfloat16"):
        d2s, order, passes = megakernel_rank_phase_cuda(
            xb, xs, compute_dtype=cd, with_passes=True)
        torch.cuda.synchronize()
        assert torch.equal(order, want.indices), cd
        assert torch.equal(d2s, want.values), cd
        assert torch.equal(passes, radix_passes(want.values)), cd
    if rows == "one_value":
        assert bool((passes == 2).all())


@pytest.mark.cuda
def test_cuda_rank_phase_matches_distance_kernel_on_continuous_data(cuda):
    """The megakernel's f32 distances are distance_cuda's bits, so even
    near-ties on continuous data order identically."""
    xb, _, _, xs, _ = _cuda_problem(cuda, 37, 4099, 768, 37, False, 5)
    want = torch.sort(distance_cuda(xb, xs), dim=-1, stable=True)
    d2s, order = megakernel_rank_phase_cuda(xb, xs)
    torch.cuda.synchronize()
    assert torch.equal(order, want.indices)
    assert torch.equal(d2s, want.values)


@pytest.mark.cuda
def test_cuda_bf16_rounds_the_cross_term_on_continuous_data(cuda):
    """bf16 on continuous data: the sorted distances equal the plain bf16
    ones within 1e-5 of the largest (a near-tie may swap two neighbours,
    which leaves the sorted values in place) and differ from f32."""
    xb, _, _, xs, _ = _cuda_problem(cuda, 16, 2000, 768, 16, False, 8)
    got, _ = megakernel_rank_phase_cuda(xb, xs, compute_dtype="bfloat16")
    want, _ = megakernel_rank_phase_plain(xb, xs, compute_dtype="bfloat16")
    f32, _ = megakernel_rank_phase_cuda(xb, xs)
    torch.cuda.synchronize()
    _close(got, want)
    # bf16 operands move d2 by ~3e-4 of its size here: ten times the
    # tolerance above, so the rounding is seen, not a summation order
    assert float((got - f32).abs().max()) > 1e-4 * float(f32.abs().max())
