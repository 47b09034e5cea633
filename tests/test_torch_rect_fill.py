"""The port's rectangular fill (`repro_torch.kernels.sti_fill` rect forms
and the rect registries of `repro_torch.core.sti_knn`) against the JAX
package.

On the CPU: the plain rect fill is held against the Pallas rect kernels
in interpret mode and against `repro.core.sti_knn._rect_fill_xla` within
1e-6 (the repo's fill tolerance) -- ragged shapes, independent row and
column tables, `rect_row_view` windows and a `block_rows` that does not
divide the row count on the JAX side -- the wrappers' argument checks
and window detection run on meta tensors, and a copy of the kernel's tile
walk is held to write every element of a row block once (its window's
diagonal square mirrored at aligned offsets). On a CUDA card (tests
marked `cuda`, skipped elsewhere; each under a watchdog) the CUDA rect
kernel is held against its plain version. Run those on a card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_rect_fill.py -q

The JAX-side tests skip where JAX is not installed (the card's machine).
"""

import faulthandler
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import sti_knn as tcore
from repro_torch.kernels import build
from repro_torch.kernels import sti_fill as tfill
from repro_torch.kernels.sti_fill import (
    TILE,
    rect_row_view,
    row_window,
    sti_fill_acc_plain,
    sti_fill_acc_rect_cuda,
    sti_fill_acc_rect_plain,
    sti_fill_plain,
    sti_fill_rect_cuda,
    sti_fill_rect_plain,
)

from _fill_tiles import emulate_fill, write_counts

# (t, n_rows, n_cols, n, block_rows, block_cols, block_t): n is g's width
# (every rank < n); block sizes are the Pallas kernel's, ragged on purpose
RECT_SHAPES = [
    (4, 8, 16, 16, 8, 8, 2),
    (7, 5, 33, 33, 3, 16, 3),     # block_rows 3 does not divide 5
    (5, 12, 37, 40, 8, 16, 2),    # nc < n: independent tables
    (6, 33, 20, 70, 16, 8, 4),    # nr > nc, g wider than both
    (3, 64, 64, 64, 32, 64, 1),
]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's rect kernels and fills (skips where JAX is
    absent)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import sti_knn as jcore
    from repro.kernels import sti_fill as jfill

    return types.SimpleNamespace(jnp=jnp, core=jcore, fill=jfill)


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


def _rect_problem(t, nr, nc, n, seed):
    """g (t, n), independent row and column rank tables with every rank
    < n (ties across the two tables included), and an (nr, nc) acc."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(t, n)).astype(np.float32)
    rr = rng.integers(0, n, (t, nr)).astype(np.int32)
    rc = rng.integers(0, n, (t, nc)).astype(np.int32)
    acc = rng.normal(size=(nr, nc)).astype(np.float32)
    return g, rr, rc, acc


def _perm_problem(t, n, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(t, n)).astype(np.float32)
    ranks = np.stack([rng.permutation(n) for _ in range(t)]).astype(np.int64)
    return g, ranks


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


# ------------------------------------------------------------ CPU parity
@pytest.mark.parametrize("t,nr,nc,n,br,bc,bt", RECT_SHAPES)
def test_plain_rect_fill_matches_pallas_and_xla(jx, t, nr, nc, n, br, bc,
                                                bt):
    """Zero-init form against `sti_fill_rect_pallas` (interpret mode) and
    the JAX and port "xla" rect oracles, within 1e-6: the sums over p run
    in another order."""
    g, rr, rc, _ = _rect_problem(t, nr, nc, n, seed=t * 1000 + nr + nc)
    got = sti_fill_rect_plain(torch.from_numpy(g), torch.from_numpy(rr),
                              torch.from_numpy(rc)).numpy()
    jg, jrr, jrc = (jx.jnp.asarray(a) for a in (g, rr, rc))
    pallas = jx.fill.sti_fill_rect_pallas(
        jg, jrr, jrc, block_rows=br, block_cols=bc, block_t=bt,
        interpret=True)
    _close(got, pallas)
    _close(got, jx.core._rect_fill_xla(jg, jrr, jrc))
    port_xla = tcore._rect_fill_xla(torch.from_numpy(g), torch.from_numpy(rr),
                                    torch.from_numpy(rc))
    _close(port_xla.numpy(), jx.core._rect_fill_xla(jg, jrr, jrc))


@pytest.mark.parametrize("t,nr,nc,n,br,bc,bt", RECT_SHAPES[:3])
def test_plain_acc_rect_fill_matches_pallas_in_place(jx, t, nr, nc, n, br,
                                                     bc, bt):
    """The accumulate form adds into the caller's (nr, nc) tensor and
    returns it; equal to the aliased Pallas rect kernel within 1e-6."""
    g, rr, rc, acc0 = _rect_problem(t, nr, nc, n, seed=7 * nr + nc + t)
    acc = torch.from_numpy(acc0.copy())
    out = sti_fill_acc_rect_plain(acc, torch.from_numpy(g),
                                  torch.from_numpy(rr), torch.from_numpy(rc))
    assert out is acc
    want = jx.fill.sti_fill_acc_rect_pallas(
        *(jx.jnp.asarray(a) for a in (acc0, g, rr, rc)), block_rows=br,
        block_cols=bc, block_t=bt, interpret=True)
    _close(acc.numpy(), want)


@pytest.mark.parametrize("t,nr,nc,n,br,bc", [
    (4, 8, 16, 16, 8, 8), (7, 5, 33, 33, 3, 16), (5, 12, 37, 40, 8, 16)])
def test_plain_acc_rect_order_is_the_pallas_acc_kernels(jx, t, nr, nc, n,
                                                       br, bc):
    """With block_t >= t the Pallas rect acc kernel adds the tile's sum
    over p, taken from zero, to the seeded output once: the plain
    version's order. Held to 1e-6, and bit-equal on this CPU."""
    g, rr, rc, acc0 = _rect_problem(t, nr, nc, n, seed=3 * nr + nc)
    acc = sti_fill_acc_rect_plain(torch.from_numpy(acc0.copy()),
                                  torch.from_numpy(g), torch.from_numpy(rr),
                                  torch.from_numpy(rc))
    want = np.asarray(jx.fill.sti_fill_acc_rect_pallas(
        *(jx.jnp.asarray(a) for a in (acc0, g, rr, rc)), block_rows=br,
        block_cols=bc, block_t=t, interpret=True))
    _close(acc.numpy(), want)
    np.testing.assert_array_equal(acc.numpy(), want)


@pytest.mark.parametrize("chunk", [1, 3])
def test_chunked_rect_fills_match_jax(jx, chunk):
    """The port's chunked rect scan (zero-init and in place) against the
    JAX package's, within 1e-6."""
    g, rr, rc, acc0 = _rect_problem(9, 6, 21, 25, seed=chunk)
    tg, trr, trc = (torch.from_numpy(a) for a in (g, rr, rc))
    jg, jrr, jrc = (jx.jnp.asarray(a) for a in (g, rr, rc))
    _close(tcore._rect_fill_chunked(tg, trr, trc, chunk=chunk).numpy(),
           jx.core._rect_fill_chunked(jg, jrr, jrc, chunk=chunk))
    acc = torch.from_numpy(acc0.copy())
    assert tcore._rect_acc_fill_chunked(acc, tg, trr, trc,
                                        chunk=chunk) is acc
    _close(acc.numpy(), jx.core._rect_acc_fill_chunked(
        jx.jnp.asarray(acc0), jg, jrr, jrc, chunk=chunk))


@pytest.mark.parametrize("n,shards", [(64, 8), (60, 4), (37, 1)])
def test_row_windows_match_jax_and_the_square_fill(jx, n, shards):
    """Each shard's `rect_row_view` window is the JAX window, and the rect
    fill of a window against the whole table gives the bits of the same
    rows of the square fill (the same adds in the same order), which is
    what the sharded engine's row blocks rely on. The last shard's block
    is also held against the Pallas rect kernel on the JAX window."""
    g, ranks = _perm_problem(6, n, seed=n)
    tg, tr = torch.from_numpy(g), torch.from_numpy(ranks)
    square = sti_fill_plain(tg, tr)
    nl = n // shards
    for i in range(shards):
        rows = rect_row_view(tr, i * nl, nl)
        jrows = jx.fill.rect_row_view(jx.jnp.asarray(ranks), i * nl, nl)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
        block = sti_fill_rect_plain(tg, rows, tr)
        assert torch.equal(block, square[i * nl:(i + 1) * nl])
    _close(block.numpy(), jx.fill.sti_fill_rect_pallas(
        jx.jnp.asarray(g), jrows, jx.jnp.asarray(ranks), block_rows=8,
        block_cols=16, interpret=True))


def test_rect_with_equal_tables_is_the_square_fill():
    g, ranks = _perm_problem(5, 30, seed=3)
    tg, tr = torch.from_numpy(g), torch.from_numpy(ranks)
    acc0 = torch.randn(30, 30, generator=torch.Generator().manual_seed(0))
    a = sti_fill_acc_rect_plain(acc0.clone(), tg, tr, tr)
    b = sti_fill_acc_plain(acc0.clone(), tg, tr)
    assert torch.equal(a, b)


def test_rect_row_view_is_a_window_and_checks_bounds():
    r = torch.arange(40).reshape(4, 10)
    v = rect_row_view(r, 3, 5)
    assert v.data_ptr() == r[:, 3].data_ptr()
    assert torch.equal(v, r[:, 3:8])
    assert rect_row_view(r, 10, 0).shape == (4, 0)
    for off, cnt in ((-1, 2), (8, 3)):
        with pytest.raises(ValueError, match="row window"):
            rect_row_view(r, off, cnt)


# ----------------------------------------------- the kernel's tile walk
@pytest.mark.parametrize("n", [1024, 1000])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_row_window_tile_walk_writes_each_element_once(n, shards):
    """Every shard's (n/D, n) block at its row offset: each element is
    written exactly once, and an offset that is a multiple of 128 computes
    only the upper triangle of the window's diagonal square."""
    nl = n // shards
    for i in range(shards):
        off = i * nl
        tiles, counts = write_counts(nl, n, off)
        assert counts.min() == 1 and counts.max() == 1
        tr, tc = -(-nl // TILE), -(-n // TILE)
        want = (tr * (tr + 1) // 2 + tr * (tc - tr) if off % TILE == 0
                else tr * tc)
        assert tiles == want


@pytest.mark.parametrize("nr,nc,off", [(300, 1000, 77), (130, 260, 130),
                                       (40, 300, -1), (129, 129, -1)])
def test_unmirrored_tile_walks_write_each_element_once(nr, nc, off):
    """A misaligned window and independent tables compute every tile
    where it lies, none mirrored."""
    tiles, counts = write_counts(nr, nc, off)
    assert counts.min() == 1 and counts.max() == 1
    assert tiles == -(-nr // TILE) * -(-nc // TILE)
    assert all(m is None for *_, m in tfill.fill_tile_walk(nr, nc, off))


@pytest.mark.parametrize("t,nr,n,off", [(5, 200, 600, 256), (9, 130, 300, 0),
                                        (4, 100, 300, 77), (6, 300, 300, 0)])
def test_row_window_tile_walk_gives_the_plain_bits(t, nr, n, off):
    """A numpy copy of the kernel's dataflow on a row window gives the
    plain rect fill's bits on a non-symmetric accumulator."""
    g, ranks = _perm_problem(t, n, seed=nr + off)
    g = g.astype(np.float32)
    acc0 = np.random.default_rng(off).normal(size=(nr, n)).astype(np.float32)
    got = emulate_fill(acc0.copy(), g, ranks[:, off:off + nr], ranks, off)
    tr = torch.from_numpy(ranks)
    want = sti_fill_acc_rect_plain(torch.from_numpy(acc0.copy()),
                                   torch.from_numpy(g),
                                   rect_row_view(tr, off, nr), tr)
    np.testing.assert_array_equal(got, want.numpy())


def test_row_window_detects_views_of_the_column_table():
    r = torch.arange(60).reshape(4, 15)
    assert row_window(rect_row_view(r, 5, 7), r) == 5
    assert row_window(r, r) == 0
    assert row_window(rect_row_view(r, 0, 15), r) == 0
    assert row_window(rect_row_view(r, 5, 7).clone(), r) == -1
    assert row_window(rect_row_view(r, 5, 7).to(torch.int32), r) == -1
    assert row_window(r[:, 1::2], r) == -1
    assert row_window(r[1:, 2:6], r[:3]) == -1  # a shift of test points
    assert row_window(rect_row_view(r, 2, 7), r[:, 3:]) == -1  # before it


@pytest.mark.parametrize("case,want", [
    ("window", 48), ("whole", 0), ("copy", -1), ("dtype", -1),
    ("stride", -1)])
def test_rect_wrapper_passes_the_window_offset(monkeypatch, case, want):
    """A spy on the C call: a `rect_row_view` passes its column offset,
    decided before the int32 cast; a copy, another dtype or another
    stride passes -1 (and then the row table of its own)."""
    m = torch.device("meta")
    t, n = 3, 96
    cols = torch.empty(t, n, dtype=torch.int64, device=m)
    rows = {"window": rect_row_view(cols, 48, 40), "whole": cols,
            "copy": rect_row_view(cols, 48, 40).clone(),
            "dtype": rect_row_view(cols, 48, 40).to(torch.int32),
            "stride": cols[:, ::2]}[case]
    calls = []
    monkeypatch.setattr(tfill, "_launch",
                        lambda name, argtypes, *args, dev: calls.append(
                            (name, len(argtypes), args)))
    acc = torch.empty(rows.shape[1], n, device=m)
    before = sti_fill_acc_rect_cuda.launches
    out = sti_fill_acc_rect_cuda(acc, torch.empty(t, n, device=m), rows,
                                 cols)
    assert out is acc and sti_fill_acc_rect_cuda.launches == before + 1
    [(name, nargs, args)] = calls
    assert name == "sti_fill_acc_rect_f32" and nargs == len(args) == 12
    assert args[-1] == want
    assert args[6:10] == (t, n, rows.shape[1], n)
    if want >= 0:
        assert args[2] is None and args[4] is None  # no row table of its own


@pytest.mark.parametrize("rows", ["window", "strided", "int32"])
def test_rect_wrapper_takes_row_table_views_on_cpu(rows):
    """A row table that is a window, a strided view or an int32 copy of
    the column table gives the bits of its contiguous int64 copy."""
    g, ranks = _perm_problem(6, 40, seed=11)
    tg, tr = torch.from_numpy(g), torch.from_numpy(ranks).long()
    view = {"window": rect_row_view(tr, 12, 20), "strided": tr[:, ::2],
            "int32": rect_row_view(tr, 12, 20).to(torch.int32)}[rows]
    got = sti_fill_rect_cuda(tg, view, tr)
    assert torch.equal(got, sti_fill_rect_plain(tg, view.long().clone(), tr))


# ------------------------------------------------------------ registries
def test_rect_registries_hold_every_name():
    g, rr, rc, acc0 = _rect_problem(5, 7, 13, 13, seed=11)
    tg, trr, trc = (torch.from_numpy(a) for a in (g, rr, rc))
    want = sti_fill_acc_rect_plain(torch.from_numpy(acc0.copy()), tg, trr,
                                   trc)
    assert set(tcore._RECT_FILL_FNS) >= {"xla", "chunked", "cuda"}
    assert set(tcore._RECT_ACC_FILL_FNS) >= {"chunked", "cuda"}
    for name in tcore._RECT_FILL_FNS:
        acc = torch.from_numpy(acc0.copy())
        out = tcore.accumulate_rect_fill(acc, tg, trr, trc, name)
        assert out is acc
        _close(acc.numpy(), want.numpy())


def test_resolve_rect_fill():
    assert tcore.resolve_rect_fill("auto", 8, 64, 16, backend="cpu") == (
        "chunked", (("chunk", 1),))
    assert tcore.resolve_rect_fill("auto", 8, 64, 16, backend="cuda") == (
        "cuda", ())
    assert tcore.resolve_rect_fill("chunked", 8, 64, 16,
                                   fill_params={"chunk": 4}) == (
        "chunked", (("chunk", 4),))
    # "auto" drops hints its winner does not take; a name rejects them
    assert tcore.resolve_rect_fill("auto", 8, 64, 16, backend="cuda",
                                   fill_params={"chunk": 2}) == ("cuda", ())
    with pytest.raises(ValueError, match="does not accept"):
        tcore.resolve_rect_fill("cuda", 8, 64, 16, fill_params={"chunk": 2})
    with pytest.raises(ValueError, match="unknown rect fill"):
        tcore.resolve_rect_fill("nope", 8, 64, 16)
    # a square name with no rect twin runs the chunked rect scan
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert tcore.resolve_rect_fill("onehot", 8, 64, 16)[0] == "chunked"
    assert any("no rectangular variant" in str(w.message) for w in caught)


# ------------------------------------------------- wrappers on the CPU
def test_rect_wrappers_take_the_plain_version_on_cpu():
    g, rr, rc, acc0 = _rect_problem(6, 9, 20, 20, seed=2)
    tg, trr, trc = (torch.from_numpy(a) for a in (g, rr, rc))
    before = sti_fill_acc_rect_cuda.launches
    acc = torch.from_numpy(acc0.copy())
    assert sti_fill_acc_rect_cuda(acc, tg, trr, trc) is acc
    assert torch.equal(acc, sti_fill_acc_rect_plain(
        torch.from_numpy(acc0.copy()), tg, trr, trc))
    assert torch.equal(sti_fill_rect_cuda(tg, trr, trc),
                       sti_fill_rect_plain(tg, trr, trc))
    assert sti_fill_acc_rect_cuda.launches == before


@pytest.mark.parametrize("case", ["acc_shape", "rows_t", "cols_t", "g_dtype",
                                  "float_ranks", "device", "dims"])
def test_rect_wrapper_checks_arguments(case):
    """Non-CPU tensors are checked before any build or launch (meta
    tensors stand in for CUDA ones here)."""
    m = torch.device("meta")
    acc = torch.empty(4, 10, device=m)
    g = torch.empty(3, 12, device=m)
    rr = torch.empty(3, 4, dtype=torch.int64, device=m)
    rc = torch.empty(3, 10, dtype=torch.int64, device=m)
    err = ValueError
    if case == "acc_shape":
        acc = torch.empty(10, 4, device=m)
    elif case == "rows_t":
        rr = torch.empty(2, 4, dtype=torch.int64, device=m)
    elif case == "cols_t":
        rc = torch.empty(4, 10, dtype=torch.int64, device=m)
    elif case == "g_dtype":
        g, err = g.to(torch.float64), TypeError
    elif case == "float_ranks":
        rr, err = torch.empty(3, 4, device=m), TypeError
    elif case == "dims":
        rc = torch.empty(3, 10, 1, dtype=torch.int64, device=m)
    else:
        g = torch.empty(3, 12)
    with pytest.raises(err):
        sti_fill_acc_rect_cuda(acc, g, rr, rc)


def test_rect_wrapper_does_not_fall_back_without_nvcc(monkeypatch, tmp_path):
    """Without nvcc a non-CPU tensor raises: nothing falls back to the
    plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernels build and launch there")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    m = torch.device("meta")
    before = sti_fill_acc_rect_cuda.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        sti_fill_acc_rect_cuda(
            torch.empty(4, 10, device=m), torch.empty(3, 10, device=m),
            torch.empty(3, 4, dtype=torch.int64, device=m),
            torch.empty(3, 10, dtype=torch.int64, device=m))
    assert sti_fill_acc_rect_cuda.launches == before


# ---------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("t,nr,nc,n", [(4, 8, 16, 16), (33, 40, 65, 70),
                                       (7, 130, 33, 33), (17, 300, 129, 300)])
def test_cuda_rect_fill_independent_tables(cuda, t, nr, nc, n):
    """Independent row and column tables (two gathers): the kernel adds
    the test points in the plain version's order, so 1e-6 admits only
    rounding."""
    g, rr, rc, acc0 = _rect_problem(t, nr, nc, n, seed=t + nr + nc)
    tg, trr, trc = (torch.from_numpy(a).to(cuda) for a in (g, rr, rc))
    before = sti_fill_acc_rect_cuda.launches
    acc = torch.from_numpy(acc0).to(cuda)
    assert sti_fill_acc_rect_cuda(acc, tg, trr, trc) is acc
    assert sti_fill_acc_rect_cuda.launches == before + 1
    want = sti_fill_acc_rect_plain(torch.from_numpy(acc0).to(cuda), tg, trr,
                                   trc)
    torch.cuda.synchronize()
    torch.testing.assert_close(acc, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sti_fill_rect_cuda(tg, trr.long(), trc),
                               sti_fill_rect_plain(tg, trr, trc),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,shards", [(16, 256, 8), (33, 200, 4),
                                        (256, 1000, 1), (5, 300, 3)])
def test_cuda_rect_fill_row_windows(cuda, t, n, shards):
    """Row windows of one table: each shard's block equals
    the plain rect fill, and the same rows of the square kernel, to the
    bit."""
    g, ranks = _perm_problem(t, n, seed=n + t)
    tg, tr = torch.from_numpy(g).to(cuda), torch.from_numpy(ranks).to(cuda)
    square = sti_fill_plain(tg, tr)
    nl = n // shards
    for i in range(shards):
        rows = rect_row_view(tr, i * nl, nl)
        got = sti_fill_rect_cuda(tg, rows, tr)
        want = sti_fill_rect_plain(tg, rows, tr)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(got, square[i * nl:(i + 1) * nl])


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,off,nr", [(37, 1000, 77, 300),
                                        (20, 4099, 1024, 2048),
                                        (16, 520, 384, 136)])
def test_cuda_rect_fill_windows_on_a_live_block(cuda, t, n, off, nr):
    """A misaligned window (every tile computed) and aligned ones (the
    window's diagonal square mirrored, ragged at its last tile), on a
    non-symmetric accumulator: bit-equal to the plain version, and to the
    block's zero-init increment added to it."""
    g, ranks = _perm_problem(t, n, seed=off + nr)
    tg, tr = torch.from_numpy(g).to(cuda), torch.from_numpy(ranks).to(cuda)
    rows = rect_row_view(tr, off, nr)
    acc0 = torch.randn((nr, n), generator=torch.Generator(cuda).manual_seed(
        off), device=cuda)
    got = sti_fill_acc_rect_cuda(acc0.clone(), tg, rows, tr)
    want = sti_fill_acc_rect_plain(acc0.clone(), tg, rows, tr)
    zero = sti_fill_rect_cuda(tg, rows, tr)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, acc0 + zero)


@pytest.mark.cuda
def test_cuda_rect_window_and_copy_agree(cuda):
    """A `rect_row_view` window and a copy of it give the same bits."""
    g, ranks = _perm_problem(20, 260, seed=9)
    tg, tr = torch.from_numpy(g).to(cuda), torch.from_numpy(ranks).to(cuda)
    view = rect_row_view(tr, 130, 120)
    a = sti_fill_rect_cuda(tg, view, tr)
    b = sti_fill_rect_cuda(tg, view.clone(), tr)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_rect_empty_launches_nothing(cuda):
    before = sti_fill_acc_rect_cuda.launches
    acc = torch.zeros(0, 8, device=cuda)
    sti_fill_acc_rect_cuda(acc, torch.zeros(3, 8, device=cuda),
                           torch.zeros(3, 0, dtype=torch.int64, device=cuda),
                           torch.zeros(3, 8, dtype=torch.int64, device=cuda))
    assert sti_fill_acc_rect_cuda.launches == before
