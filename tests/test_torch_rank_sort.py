"""The rank stage's own kernel (`repro_torch.kernels.rank_sort`,
`csrc/rank_sort.cu`): a stable radix sort of every row of the (tb, n)
distances that writes the argsort and its inverse permutation.

On the CPU: the plain version is `torch.sort(stable=True)` and
`ranks_from_order`, CPU tensors never load the library, the wrapper's
checks raise before any launch, the dry run's meta path gives the
outputs' shapes and adds `rank_sort_cost`, the contract checker counts
the new entry in the streaming step, and `sort_passes` models the
kernel's digit skip. On a CUDA card (tests marked `cuda`, skipped
elsewhere) the kernel's `order` and `ranks` are held bit for bit against
`torch.sort` and `ranks_from_order` at ragged shapes and on hard keys
(ties, equal rows, signed zeros, infinities, denormals, negatives, NaN
payloads), its
passes against `sort_passes`, and a streamed `ValuationSession` against
the same session with the plain rank stage. Run those on a card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_rank_sort.py -q
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis import contracts as C
from repro_torch.core.sti_knn import ranks_from_order
from repro_torch.kernels import build, rank_sort, sti_pipeline
from repro_torch.kernels.rank_sort import (
    ctl_words,
    rank_order_cuda,
    rank_order_plain,
    sort_passes,
)
from repro_torch.launch import hlo_analysis as HA

META = torch.device("meta")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


# bit patterns of hard f32 keys: signed zeros, infinities, denormals, the
# largest and smallest normals, and negatives
_SPECIAL_BITS = np.array([
    0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x00000001, 0x80000001,
    0x007FFFFF, 0x807FFFFF, 0x00800000, 0x80800000, 0x7F7FFFFF, 0xFF7FFFFF,
    0x3F800000, 0xBF800000], dtype=np.uint32)
# NaN payloads: quiet and signalling, both signs
_NAN_BITS = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,
                      0x7FC00123, 0x7FFFFFFF], dtype=np.uint32)


def _keys(kind: str, tb: int, n: int, seed: int = 0) -> torch.Tensor:
    """(tb, n) f32 keys of one kind, from numpy (the same on every host)."""
    rng = np.random.default_rng(seed + 7919 * tb + n)
    if kind == "random":
        x = rng.normal(size=(tb, n)).astype(np.float32)
    elif kind == "integers":   # heavy ties
        x = rng.integers(-8, 9, (tb, n)).astype(np.float32)
    elif kind == "equal":
        x = np.full((tb, n), 2.5, dtype=np.float32)
    elif kind == "negative":
        x = -np.abs(rng.normal(size=(tb, n)) * 1e3).astype(np.float32)
    elif kind == "distances":  # the step's: clamped at 0, a narrow span
        x = (1.5e4 + 1e4 * rng.random((tb, n))).astype(np.float32)
    elif kind == "specials":
        x = rng.normal(size=(tb, n)).astype(np.float32)
        pick = rng.random((tb, n)) < 0.5
        x[pick] = _SPECIAL_BITS[rng.integers(
            0, len(_SPECIAL_BITS), int(pick.sum()))].view(np.float32)
    elif kind == "nans":
        x = rng.normal(size=(tb, n)).astype(np.float32)
        pick = rng.random((tb, n)) < 0.3
        x[pick] = _NAN_BITS[rng.integers(
            0, len(_NAN_BITS), int(pick.sum()))].view(np.float32)
    else:
        raise ValueError(kind)
    return torch.from_numpy(x)


KINDS = ("random", "integers", "equal", "negative", "distances", "specials",
         "nans")


# ------------------------------------------------------------ on the CPU
@pytest.mark.parametrize("kind", KINDS)
def test_plain_is_torch_sort_and_ranks_from_order(kind):
    d2 = _keys(kind, 5, 300)
    order, ranks = rank_order_plain(d2)
    want = torch.sort(d2, dim=-1, stable=True).indices
    assert order.dtype == ranks.dtype == torch.int64
    assert torch.equal(order, want)
    assert torch.equal(ranks, ranks_from_order(want))
    # the inverse permutation, row by row
    assert torch.equal(torch.gather(ranks, 1, order),
                       torch.arange(300).expand(5, 300))


def test_cpu_tensors_take_the_plain_version_without_the_library(
        monkeypatch):
    def no_library(name):
        raise AssertionError(f"library({name!r}) loaded for a CPU tensor")

    monkeypatch.setattr(rank_sort, "library", no_library)
    monkeypatch.setattr(build, "library", no_library)
    d2 = _keys("integers", 4, 129)
    before = rank_order_cuda.launches
    passes = torch.zeros(4, dtype=torch.int32)
    got = rank_order_cuda(d2, passes=passes)
    want = rank_order_plain(d2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(passes, sort_passes(d2))
    assert rank_order_cuda.launches == before


@pytest.mark.parametrize("bad", ["float64", "bfloat16", "int32",
                                 "strided", "transposed", "1d", "passes"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """Off the CPU (here: meta, which reaches the same checks as a CUDA
    tensor) the wrapper raises before it allocates or launches."""
    d2 = torch.empty((4, 64), device=META)
    passes = None
    if bad in ("float64", "bfloat16", "int32"):
        d2 = d2.to(getattr(torch, bad))
        err = TypeError
    elif bad == "strided":
        d2, err = torch.empty((4, 128), device=META)[:, ::2], ValueError
    elif bad == "transposed":
        d2, err = torch.empty((64, 4), device=META).t(), ValueError
    elif bad == "1d":
        d2, err = torch.empty((64,), device=META), ValueError
    else:
        passes, err = torch.empty((3,), dtype=torch.int32,
                                  device=META), ValueError
    before = rank_order_cuda.launches
    with HA.KERNELS.counting(), pytest.raises(err):
        rank_order_cuda(d2, passes=passes)
    assert HA.KERNELS.calls == {} and rank_order_cuda.launches == before


@pytest.mark.parametrize("tb,n", [(8, 64), (256, 1281167), (3, 4097)])
def test_meta_path_adds_rank_sort_cost(tb, n):
    before = rank_order_cuda.launches
    with HA.KERNELS.counting():
        order, ranks = rank_order_cuda(torch.empty((tb, n), device=META))
    for out in (order, ranks):
        assert out.device == META and out.dtype == torch.int64
        assert tuple(out.shape) == (tb, n)
    cost = HA.rank_sort_cost(tb, n)
    assert HA.KERNELS.calls == {"rank_sort": 1}
    assert (HA.KERNELS.ops, HA.KERNELS.bytes) == (cost.ops, cost.bytes)
    assert rank_order_cuda.launches == before and not HA.KERNELS.active


def test_meta_outside_the_dry_run_takes_the_kernel_path():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernels build")
    with HA.KERNELS.counting():
        pass
    with pytest.raises(RuntimeError, match="nvcc"):
        rank_order_cuda(torch.empty((4, 64), device=META))
    assert HA.KERNELS.calls == {}


def test_meta_path_allocates_the_workspace():
    """The dry run's temp bytes see what the card allocates: the outputs,
    the pairs plane and the control words."""
    from repro_torch.launch.dryrun import count_step

    tb, n = 16, 10000
    _, count = count_step(lambda d2: rank_order_cuda(d2),
                          [torch.empty((tb, n), device=META)])
    want = 2 * 8 * tb * n + 8 * tb * n + 4 * ctl_words(tb, n)
    assert count["peak_bytes"] >= want


def test_rank_sort_cost_is_the_function_floor():
    """The rank stage's floor: keys read once, int64 order and ranks
    written once, 20 bytes a key whatever the passes."""
    t, n = 256, 1281167
    cost = HA.rank_sort_cost(t, n)
    assert (cost.ops, cost.bytes) == (0.0, 20 * t * n)
    ms, by = cost.bound_ms()
    assert by == "bytes" and ms == pytest.approx(1.958, abs=1e-3)


def test_sort_traffic_is_the_bytes_per_pass():
    """The sort's own traffic: 12 + 16 P bytes a key for a row of P passes
    with the ranks written (76 at four, 60 at three: the knn cell's rows,
    28 at one), 8 fewer without them, which is the megakernel sort's
    `sort_floor_ms`."""
    t, n = 256, 1281167
    assert HA.sort_traffic(n, [4] * t, ranks=True) == 76 * t * n
    assert HA.sort_traffic(n, [3] * t, ranks=True) == 60 * t * n
    assert HA.sort_traffic(10, [1, 4], ranks=True) == 10 * (28 + 76)
    assert HA.sort_traffic(n, [3] * t) == 52 * t * n
    assert 1e3 * HA.sort_traffic(n, [3] * t, ranks=True) / \
        HA.HBM_BYTES_PER_S == pytest.approx(5.875, abs=1e-3)
    assert HA.sort_floor_ms(n, [2, 3]) == pytest.approx(
        1e3 * n * (36 + 52) / HA.HBM_BYTES_PER_S)


def test_ctl_words_by_hand():
    # 8 + per row (4 + 4 + 2048) + 1024 per tile of a row + 1 per bucket
    # of 8192 indices of a row
    assert ctl_words(1, 1) == 8 + 2056 + 1024 + 1
    assert ctl_words(3, 4097) == 8 + 3 * 2056 + 1024 * 3 * 2 + 3
    assert ctl_words(256, 1281167) == (8 + 256 * 2056 + 1024 * 256 * 313
                                       + 256 * 157)


@pytest.mark.parametrize("rows,want", [
    ([[2.5, 2.5, 2.5]], [1]),                   # every key alike
    ([[1.0, 1.0 + 2 ** -23]], [1]),             # the lowest digit alone
    ([[1.0, 1.0 + 2 ** -15]], [1]),             # digit 1 alone
    ([[1.0, 1.0 + 2 ** -15 + 2 ** -23]], [2]),  # digits 0 and 1
    ([[1.0, 2.0]], [1]),                        # one exponent step: digit 2
    ([[-1.0, 1.0]], [2]),                       # across the sign: 0, 3
    ([[0.0, -0.0, 0.0]], [1]),                  # -0 is +0
    ([[float("nan"), float("nan")]], [1]),      # one NaN twice
])
def test_sort_passes_models_the_digit_skip(rows, want):
    assert sort_passes(torch.tensor(rows)).tolist() == want


def test_sort_passes_of_random_rows_are_four():
    assert sort_passes(_keys("random", 3, 1000)).tolist() == [4, 4, 4]


def test_contract_checker_counts_the_rank_entry_in_the_step():
    """ENTRIES names the wrapper and its plain version; a streaming step
    on the CPU calls the plain version once a step (one `kernel:rank_sort`
    record), the megakernel step never."""
    assert C.ENTRIES["rank_sort"] == ("repro_torch.kernels.rank_sort",
                                      "rank_order_cuda", "rank_order_plain")
    for label, step, spec, tb, group, _ in C._prepared_steps(
            64, 8, 4, 8, torch.device("cpu"), False):
        before = C.entry_calls()
        log = C._OpLog()
        C._run(step, C._state(spec, 64, "cpu", group),
               C._batch(64, 8, tb, torch.device("cpu")), group, log)
        calls = C.entry_calls()
        assert calls["rank_sort"] == before["rank_sort"] + 1, label
        names = [op["name"] for op in log.ops]
        assert names.count("kernel:rank_sort") == 1, label
        assert "aten::sort" not in names and "aten::scatter_" not in names
    assert C.check_megakernel_contract(device="cpu") == []
    assert C.check_step_ops(device="cpu") == []


def _spy(monkeypatch, module):
    """Patch `module.rank_order_cuda` with the plain rank stage and return
    the list of key shapes it is called with."""
    seen = []

    def spy(d2, passes=None):
        seen.append(tuple(d2.shape))
        return rank_order_plain(d2)

    monkeypatch.setattr(module, "rank_order_cuda", spy)
    return seen


def test_the_step_ranks_through_the_wrapper(monkeypatch):
    """`step_head` takes its order and ranks from `rank_order_cuda` (the
    name a test can patch), and nothing else sorts in the step."""
    seen = _spy(monkeypatch, sti_pipeline)
    step, _, spec = sti_pipeline.prepare_stream_step(
        "knn_shapley", 64, 8, 4, test_batch=8, device="cpu")
    state = spec.init(64, torch.device("cpu"))
    step(state, *C._batch(64, 8, 8, torch.device("cpu")))
    assert seen == [(8, 64)]


def test_the_distributed_step_ranks_through_the_wrapper(monkeypatch):
    """`make_sti_step_fn`'s one batched step and `sti_cell`'s grid cells
    rank through the step head's `rank_order_cuda`, each cell once, with
    the same sums as the plain rank stage."""
    from repro_torch.configs.sti_knn_paper import STIConfig
    from repro_torch.core.valuation import make_sti_step_fn
    from repro_torch.distributed.sharding import DeviceGrid
    from repro_torch.launch import specs

    gen = torch.Generator().manual_seed(3)
    n, t, d, k = 32, 8, 4, 3
    x, xt = torch.randn(n, d, generator=gen), torch.randn(t, d, generator=gen)
    y, yt = torch.randint(0, 2, (n,), generator=gen), torch.randint(
        0, 2, (t,), generator=gen)
    want = make_sti_step_fn(k, "sti", device="cpu")(x, y, xt, yt)
    seen = _spy(monkeypatch, sti_pipeline)
    got = make_sti_step_fn(k, "sti", device="cpu")(x, y, xt, yt)
    assert seen == [(t, n)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    seen.clear()
    cell = specs.sti_cell(STIConfig(n_train=n, feat_dim=d, k=k,
                                    test_chunk=t),
                          DeviceGrid(("cpu",) * 4, (2, 2)))[0]
    cell(x, y, xt, yt)
    assert seen == [(t // 2, n)] * 4


# ------------------------------------------------------------ on the card
_SHAPES = [(1, 1), (3, 2), (1, 127), (64, 127), (3, 4097), (256, 4097),
           (1, 92160), (64, 92160), (4, 1281167)]


def _hold(d2, cuda):
    """order, ranks and passes of the kernel on `d2` against torch.sort,
    ranks_from_order and sort_passes on the card; one launch."""
    d2 = d2.to(cuda)
    tb = d2.shape[0]
    passes = torch.zeros((tb,), dtype=torch.int32, device=cuda)
    before = rank_order_cuda.launches
    order, ranks = rank_order_cuda(d2, passes=passes)
    torch.cuda.synchronize()
    assert rank_order_cuda.launches == before + 1
    want = torch.sort(d2, dim=-1, stable=True).indices
    assert order.dtype == ranks.dtype == torch.int64
    assert torch.equal(order, want)
    assert torch.equal(ranks, ranks_from_order(want))
    assert torch.equal(passes, sort_passes(d2))
    assert int(passes.min()) >= 1 and int(passes.max()) <= 4


@pytest.mark.cuda
@pytest.mark.parametrize("tb,n", _SHAPES)
@pytest.mark.parametrize("kind", ("random", "integers", "equal", "negative",
                                  "distances", "specials"))
def test_cuda_bit_equal_to_torch_sort(cuda, kind, tb, n):
    _hold(_keys(kind, tb, n), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("tb,n", _SHAPES)
def test_cuda_nans_sort_by_their_bits_as_torch_sort_on_the_card(cuda, tb,
                                                               n):
    """Several NaN payloads, both signs, among normals: the order of
    torch.sort on the card, which sorts a NaN by its bits (a negative NaN
    before -inf, a positive one after +inf; the CPU's sort puts every NaN
    last, in index order)."""
    _hold(_keys("nans", tb, n), cuda)


@pytest.mark.cuda
def test_cuda_bit_equal_at_the_cells_shapes(cuda):
    """The two benchmark cells' rank stages: 256 x 92,160 and 256 x
    1,281,167 distances of the step's kind."""
    for n in (92160, 1281167):
        _hold(_keys("distances", 256, n), cuda)


@pytest.mark.cuda
def test_cuda_rows_past_the_buckets_scatter_ranks(cuda):
    """A row of more than 1024 buckets of 8192 indices: the last pass
    writes `ranks` itself and no inversion runs."""
    _hold(_keys("random", 1, 1024 * 8192 + 1), cuda)


@pytest.mark.cuda
def test_cuda_empty_rows_and_batches(cuda):
    for tb, n in ((0, 5), (3, 0)):
        before = rank_order_cuda.launches
        order, ranks = rank_order_cuda(torch.zeros((tb, n), device=cuda))
        assert order.shape == ranks.shape == (tb, n)
        assert rank_order_cuda.launches == before


@pytest.mark.cuda
def test_cuda_refuses_non_f32_and_non_contiguous(cuda):
    d2 = torch.rand((4, 64), device=cuda)
    for bad, err in ((d2.double(), TypeError), (d2.half(), TypeError),
                     (d2[:, ::2], ValueError), (d2.t(), ValueError)):
        before = rank_order_cuda.launches
        with pytest.raises(err):
            rank_order_cuda(bad)
        assert rank_order_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["knn_shapley", "sti"])
def test_cuda_session_bit_equal_to_the_plain_rank_stage(cuda, method,
                                                        monkeypatch):
    from repro_torch import ValuationSession

    gen = torch.Generator().manual_seed(3)
    n, d, t = 3000, 16, 150
    x = torch.randn((n, d), generator=gen).to(cuda)
    y = torch.randint(0, 3, (n,), generator=gen).to(cuda)
    xt = torch.randn((t, d), generator=gen).to(cuda)
    yt = torch.randint(0, 3, (t,), generator=gen).to(cuda)

    def run():
        sess = ValuationSession(x, y, k=5, mode=method, test_batch=64,
                                device=cuda)
        res = sess.update(xt, yt).finalize()
        return res.phi if method == "sti" else res.point_values

    before = rank_order_cuda.launches
    got = run()
    assert rank_order_cuda.launches == before + 3   # 64 + 64 + 22 padded
    monkeypatch.setattr(sti_pipeline, "rank_order_cuda",
                        lambda d2, passes=None: rank_order_plain(d2))
    want = run()
    assert torch.equal(got, want)
