"""The knn point update's own kernel (`repro_torch.kernels.point_update`,
`csrc/point_update.cu`): the Shapley recurrence over sorted positions and
the sum over test rows through `ranks`, added into the (n,) state.

On the CPU: the wrapper is `_shapley_point_values(...).sum(0)` added into
`vec`, bit for bit, and loads no library; the dry run's meta path adds
`point_update_cost` and allocates the kernel's scratch; the checks raise
before any launch; the single-device, sharded and refold updates of
knn_shapley and wknn reach the wrapper once a step (a shard's partial
with `vec=None`), loo and sti never; the contract checker counts the
entry; and `_model`, the kernel's order of additions restated in torch,
agrees with the plain version to rounding. On a CUDA card (tests marked
`cuda`, skipped elsewhere) the kernel is held bit for bit against the
model and within 1e-6 of the largest |value| against the plain version
and against the f64 sums of the same terms, at the two cells' shapes and
at edge shapes, two runs give the same bits, a masked row adds exactly
nothing, a session launches it once a step for knn_shapley and wknn and
never for sti or loo, and a refold on the card agrees with the same
refold on the CPU. Run those on a card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_point_update.py -q
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis import contracts as C
from repro_torch.kernels import build, point_update, sti_pipeline
from repro_torch.kernels import stream_kernels as SK
from repro_torch.kernels.point_update import (
    TILE,
    point_update_cuda,
    point_update_plain,
    workspace_bytes,
)
from repro_torch.launch import hlo_analysis as HA

META = torch.device("meta")
TOL = 1e-6     # of max |plain|: the kernel adds in another (fixed) order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


def _inputs(tb: int, n: int, k: int = 5, kind: str = "match",
            masked=(), seed: int = 0, dev=None):
    """(u, ranks) as the step hands them over, drawn on `dev` (the CPU by
    default) from a seeded generator: u the sorted label match (kind
    "match") or wknn's rbf-weighted match ("wknn"), with the rows in
    `masked` zeroed as padding; ranks a random permutation per row,
    int64."""
    dev = torch.device("cpu") if dev is None else dev
    gen = torch.Generator(device=dev).manual_seed(seed + 7919 * tb + n)

    def rand():
        return torch.rand((tb, n), generator=gen, device=dev)

    u = (rand() < 0.3).float()
    if kind == "wknn":
        from repro_torch.core.wknn import distance_weights

        u = distance_weights(torch.sort(rand() * 4e4).values, "rbf") * u
    u[list(masked)] = 0.0
    return u, torch.argsort(rand(), dim=1)


def _model(vec, u: torch.Tensor, ranks: torch.Tensor, k: int):
    """The kernel's arithmetic in torch, one f32 operation for each of its
    own, so its bits are the kernel's: the steps with the plain version's
    roundings; per tile of TILE positions, a warp's inclusive suffix sum by
    shuffles (x + x[lane + o] for o = 1 .. 16), each chunk's later warps'
    sums and the tile's later chunks' sums added one at a time from the
    end; the row's later tiles as a chain (a tile's inclusive sum is its
    own sum + the sum after it, the look-back's fold); s = last + (warp
    suffix + (after + (later chunks + later warps))); then per train index
    the rows added in order from zero, each addition's rounding error
    kept (2Sum) and summed apart, the two sums added, and that added into
    vec."""
    tb, n = u.shape
    dev, f32 = u.device, torch.float32
    kf = torch.tensor(float(k), dtype=f32, device=dev)
    last = (u[:, n - 1:] * torch.tensor(float(min(k, n)), dtype=f32,
                                        device=dev)
            ) / torch.tensor(float(k * n), dtype=f32, device=dev)
    tiles = -(-n // TILE)
    x = torch.zeros((tb, tiles * TILE), dtype=f32, device=dev)
    i1 = torch.arange(n - 1, dtype=f32, device=dev) + 1.0
    coef = torch.minimum(i1, kf) / i1
    x[:, :n - 1] = ((u[:, :-1] - u[:, 1:]) * coef) / kf
    x = x.reshape(tb, tiles, 16, 8, 32)        # (row, tile, chunk, warp, lane)
    lane = torch.arange(32, device=dev)
    for o in (1, 2, 4, 8, 16):
        y = torch.zeros_like(x)
        y[..., :32 - o] = x[..., o:]
        x = torch.where(lane + o < 32, x + y, x)
    wsum = x[..., 0]                            # (row, tile, chunk, warp)
    later = torch.zeros_like(wsum)
    total = torch.zeros_like(wsum[..., 0])
    for w in range(7, -1, -1):
        later[..., w] = total
        total = total + wsum[..., w]
    mine = torch.zeros_like(total)              # (row, tile, chunk)
    carry = torch.zeros_like(total[..., 0])
    for q in range(15, -1, -1):
        mine[..., q] = carry
        carry = carry + total[..., q]
    after = torch.zeros_like(carry)             # (row, tile)
    prefix = torch.zeros_like(carry[:, 0])
    for t in range(tiles - 1, -1, -1):
        after[:, t] = prefix
        prefix = carry[:, t] + prefix
    off = after[..., None, None] + (mine[..., None] + later)
    s = (last + (x + off[..., None]).reshape(tb, -1))[:, :n]
    acc = torch.zeros((n,), dtype=f32, device=dev)
    err = torch.zeros_like(acc)
    for r in range(tb):
        x = s[r][ranks[r]]
        t = acc + x
        b = t - acc
        err = err + ((acc - (t - b)) + (x - b))
        acc = t
    acc = acc + err
    return acc if vec is None else vec.add_(acc)


def _ref64(u: torch.Tensor, ranks: torch.Tensor, k: int) -> torch.Tensor:
    """The sums without rounding to speak of: the reference's f32 terms
    (last and the steps) summed in f64 along the row and over rows."""
    n = u.shape[1]
    f32, dev = torch.float32, u.device
    kf = torch.tensor(float(k), dtype=f32, device=dev)
    last = (u[:, n - 1:] * torch.tensor(float(min(k, n)), dtype=f32,
                                        device=dev)
            ) / torch.tensor(float(k * n), dtype=f32, device=dev)
    i1 = torch.arange(n - 1, dtype=f32, device=dev) + 1.0
    step = (((u[:, :-1] - u[:, 1:]) * (torch.minimum(i1, kf) / i1)) / kf)
    suffix = torch.flip(torch.cumsum(torch.flip(step.double(), [-1]), -1),
                        [-1])
    s = torch.cat([last.double() + suffix, last.double()], -1)
    return torch.gather(s, 1, ranks).sum(0)


# ------------------------------------------------------------ on the CPU
@pytest.mark.parametrize("tb,n,kind", [(8, 300, "match"), (3, 5000, "wknn"),
                                       (1, 1, "match"), (4, 3, "match"),
                                       (5, 4097, "match")])
def test_cpu_is_the_plain_update_bit_for_bit(tb, n, kind, monkeypatch):
    def no_library(name):
        raise AssertionError(f"library({name!r}) loaded for a CPU tensor")

    monkeypatch.setattr(point_update, "library", no_library)
    monkeypatch.setattr(build, "library", no_library)
    u, ranks = _inputs(tb, n, kind=kind, masked=(0,))
    vec0 = torch.from_numpy(np.random.default_rng(1).normal(
        size=n).astype(np.float32))
    before = point_update_cuda.launches
    got = point_update_cuda(vec0.clone(), u, ranks, 5)
    want = vec0.clone().add_(SK._shapley_point_values(u, ranks, 5, {}).sum(0))
    assert torch.equal(got, want)
    part = point_update_cuda(None, u, ranks, 5)
    assert torch.equal(part, SK._shapley_point_values(u, ranks, 5, {}).sum(0))
    assert point_update_cuda.launches == before


def test_the_wrapper_adds_in_place_and_returns_vec():
    u, ranks = _inputs(4, 64)
    vec = torch.zeros(64)
    assert point_update_cuda(vec, u, ranks, 5) is vec
    assert point_update_plain(vec, u, ranks, 5) is vec


@pytest.mark.parametrize("tb,n,kind,k", [(8, 300, "match", 5),
                                         (3, 9000, "wknn", 5),
                                         (2, 4096, "match", 1),
                                         (2, 4, "match", 7),
                                         (1, 1, "match", 5)])
def test_the_kernels_order_agrees_with_plain_to_rounding(tb, n, kind, k):
    """`_model`, the order of additions the kernel takes, against the
    plain reverse cumsum and row sum: the same function to rounding, and
    a masked row adds exactly nothing."""
    u, ranks = _inputs(tb, n, kind=kind, masked=(tb - 1,))
    want = point_update_plain(None, u, ranks, k)
    got = _model(None, u, ranks, k)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    exact = _ref64(u, ranks, k)
    assert float((got - exact).abs().max()) <= TOL * float(exact.abs().max())
    if tb > 1:
        assert torch.equal(_model(None, u[:-1], ranks[:-1], k), got)


@pytest.mark.parametrize("bad", ["u_float64", "u_bfloat16", "ranks_int32",
                                 "vec_float64", "vec_shape", "shapes",
                                 "1d", "strided", "transposed",
                                 "vec_strided", "k0"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """Off the CPU (here: meta, which reaches the same checks as a CUDA
    tensor) the wrapper raises before it allocates or launches."""
    u = torch.empty((4, 64), device=META)
    ranks = torch.empty((4, 64), dtype=torch.int64, device=META)
    vec, k, err = torch.empty((64,), device=META), 5, ValueError
    if bad == "u_float64":
        u, err = u.double(), TypeError
    elif bad == "u_bfloat16":
        u, err = u.bfloat16(), TypeError
    elif bad == "ranks_int32":
        ranks, err = ranks.int(), TypeError
    elif bad == "vec_float64":
        vec = vec.double()
    elif bad == "vec_shape":
        vec = torch.empty((63,), device=META)
    elif bad == "shapes":
        ranks = torch.empty((4, 63), dtype=torch.int64, device=META)
    elif bad == "1d":
        u, ranks = u[0], ranks[0]
    elif bad == "strided":
        u = torch.empty((4, 128), device=META)[:, ::2]
    elif bad == "transposed":
        ranks = torch.empty((64, 4), dtype=torch.int64, device=META).t()
    elif bad == "vec_strided":
        vec = torch.empty((128,), device=META)[::2]
    else:
        k = 0
    before = point_update_cuda.launches
    with HA.KERNELS.counting(), pytest.raises(err):
        point_update_cuda(vec, u, ranks, k)
    assert HA.KERNELS.calls == {} and point_update_cuda.launches == before


def test_wrapper_refuses_tensors_on_two_devices():
    u = torch.empty((4, 64), device=META)
    ranks = torch.zeros((4, 64), dtype=torch.int64)
    with HA.KERNELS.counting(), pytest.raises(ValueError, match="device"):
        point_update_cuda(torch.empty((64,), device=META), u, ranks, 5)


@pytest.mark.parametrize("tb,n", [(8, 64), (256, 1281167), (32, 650000)])
def test_meta_path_adds_point_update_cost(tb, n):
    before = point_update_cuda.launches
    vec = torch.empty((n,), device=META)
    with HA.KERNELS.counting():
        out = point_update_cuda(vec, torch.empty((tb, n), device=META),
                                torch.empty((tb, n), dtype=torch.int64,
                                            device=META), 5)
    assert out is vec
    cost = HA.point_update_cost(tb, n)
    assert HA.KERNELS.calls == {"point_update": 1}
    assert (HA.KERNELS.ops, HA.KERNELS.bytes) == (cost.ops, cost.bytes)
    assert point_update_cuda.launches == before and not HA.KERNELS.active


def test_meta_path_allocates_the_scratch():
    """The dry run's temp bytes see what the card allocates: s and the
    look-back words."""
    from repro_torch.launch.dryrun import count_step

    tb, n = 16, 10000
    _, count = count_step(
        lambda u, r: point_update_cuda(None, u, r, 5),
        [torch.empty((tb, n), device=META),
         torch.empty((tb, n), dtype=torch.int64, device=META)])
    assert count["peak_bytes"] >= 4 * tb * n + workspace_bytes(tb, n) + 4 * n


def test_point_update_cost_is_the_function_floor():
    """u and ranks read once (12 bytes a key), the vector read and written
    once: 1.175 ms at the knn cell's shape, 0.075 at the Jamba cell's."""
    cost = HA.point_update_cost(256, 1281167)
    assert (cost.ops, cost.bytes) == (0.0, 12 * 256 * 1281167 + 8 * 1281167)
    ms, by = cost.bound_ms()
    assert by == "bytes" and ms == pytest.approx(1.1776, abs=1e-3)
    ms, _ = HA.point_update_cost(32, 650000).bound_ms()
    assert ms == pytest.approx(0.0761, abs=1e-3)


def test_workspace_bytes_by_hand():
    # a ticket, a word per tile of 4096 positions of a row, one per row
    assert workspace_bytes(1, 1) == 8 * 3
    assert workspace_bytes(3, 4097) == 8 * (1 + 3 * 2 + 3)
    assert workspace_bytes(256, 1281167) == 8 * (1 + 256 * 313 + 256)


def _spy(monkeypatch):
    """Patch `stream_kernels.point_update_cuda` with the plain update and
    return the list of (vec given, u shape) it is called with."""
    seen = []

    def spy(vec, u, ranks, k):
        seen.append((vec is not None, tuple(u.shape)))
        return point_update_plain(vec, u, ranks, k)

    monkeypatch.setattr(SK, "point_update_cuda", spy)
    return seen


@pytest.mark.parametrize("method,calls", [("knn_shapley", 1), ("wknn", 1),
                                          ("loo", 0), ("sti", 0)])
def test_the_step_updates_through_the_wrapper(method, calls, monkeypatch):
    """The single-device step of knn_shapley and wknn adds into the state
    through the wrapper once; loo and sti never reach it. Two shards: one
    call a shard with `vec=None`, summed by the reduce-scatter to the
    single-device values."""
    seen = _spy(monkeypatch)
    n, d, k, tb = 64, 8, 4, 8
    batch = C._batch(n, d, tb, torch.device("cpu"))
    step, _, spec = sti_pipeline.prepare_stream_step(
        method, n, d, k, test_batch=tb, device="cpu")
    single = step(spec.init(n, torch.device("cpu")), *batch)
    assert seen == [(True, (tb, n))] * calls
    seen.clear()
    step, resolved, group, spec = sti_pipeline.prepare_sharded_stream_step(
        method, n, d, k, devices=["cpu", "cpu"], test_batch=tb)
    half = tb // 2
    xb, yb, mask, x_train, y_train = batch
    state = step(spec.init_shards(n, group), [xb[:half], xb[half:]],
                 [yb[:half], yb[half:]], [mask[:half], mask[half:]],
                 [x_train] * 2, [y_train] * 2)
    assert seen == [(False, (half, n))] * (2 * calls)
    if calls:
        got = torch.cat(state[0])
        assert float((got - single[0]).abs().max()) <= 1e-6 * float(
            single[0].abs().max())


def test_the_refold_updates_through_the_wrapper(monkeypatch):
    seen = _spy(monkeypatch)
    tb, n, k = 6, 40, 3
    gen = torch.Generator().manual_seed(2)
    d2 = torch.rand((tb, n), generator=gen)
    order = torch.sort(d2, dim=-1, stable=True).indices
    yb = torch.randint(0, 2, (tb,), generator=gen)
    y_train = torch.randint(0, 2, (n,), generator=gen)
    keep = (torch.rand(n, generator=gen) > 0.2).float()
    mask = torch.ones(tb)
    refold = SK.make_refold_kernel("knn_shapley", k)
    refold((torch.zeros(n),), d2, order, yb, mask, y_train, keep)
    assert seen == [(True, (tb, n))]


def test_contract_checker_counts_the_point_update_entry():
    """ENTRIES names the wrapper and its plain version; the knn_shapley
    and wknn steps call it once a step (one `kernel:point_update`
    record), loo's and sti's and the megakernel steps never."""
    assert C.ENTRIES["point_update"] == ("repro_torch.kernels.point_update",
                                         "point_update_cuda",
                                         "point_update_plain")
    for label, step, spec, tb, group, _ in C._prepared_steps(
            64, 8, 4, 8, torch.device("cpu"), False):
        before = C.entry_calls()
        log = C._OpLog()
        C._run(step, C._state(spec, 64, "cpu", group),
               C._batch(64, 8, tb, torch.device("cpu")), group, log)
        want = int(label.split("/")[1] in ("knn_shapley", "wknn"))
        assert C.entry_calls()["point_update"] == \
            before["point_update"] + want, label
        names = [op["name"] for op in log.ops]
        assert names.count("kernel:point_update") == want, label
    assert C.check_megakernel_contract(device="cpu") == []
    assert C.check_step_ops(device="cpu") == []


# ------------------------------------------------------------ on the card
def _hold(cuda, tb, n, k=5, kind="match", masked=()):
    """The kernel on (tb, n) against `_model` (bit for bit) and the plain
    version (TOL of max |plain|), from zero; one launch. Small shapes are
    drawn and modelled on the CPU, the cells' on the card."""
    small = tb * n <= 1 << 23
    u, ranks = _inputs(tb, n, k, kind, masked, dev=None if small else cuda)
    model = _model(None, u, ranks, k).to(cuda)
    u, ranks = u.to(cuda), ranks.to(cuda)
    before = point_update_cuda.launches
    got = point_update_cuda(torch.zeros(n, device=cuda), u, ranks, k)
    torch.cuda.synchronize()
    assert point_update_cuda.launches == before + 1
    want = point_update_plain(torch.zeros(n, device=cuda), u, ranks, k)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= TOL * scale, (tb, n, kind, err, scale)
    exact = _ref64(u, ranks, k)
    err64 = float((got.double() - exact).abs().max())
    assert err64 <= TOL * float(exact.abs().max()), (tb, n, kind, err64)
    assert torch.equal(got, model), (tb, n, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("tb,n,k", [(1, 1, 5), (3, 2, 5), (4, 5, 5),
                                    (2, 4, 7), (1, 4096, 5), (2, 4097, 5),
                                    (3, 8191, 1), (1, 92160, 5),
                                    (64, 92160, 5), (300, 1000, 5),
                                    (5, 200000, 10)])
def test_cuda_edge_shapes(cuda, tb, n, k):
    _hold(cuda, tb, n, k)


@pytest.mark.cuda
@pytest.mark.parametrize("tb,n", [(256, 1281167), (32, 650000)])
@pytest.mark.parametrize("kind", ["match", "wknn"])
def test_cuda_at_the_cells_shapes(cuda, tb, n, kind):
    _hold(cuda, tb, n, kind=kind, masked=(tb - 1,))


@pytest.mark.cuda
def test_cuda_two_runs_give_the_same_bits(cuda):
    u, ranks = _inputs(256, 1281167, dev=cuda)
    vec0 = torch.randn(1281167, device=cuda)
    a = point_update_cuda(vec0.clone(), u, ranks, 5)
    b = point_update_cuda(vec0.clone(), u, ranks, 5)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_a_masked_row_adds_nothing(cuda):
    """A fully masked row contributes exactly zero: the batch with it
    gives the bits of the batch without it, and a batch of masked rows
    leaves the vector as it was."""
    u, ranks = _inputs(32, 650000, masked=(5, 31), dev=cuda)
    keep = [r for r in range(32) if r not in (5, 31)]
    with_rows = point_update_cuda(torch.zeros(650000, device=cuda), u,
                                  ranks, 5)
    without = point_update_cuda(torch.zeros(650000, device=cuda),
                                u[keep].contiguous(),
                                ranks[keep].contiguous(), 5)
    assert torch.equal(with_rows, without)
    vec0 = torch.randn(650000, device=cuda)
    got = point_update_cuda(vec0.clone(), torch.zeros_like(u), ranks, 5)
    assert torch.equal(got, vec0)


@pytest.mark.cuda
def test_cuda_empty_batches(cuda):
    for tb, n in ((0, 5), (3, 0)):
        vec = torch.ones(n, device=cuda)
        before = point_update_cuda.launches
        point_update_cuda(vec, torch.zeros((tb, n), device=cuda),
                          torch.zeros((tb, n), dtype=torch.int64,
                                      device=cuda), 5)
        assert point_update_cuda.launches == before
        assert torch.equal(vec, torch.ones(n, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("method,per_step", [("knn_shapley", 1), ("wknn", 1),
                                             ("sti", 0), ("loo", 0)])
def test_cuda_session_launches_once_a_step(cuda, method, per_step):
    from repro_torch import ValuationSession

    gen = torch.Generator().manual_seed(3)
    n, d, t = 3000, 16, 150
    x = torch.randn((n, d), generator=gen).to(cuda)
    y = torch.randint(0, 3, (n,), generator=gen).to(cuda)
    xt = torch.randn((t, d), generator=gen).to(cuda)
    yt = torch.randint(0, 3, (t,), generator=gen).to(cuda)
    before = point_update_cuda.launches
    sess = ValuationSession(x, y, k=5, mode=method, test_batch=64,
                            device=cuda)
    sess.update(xt, yt).finalize()
    torch.cuda.synchronize()
    assert point_update_cuda.launches == before + 3 * per_step  # 64+64+22


@pytest.mark.cuda
def test_cuda_refold_agrees_with_the_cpu(cuda):
    """A knn_shapley refold of cached (d2, order) under a liveness mask on
    the card, against the same refold on the CPU."""
    rng = np.random.default_rng(11)
    tb, n, k = 64, 20000, 5
    d2 = torch.from_numpy(rng.random((tb, n)).astype(np.float32) * 1e4)
    order = torch.sort(d2, dim=-1, stable=True).indices
    yb = torch.from_numpy(rng.integers(0, 10, tb))
    y_train = torch.from_numpy(rng.integers(0, 10, n))
    keep = torch.from_numpy((rng.random(n) > 0.1).astype(np.float32))
    mask = torch.ones(tb)
    mask[-3:] = 0.0
    refold = SK.make_refold_kernel("knn_shapley", k)
    want = refold((torch.zeros(n),), d2, order, yb, mask, y_train, keep)[0]
    before = point_update_cuda.launches
    got = refold((torch.zeros(n, device=cuda),),
                 *(a.to(cuda) for a in (d2, order, yb, mask, y_train,
                                        keep)))[0]
    torch.cuda.synchronize()
    assert point_update_cuda.launches == before + 1
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= TOL * scale
