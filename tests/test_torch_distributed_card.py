"""The port's "distributed" engine on the card (`launch/specs.py::sti_cell`
on a ("data", "model") `DeviceGrid`, `core/valuation.py::make_sti_step_fn`,
`engine="distributed"`): kernel launches per cell and agreement with the
fused engine and with the same step on the CPU. Imports neither `jax` nor
`repro`, so `-m cuda` runs no JAX on the card; every test skips without
a card. The CPU tests of the engine, against JAX, are
`tests/test_torch_distributed.py`.
"""

import faulthandler

import numpy as np
import pytest
import torch

from repro_torch.core.methods import get_method
from repro_torch.core.valuation import make_sti_step_fn
from repro_torch.data import make_moons
from repro_torch.distributed.sharding import DeviceGrid
from repro_torch.kernels.distance import distance_cuda
from repro_torch.kernels.rank_sort import rank_order_cuda
from repro_torch.kernels.sti_fill import (
    sti_fill_acc_cuda, sti_fill_acc_rect_cuda)
from repro_torch.launch.mesh import make_local_mesh

N, T, K = 128, 32, 5
CUDA_TEST_LIMIT_S = 300  # a hung kernel fails its test instead of the run


@pytest.fixture(scope="module")
def moons():
    """n = 128, t = 32 moons, as tests/test_torch_distributed.py's."""
    x, y = make_moons(N // 2, noise=0.08, seed=0)
    xt, yt = make_moons(T // 2, noise=0.08, seed=1)
    return tuple(np.asarray(a) for a in (x, y, xt, yt))


def _grid(shape):
    return DeviceGrid(("cpu",) * (shape[0] * shape[1]), shape)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    faulthandler.dump_traceback_later(CUDA_TEST_LIMIT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sti", "sii"])
def test_cuda_distributed_engine_on_a_grid_of_one_card(cuda, mode):
    """[13] at small size: a (2, 2) grid on one card launches one distance,
    one rank sort and one rect fill per cell and no square fill; phi
    within 1e-6 of max
    |ref| of the fused engine on the card, and of the same grid on the
    CPU. Integer features: the ranks agree on every side."""
    rng = np.random.default_rng(5)
    x = rng.integers(-8, 9, (1024, 16)).astype(np.float32)
    xt = rng.integers(-8, 9, (64, 16)).astype(np.float32)
    y, yt = rng.integers(0, 3, 1024), rng.integers(0, 3, 64)
    grid = DeviceGrid((cuda,) * 4, (2, 2))
    before = (distance_cuda.launches, rank_order_cuda.launches,
              sti_fill_acc_rect_cuda.launches, sti_fill_acc_cuda.launches)
    got = get_method(mode)(x, y, xt, yt, k=5, engine="distributed",
                           mesh=grid).phi
    torch.cuda.synchronize()
    assert (distance_cuda.launches - before[0],
            rank_order_cuda.launches - before[1],
            sti_fill_acc_rect_cuda.launches - before[2],
            sti_fill_acc_cuda.launches - before[3]) == (4, 4, 4, 0)
    want = get_method(mode)(x, y, xt, yt, k=5, engine="fused",
                            device=cuda).phi
    plain = get_method(mode)(x, y, xt, yt, k=5, engine="distributed",
                             mesh=_grid((2, 2))).phi
    torch.cuda.synchronize()
    tol = 1e-6 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    torch.testing.assert_close(got.cpu(), plain, rtol=0, atol=tol)


@pytest.mark.cuda
def test_cuda_default_grid_and_device_agree(cuda, moons):
    """A device naming one card is a (1, 1) grid of it; device= beside a
    grid that does not start on it raises."""
    assert make_local_mesh("cuda:0").devices == (torch.device("cuda", 0),)
    assert make_local_mesh().shape == (torch.cuda.device_count(), 1)
    x, y, xt, yt = moons
    res = get_method("sti")(x, y, xt, yt, k=K, engine="distributed",
                            device="cuda:0")
    assert res.meta["mesh"] == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="first device"):
        get_method("sti")(x, y, xt, yt, k=K, engine="distributed",
                          device="cpu", mesh=DeviceGrid((cuda,) * 4, (2, 2)))


@pytest.mark.cuda
def test_cuda_step_fn_matches_the_cpu(cuda):
    """make_sti_step_fn on the card (distance kernel, rank sort kernel,
    square fill kernel) within 1e-6 of max |ref| of the same step on the
    CPU."""
    rng = np.random.default_rng(6)
    x = rng.integers(-8, 9, (512, 8)).astype(np.float32)
    xt = rng.integers(-8, 9, (48, 8)).astype(np.float32)
    y, yt = rng.integers(0, 2, 512), rng.integers(0, 2, 48)
    before = (rank_order_cuda.launches, sti_fill_acc_cuda.launches)
    phi, diag = make_sti_step_fn(5, device=cuda)(x, y, xt, yt)
    torch.cuda.synchronize()
    assert (rank_order_cuda.launches, sti_fill_acc_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    want, wdiag = make_sti_step_fn(5, device="cpu")(x, y, xt, yt)
    tol = 1e-6 * float(want.abs().max())
    torch.testing.assert_close(phi.cpu(), want, rtol=0, atol=tol)
    torch.testing.assert_close(diag.cpu(), wdiag, rtol=0, atol=1e-6)
