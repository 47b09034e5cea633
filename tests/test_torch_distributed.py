"""The port's "distributed" engine (`launch/specs.py::sti_cell` on a
("data", "model") `DeviceGrid`, `core/valuation.py`'s step functions,
`engine="distributed"`) and the pod-axis gradient compression against the
JAX package, on the CPU.

The JAX engine fails under jax 0.9 at its diagonal write on explicit mesh
axes (ROADMAP.md queue C 1.3), so the port's cell is held against
`sti_cell` itself on a mesh of `AxisType.Auto` axes, in one subprocess
with 8 host devices (JAX fixes its device count at first use), and the
whole engine against `sti_knn_interactions` and the O(2^n) oracle. Sums
agree within 1e-6 of the largest |value| (the fill adds the same terms in
another order), whole methods within 1e-5.
"""

import faulthandler
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import sti_knn_interactions as jsti
from repro.core.valuation import make_sti_step_fn as jmake_step
from repro.data import make_moons

from repro_torch.configs.sti_knn_paper import STIConfig
from repro_torch.core import methods as tmethods
from repro_torch.core.methods import ENGINES, get_method, valid_engines
from repro_torch.core.sti_baseline import brute_force_sii, brute_force_sti
from repro_torch.core.valuation import (
    distributed_sti_step, make_sti_step_fn)
from repro_torch.distributed.sharding import DeviceGrid
from repro_torch.kernels.distance import distance_cuda
from repro_torch.kernels.sti_fill import (
    sti_fill_acc_cuda, sti_fill_acc_rect_cuda)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.specs import sti_cell

REPO = Path(__file__).resolve().parents[1]
N, T, K = 128, 32, 5
GRIDS = [(4, 2), (2, 4), (8, 1), (1, 8)]
CUDA_TEST_LIMIT_S = 300  # a hung kernel fails its test instead of the run


@pytest.fixture(scope="module")
def moons():
    """The data of tests/test_distributed.py: n = 128, t = 32 moons."""
    x, y = make_moons(N // 2, noise=0.08, seed=0)
    xt, yt = make_moons(T // 2, noise=0.08, seed=1)
    return tuple(np.asarray(a) for a in (x, y, xt, yt))


def _grid(shape):
    return DeviceGrid(("cpu",) * (shape[0] * shape[1]), shape)


def _close(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# ------------------------------------------------------------ the grid
def test_grid_shape_devices_and_validation():
    grid = _grid((4, 2))
    assert grid.axis_sizes == {"data": 4, "model": 2}
    assert grid.device(3, 1) == torch.device("cpu")
    with pytest.raises(ValueError, match="do not fill"):
        DeviceGrid(("cpu",) * 6, (4, 2))
    with pytest.raises(ValueError, match="2-D"):
        DeviceGrid(("cpu",) * 2, (2,))
    assert grid.axis_names == ("data", "model")
    local = make_local_mesh("cpu")
    assert local.shape == (1, 1) and local.devices == (torch.device("cpu"),)


def test_grid_raises_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceGrid(("cuda",) * 4, (2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sti_step_fn(5)


def test_psum_data_adds_each_distinct_partial_once():
    """Distinct partials add in data order into data row 0's own; a tensor
    shared by two cells (one accumulator on one device) counts once; the
    sums are data row 0's tensors, nothing is copied to other rows."""
    grid = _grid((3, 2))
    rng = np.random.default_rng(0)
    a = [torch.from_numpy(rng.normal(size=4).astype(np.float32))
         for _ in range(5)]
    want0 = (a[0] + a[1]) + a[2]
    want1 = a[3] + a[4]
    parts = [[a[0].clone(), a[3].clone()], [a[1], None], [a[2], a[4]]]
    parts[1][1] = parts[0][1]          # cells (0, 1) and (1, 1) share
    out = grid.psum_data(parts)
    assert len(out) == 2 and out[0] is parts[0][0] and out[1] is parts[0][1]
    assert torch.equal(out[0], want0) and torch.equal(out[1], want1)


def test_cell_takes_only_the_identity_column_ids(moons):
    """col_ids is arange(n), what every caller passes; other ids raise."""
    x, y, xt, yt = (torch.from_numpy(a) for a in moons)
    cfg = STIConfig(n_train=N, feat_dim=2, k=K, test_chunk=T)
    step = sti_cell(cfg, _grid((2, 2)))[0]
    acc, diag = step(x, y, xt, yt)
    acc_ids, diag_ids = step(x, y, xt, yt, torch.arange(N, dtype=torch.int32))
    assert all(torch.equal(p, q) for p, q in zip(acc, acc_ids))
    assert torch.equal(diag, diag_ids)
    with pytest.raises(ValueError, match="arange"):
        step(x, y, xt, yt, torch.arange(N).flip(0))


# ------------------------------------------------- the cell against JAX
_SUBPROCESS = r"""
import numpy as np, jax, jax.numpy as jnp, torch
from jax.sharding import AxisType, Mesh
from repro import compat
from repro.configs.sti_knn_paper import STIConfig as JConfig
from repro.data import make_moons
from repro.launch.specs import sti_cell as jcell
from repro.training.compression import int8_allreduce_pod as jint8

from repro_torch.configs.sti_knn_paper import STIConfig
from repro_torch.core.methods import get_method
from repro_torch.distributed.sharding import DeviceGrid, ShardGroup
from repro_torch.launch.specs import sti_cell
from repro_torch.training.compression import int8_allreduce_pod

n, t, k = 128, 32, 5
x, y = make_moons(n // 2, noise=0.08, seed=0)
xt, yt = make_moons(t // 2, noise=0.08, seed=1)
tx, ty, txt, tyt = (torch.from_numpy(np.asarray(a)) for a in (x, y, xt, yt))
cols = jnp.arange(n, dtype=jnp.int32)

def close(got, want):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= 1e-6 * float(np.abs(want).max()), (err, np.abs(want).max())
    return err

for shape in ((4, 2), (2, 4)):
    mesh = Mesh(np.asarray(jax.devices()).reshape(shape), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    for mode in ("sti", "sii"):
        step = jcell(JConfig(n_train=n, feat_dim=2, k=k, test_chunk=t,
                             mode=mode), mesh)[0]
        with compat.set_mesh(mesh):
            acc, diag = jax.jit(step)(x, y, xt, yt, cols)
        acc, diag = np.asarray(acc), np.asarray(diag)
        grid = DeviceGrid(("cpu",) * 8, shape)
        tstep = sti_cell(STIConfig(n_train=n, feat_dim=2, k=k,
                                   test_chunk=t, mode=mode), grid)[0]
        blocks, tdiag = tstep(tx, ty, txt, tyt)
        assert len(blocks) == shape[1]
        assert all(b.shape == (n, n // shape[1]) for b in blocks)
        e1 = close(torch.cat(blocks, 1), acc)
        e2 = close(tdiag, diag)
        # explicit column ids gather the row table instead of viewing it
        blocks2, _ = tstep(tx, ty, txt, tyt, torch.arange(n))
        assert torch.equal(torch.cat(blocks2, 1), torch.cat(blocks, 1))
        phi = acc / t
        np.fill_diagonal(phi, diag / t)
        res = get_method(mode)(x, y, xt, yt, k=k, engine="distributed",
                               mesh=grid)
        assert res.meta["mesh"] == {"data": shape[0], "model": shape[1]}
        e3 = close(res.phi, phi)
        print("cell", shape, mode, e1, e2, e3)

# int8 all-reduce over a 2-pod axis, JAX's noise handed to the port
pods = Mesh(np.asarray(jax.devices()[:2]), ("pod",),
            axis_types=(AxisType.Auto,))
rng = np.random.default_rng(3)
grads = {"w": rng.normal(size=(2, 6, 5)).astype(np.float32),
         "b": rng.normal(size=(2, 7)).astype(np.float32) * 1e-3}
key = jax.random.key(4)
P = jax.sharding.PartitionSpec

def body(g, key):
    return jint8(jax.tree.map(lambda a: a[0], g), key, "pod")

with compat.set_mesh(pods):
    out = jax.jit(compat.shard_map(
        lambda g, key: jax.tree.map(lambda a: a[None], body(g, key)),
        mesh=pods, in_specs=(P("pod"), P()), out_specs=P("pod"),
        check_vma=False))(grads, key)
leaves, tdef = jax.tree.flatten({"w": grads["w"][0], "b": grads["b"][0]})
keys = jax.random.split(key, len(leaves))
noise = jax.tree.unflatten(tdef, [
    np.asarray(jax.random.uniform(kk, l.shape, minval=-0.5, maxval=0.5))
    for l, kk in zip(leaves, keys)])
tnoise = {nm: torch.from_numpy(v) for nm, v in noise.items()}
group = ShardGroup(("cpu", "cpu"))
per_pod = [{nm: torch.from_numpy(v[p]) for nm, v in grads.items()}
           for p in range(2)]
got = int8_allreduce_pod(per_pod, group, noise=[tnoise, tnoise])
for p in range(2):
    for nm in grads:
        want = np.asarray(out[nm])[p]
        assert np.array_equal(got[p][nm].numpy(), want), nm
print("int8 bit-equal")
print("ok")
"""


def test_cell_and_compression_match_jax_on_auto_meshes():
    """One subprocess with 8 forced host devices: the port's `sti_cell` on
    (4, 2) and (2, 4) grids of the CPU within 1e-6 of max |ref| of JAX's
    on Auto meshes of the same shapes (column blocks, diagonal, and the
    finalized phi of `engine="distributed"`), for sti and sii; and
    `int8_allreduce_pod` over a 2-pod axis bit-equal to JAX's given JAX's
    noise."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_SUBPROCESS)],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.strip().endswith("ok"), p.stdout


# ------------------------------------------------ the engine in process
@pytest.mark.parametrize("mode", ["sti", "sii"])
@pytest.mark.parametrize("shape", [None, *GRIDS])
def test_distributed_engine_matches_jax(moons, mode, shape):
    """engine="distributed" (the default grid: the CPU as (1, 1)) within
    1e-5 of JAX's `sti_knn_interactions`; the plain versions run, no
    kernel launches on CPU tensors."""
    x, y, xt, yt = moons
    before = (distance_cuda.launches, sti_fill_acc_rect_cuda.launches)
    kw = {} if shape is None else {"mesh": _grid(shape)}
    res = get_method(mode)(x, y, xt, yt, k=K, engine="distributed",
                           device="cpu", **kw)
    want = np.asarray(jsti(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt),
                           jnp.asarray(yt), K, mode=mode))
    np.testing.assert_allclose(res.phi.numpy(), want, rtol=0, atol=1e-5)
    assert res.meta["engine"] == "distributed"
    assert res.meta["mesh"] == dict(zip(("data", "model"), shape or (1, 1)))
    assert (distance_cuda.launches, sti_fill_acc_rect_cuda.launches) == \
        before


@pytest.mark.parametrize("mode,oracle", [("sti", brute_force_sti),
                                         ("sii", brute_force_sii)])
def test_distributed_engine_matches_the_oracle(mode, oracle):
    """The O(2^n) definition at n = 12 (integer features, t = 6 on a
    (2, 3) grid), within 1e-5."""
    rng = np.random.default_rng(11)
    x = rng.integers(-8, 9, (12, 2)).astype(np.float32)
    xt = rng.integers(-8, 9, (6, 2)).astype(np.float32)
    y, yt = (rng.integers(0, 2, 12).astype(np.int32),
             rng.integers(0, 2, 6).astype(np.int32))
    got = get_method(mode)(x, y, xt, yt, k=3, engine="distributed",
                           mesh=_grid((2, 3)))
    np.testing.assert_allclose(got.phi.numpy(), oracle(x, y, xt, yt, 3),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["sti", "sii"])
def test_step_fns_match_jax(moons, mode):
    """make_sti_step_fn within 1e-6 of max |ref| of the reference's, and
    distributed_sti_step on a (4, 2) grid within 1e-6 of it."""
    x, y, xt, yt = moons
    jphi, jdiag = jmake_step(K, mode)(*(jnp.asarray(a)
                                        for a in (x, y, xt, yt)))
    phi, diag = make_sti_step_fn(K, mode, device="cpu")(x, y, xt, yt)
    _close(phi, jphi, 1e-6)
    _close(diag, jdiag, 1e-6)
    dphi, ddiag = distributed_sti_step(_grid((4, 2)), K, mode)(x, y, xt, yt)
    _close(dphi, phi.numpy(), 1e-6)
    _close(ddiag, diag.numpy(), 1e-6)


@pytest.mark.parametrize("t,n,shape", [(30, 128, (4, 2)), (32, 126, (2, 4)),
                                       (32, 128, (3, 1))])
def test_indivisible_test_points_or_columns_raise(moons, t, n, shape):
    """tc % D and n % M must be 0: refused, never padded."""
    x, y, xt, yt = moons
    with pytest.raises(ValueError, match="split evenly"):
        get_method("sti")(x[:n], y[:n], xt[:t], yt[:t], k=K,
                          engine="distributed", mesh=_grid(shape))
    with pytest.raises(ValueError, match="split evenly"):
        sti_cell(STIConfig(n_train=n, feat_dim=2, k=K, test_chunk=t),
                 _grid(shape))


def test_cell_refuses_wrong_shapes_and_out_buffers(moons):
    x, y, xt, yt = (torch.from_numpy(a) for a in moons)
    step = sti_cell(STIConfig(n_train=N, feat_dim=2, k=K, test_chunk=T),
                    _grid((4, 2)))[0]
    with pytest.raises(ValueError, match="the cell takes"):
        step(x, y, xt[:16], yt[:16])
    with pytest.raises(ValueError, match="out takes"):
        step(x, y, xt, yt, out=[torch.zeros(N // 2, N)])


def test_mesh_option_needs_the_distributed_engine(moons):
    x, y, xt, yt = moons
    with pytest.raises(ValueError, match="mesh="):
        get_method("sti")(x, y, xt, yt, k=K, engine="fused", device="cpu",
                          mesh=_grid((1, 1)))


@pytest.mark.parametrize("option", [
    {"fill": "chunked"}, {"fill_params": {"row_chunk": 8}},
    {"distance": "plain"}, {"test_batch": 8}, {"autotune": True}])
def test_distributed_engine_refuses_options_it_would_ignore(moons, option):
    """The cells always run the distance and rect fill kernels: a knob of
    the single-device pipeline raises instead of doing nothing."""
    x, y, xt, yt = moons
    with pytest.raises(ValueError, match="do not apply"):
        get_method("sti")(x, y, xt, yt, k=K, engine="distributed",
                          mesh=_grid((2, 2)), **option)


def test_engine_table_helpers_match_the_reference():
    from repro.core import methods as jmethods

    assert ENGINES == jmethods.ENGINES
    assert valid_engines("sii") == jmethods.valid_engines("sii")
    assert valid_engines("custom") is None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert tmethods.INTERACTION_ENGINES == ENGINES["sti"]
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    with pytest.raises(AttributeError):
        tmethods.NOT_A_NAME  # noqa: B018


def test_launcher_runs_the_distributed_engine_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    for extra in (["--engine", "distributed", "--mesh-shape", "4,2",
                   "--devices", "cpu"], ["--distributed", "--method", "sii"]):
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.valuate", "--device",
             "cpu", "--n", "64", "--t", "16", *extra], env=env, cwd=REPO,
            capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stdout + p.stderr
        assert "distributed" in p.stdout and "mesh=" in p.stdout, p.stdout
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.valuate", "--device",
         "cpu", "--mesh-shape", "2,2"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "--mesh-shape needs" in p.stderr
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.valuate", "--device",
         "cpu", "--distributed", "--fill", "chunked"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "takes none of" in p.stderr


# ---------------------------------------------------------- on the card
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
    """[13] at small size: a (2, 2) grid on one card launches one distance
    and one rect fill per cell and no square fill; phi within 1e-6 of max
    |ref| of the fused engine on the card, and of the same grid on the
    CPU. Integer features: the ranks agree on every side."""
    rng = np.random.default_rng(5)
    x = rng.integers(-8, 9, (1024, 16)).astype(np.float32)
    xt = rng.integers(-8, 9, (64, 16)).astype(np.float32)
    y, yt = rng.integers(0, 3, 1024), rng.integers(0, 3, 64)
    grid = DeviceGrid((cuda,) * 4, (2, 2))
    before = (distance_cuda.launches, sti_fill_acc_rect_cuda.launches,
              sti_fill_acc_cuda.launches)
    got = get_method(mode)(x, y, xt, yt, k=5, engine="distributed",
                           mesh=grid).phi
    torch.cuda.synchronize()
    assert (distance_cuda.launches - before[0],
            sti_fill_acc_rect_cuda.launches - before[1],
            sti_fill_acc_cuda.launches - before[2]) == (4, 4, 0)
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
    """make_sti_step_fn on the card (distance kernel, square fill kernel)
    within 1e-6 of max |ref| of the same step on the CPU."""
    rng = np.random.default_rng(6)
    x = rng.integers(-8, 9, (512, 8)).astype(np.float32)
    xt = rng.integers(-8, 9, (48, 8)).astype(np.float32)
    y, yt = rng.integers(0, 2, 512), rng.integers(0, 2, 48)
    before = sti_fill_acc_cuda.launches
    phi, diag = make_sti_step_fn(5, device=cuda)(x, y, xt, yt)
    torch.cuda.synchronize()
    assert sti_fill_acc_cuda.launches == before + 1
    want, wdiag = make_sti_step_fn(5, device="cpu")(x, y, xt, yt)
    tol = 1e-6 * float(want.abs().max())
    torch.testing.assert_close(phi.cpu(), want, rtol=0, atol=tol)
    torch.testing.assert_close(diag.cpu(), wdiag, rtol=0, atol=1e-6)
