"""The port's sharded engine against the JAX package (CPU).

The port runs D shards from one process over an explicit device list;
here `["cpu"] * 8`, eight row blocks on the CPU. The same numpy inputs go
through the port's sharded engine and through the JAX fused engine and
`sti_knn_interactions(fill="xla")`, mirroring tests/test_sharded_engine.py:
values within 1e-5 (the JAX suite's cross-engine tolerance), per-shard
state shapes exactly (n/8, n) and (n/8,). One subprocess runs JAX on 8
forced host devices to hold the port against JAX's own sharded engine and
to cross-load mid-stream `ShardedValuationSession` checkpoints both ways.
On a CUDA card (tests marked `cuda`, skipped elsewhere) a two-step
sharded session on `["cuda"] * 4` is held against the single-device step.
Run those on a card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_sharded.py -q
"""

import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import DataValuator, ShardedValuationSession, get_method
from repro_torch.core.session import ValuationSession
from repro_torch.distributed.sharding import (
    ShardGroup, gather_rows, replicate, shard_count, shard_rows)
from repro_torch.kernels import sti_pipeline as tpipe
from repro_torch.kernels.sti_fill import sti_fill_acc_rect_cuda
from repro_torch.kernels.sti_megakernel import (
    point_megakernel_cuda, sti_megakernel_cuda)

REPO = Path(__file__).resolve().parents[1]
CPU8 = ["cpu"] * 8
POINT_CASES = [("knn_shapley", {}), ("wknn", {"weights": "rbf"}),
               ("loo", {})]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's engines (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import types

    import jax.numpy as jnp

    import repro  # noqa: F401  (registers the Pallas fills)
    from repro.core import get_method as jget
    from repro.core.sti_knn import sti_knn_interactions
    from repro.core.valuation import DataValuator as JValuator
    from repro.kernels import sti_pipeline as jpipe

    def arrays(*a):
        return tuple(jnp.asarray(v) for v in a)

    return types.SimpleNamespace(
        jnp=jnp, get=jget, oracle=sti_knn_interactions, pipe=jpipe,
        Valuator=JValuator, arrays=arrays)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


def _problem(n, t, seed, dim=3, classes=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, dim)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32),
            rng.normal(size=(t, dim)).astype(np.float32),
            rng.integers(0, classes, t).astype(np.int32))


def _close(got, want, atol=1e-5):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol)


# ------------------------------------------------ interaction parity, 8 shards
@pytest.mark.parametrize("mode", ["sti", "sii"])
@pytest.mark.parametrize("n,k", [(64, 1), (64, 5), (256, 1), (256, 5)])
def test_sharded_matches_fused_and_oracle(jx, n, k, mode):
    """Acceptance: sharded (8 row blocks) == JAX fused == JAX xla oracle
    within 1e-5 at t = 40 over test_batch 16 (a ragged trailing batch)."""
    x, y, xt, yt = _problem(n, 40, seed=n + k)
    ja = jx.arrays(x, y, xt, yt)
    oracle = jx.oracle(*ja, k, mode=mode, fill="xla")
    fused = jx.pipe.fused_sti_knn_interactions(*ja, k, mode=mode,
                                               test_batch=16)
    phi, info = tpipe.sharded_sti_knn_interactions(
        x, y, xt, yt, k, mode=mode, test_batch=16, devices=CPU8,
        return_info=True)
    assert info["shards"] == 8 and info["fill"] == "rect_chunked"
    _close(phi, oracle)
    _close(phi, fused)


@pytest.mark.parametrize("fill", ["cuda", "xla", "megakernel"])
def test_sharded_fill_variants_match_fused(jx, fill):
    """The CUDA rect fill's wrapper (its plain version on the CPU), the xla
    rect oracle and the megakernel branch (one fused step per shard with
    its row offset, plain on the CPU) all match the JAX fused engine."""
    x, y, xt, yt = _problem(64, 29, seed=5, classes=3)
    want = jx.pipe.fused_sti_knn_interactions(*jx.arrays(x, y, xt, yt), 4,
                                              test_batch=8)
    before = (sti_fill_acc_rect_cuda.launches, sti_megakernel_cuda.launches)
    phi, info = tpipe.sharded_sti_knn_interactions(
        x, y, xt, yt, 4, test_batch=8, devices=CPU8, fill=fill,
        return_info=True)
    assert info["fill"] == ("megakernel" if fill == "megakernel"
                            else f"rect_{fill}")
    assert info["distance"] == ("fused" if fill == "megakernel" else "plain")
    _close(phi, want)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (sti_fill_acc_rect_cuda.launches,
            sti_megakernel_cuda.launches) == before


def test_sharded_ragged_stream_and_checkpoint_restore(jx, tmp_path):
    """t = 45 is ragged over 8 shards x test_batch 16, with a mid-stream
    checkpoint restored under 8 shards and again under 4."""
    n, k, t = 64, 5, 45
    x, y, xt, yt = _problem(n, t, seed=7, classes=3)
    oracle = jx.oracle(*jx.arrays(x, y, xt, yt), k, fill="xla")
    sess = ShardedValuationSession(x, y, k=k, test_batch=12, devices=CPU8)
    assert sess.shards == 8 and sess.test_batch == 16
    sess.update(xt[:20], yt[:20])
    ck = sess.checkpoint(tmp_path / "mid")
    for devices in (CPU8, ["cpu"] * 4):
        restored = ShardedValuationSession.restore(ck, x, y, devices=devices)
        assert restored.shards == len(devices) and restored.t_seen == 20
        res = restored.update(xt[20:], yt[20:]).finalize()
        assert res.meta["engine"] == "sharded"
        assert res.meta["shards"] == len(devices) and res.meta["t"] == t
        _close(res.phi, oracle)


def test_sharded_state_is_row_blocked():
    """Per-shard state: exactly (n/8, n) and (n/8,) for the interaction
    methods, (n/8,) for the point methods; finalize leaves it live."""
    n = 64
    x, y, xt, yt = _problem(n, 8, seed=0)
    sess = ShardedValuationSession(x, y, k=3, test_batch=8, devices=CPU8)
    acc, diag = sess._state
    assert [tuple(a.shape) for a in acc] == [(n // 8, n)] * 8
    assert [tuple(d.shape) for d in diag] == [(n // 8,)] * 8
    sess.update(xt, yt)
    first = sess.finalize().phi
    assert [tuple(a.shape) for a in sess._state[0]] == [(n // 8, n)] * 8
    assert torch.equal(sess.finalize().phi, first)
    pts = ShardedValuationSession(x, y, k=3, mode="loo", test_batch=8,
                                  devices=CPU8)
    assert [tuple(v.shape) for v in pts._state[0]] == [(n // 8,)] * 8


# ------------------------------------------------------- shard bookkeeping
def test_shard_count_largest_divisor():
    """The LARGEST divisor of n within the device budget (not a gcd, which
    under-shards non-power-of-two n); a host without a card gives 1."""
    assert shard_count(64, available=8) == 8
    assert shard_count(18, available=8) == 6
    assert shard_count(100, available=8) == 5
    assert shard_count(13, available=8) == 1
    assert shard_count(64, 4, available=8) == 4
    assert shard_count(64, 999, available=8) == 8
    if not torch.cuda.is_available():
        assert shard_count(64) == 1 and shard_count(64, 8) == 1


def test_sharded_rejects_indivisible_n():
    with pytest.raises(ValueError, match="row shards"):
        tpipe.prepare_sharded_step(7, 3, 2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="row shards"):
        tpipe.prepare_sharded_stream_step("loo", 10, 3, 2,
                                          devices=["cpu"] * 4)
    x, y, _, _ = _problem(12, 1, seed=1)
    with pytest.raises(ValueError, match="row shards"):
        ShardedValuationSession(x, y, k=3, devices=["cpu"] * 5)


def test_shard_group_collectives():
    group = ShardGroup(("cpu",) * 4)
    parts = [torch.full((2, 3), float(i)) for i in range(4)]
    gathered = group.all_gather(parts)
    assert len(gathered) == 4
    assert torch.equal(gathered[2], torch.cat(parts))
    scattered = group.reduce_scatter(
        [torch.arange(8.0) * (i + 1) for i in range(4)])
    assert torch.equal(torch.cat(scattered), torch.arange(8.0) * 10)
    assert [tuple(s.shape) for s in scattered] == [(2,)] * 4
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(gather_rows(shard_rows(x, group), group), x)
    assert all(r is x for r in replicate(x, group))
    with pytest.raises(ValueError, match="split evenly"):
        shard_rows(torch.zeros(6), group)
    with pytest.raises(ValueError, match="at least one"):
        ShardGroup(())


# ------------------------------------------------- single-shard fallback
def test_single_shard_fallback_matches_oracle(jx):
    x, y, xt, yt = _problem(32, 13, seed=0)
    want = jx.oracle(*jx.arrays(x, y, xt, yt), 3, fill="xla")
    for kw in (dict(shards=1, device="cpu"), dict(devices=["cpu"]),
               dict(device="cpu")):  # no card here: shards clamp to 1
        phi, info = tpipe.sharded_sti_knn_interactions(
            x, y, xt, yt, 3, test_batch=4, return_info=True, **kw)
        assert info["shards"] == 1 and info["fill"] == "chunked"
        _close(phi, want)


def test_single_shard_fallback_drops_rect_fill_params(jx):
    """A sharded call carrying hints the square fill cannot take runs
    unchanged on one shard: the fallback drops them, as the JAX engine
    does for its rect block shapes."""
    x, y, xt, yt = _problem(32, 9, seed=6)
    ja = jx.arrays(x, y, xt, yt)
    want = jx.oracle(*ja, 3, fill="xla")
    jphi, jinfo = jx.pipe.sharded_sti_knn_interactions(
        *ja, 3, test_batch=4, shards=1, fill="pallas",
        fill_params={"block_rows": 8, "block_t": 2}, return_info=True)
    phi, info = tpipe.sharded_sti_knn_interactions(
        x, y, xt, yt, 3, test_batch=4, shards=1, device="cpu",
        fill="chunked", fill_params={"chunk": 2, "block_rows": 8},
        return_info=True)
    assert info["shards"] == jinfo["shards"] == 1
    assert info["fill"] == "chunked"
    _close(phi, want)
    _close(phi, jphi)
    with pytest.raises(ValueError, match="does not accept"):
        tpipe.sharded_sti_knn_interactions(
            x, y, xt, yt, 3, test_batch=4, devices=["cpu"] * 2,
            fill="chunked", fill_params={"block_rows": 8})


def test_single_shard_session_checkpoint_roundtrip(jx, tmp_path):
    x, y, xt, yt = _problem(24, 9, seed=4, dim=2)
    sess = ShardedValuationSession(x, y, k=3, test_batch=4, shards=1,
                                   device="cpu")
    assert sess.shards == 1 and sess.group is None
    sess.update(xt[:5], yt[:5])
    ck = sess.checkpoint(tmp_path / "ck")
    restored = ShardedValuationSession.restore(ck, x, y, device="cpu")
    res = restored.update(xt[5:], yt[5:]).finalize()
    assert res.meta["shards"] == 1 and res.meta["engine"] == "sharded"
    _close(res.phi, jx.oracle(*jx.arrays(x, y, xt, yt), 3, fill="xla"))


def test_device_list_wins_over_device():
    """With devices=, the session lives on the first shard's device and
    the default device="cuda" is not resolved (no card is needed)."""
    x, y, _, _ = _problem(16, 1, seed=2)
    sess = ShardedValuationSession(x, y, k=3, devices=["cpu"] * 2)
    assert sess.device == torch.device("cpu") and sess.shards == 2
    with pytest.raises(ValueError, match="at least one"):
        ShardedValuationSession(x, y, k=3, devices=[])


# ------------------------------------------------------- whole methods
@pytest.mark.parametrize("method,opts", POINT_CASES)
def test_point_methods_sharded_match_jax_streamed(jx, method, opts):
    """Every point method on 8 shards, three-stage (the registry's sharded
    engine) and megakernel (a sharded session, plain on the CPU), against
    the JAX streamed engine within 1e-5."""
    x, y, xt, yt = _problem(64, 21, seed=len(method), classes=3)
    want = jx.get(method)(*jx.arrays(x, y, xt, yt), k=4, engine="streamed",
                          test_batch=8, **opts).point_values
    got = get_method(method)(x, y, xt, yt, k=4, engine="sharded",
                             devices=CPU8, test_batch=8, **opts)
    assert got.meta["engine"] == "sharded" and got.meta["shards"] == 8
    assert got.meta["test_batch"] == 8 and got.meta["distance"] == "plain"
    _close(got.point_values, want)
    before = point_megakernel_cuda.launches
    sess = ShardedValuationSession(x, y, k=4, mode=method, test_batch=8,
                                   fill="megakernel", method_opts=opts,
                                   devices=CPU8)
    assert sess._resolved["fill"] == "megakernel"
    _close(sess.update(xt, yt).finalize().point_values, want)
    assert point_megakernel_cuda.launches == before


@pytest.mark.parametrize("mode", ["sti", "sii"])
def test_interaction_methods_via_registry(jx, mode):
    """get_method(m)(..., engine="sharded") carries the JAX result's meta
    and matches the JAX fused engine, three-stage and megakernel."""
    x, y, xt, yt = _problem(64, 24, seed=3)
    want = jx.get(mode)(*jx.arrays(x, y, xt, yt), k=5, engine="fused",
                        test_batch=8).phi
    for fill in ("auto", "megakernel"):
        got = get_method(mode)(x, y, xt, yt, k=5, engine="sharded",
                               test_batch=8, devices=CPU8, fill=fill)
        meta = got.meta
        assert meta["engine"] == "sharded" and meta["shards"] == 8
        assert meta["test_batch"] == 8 and meta["streamed"]
        assert meta["fill"] == ("megakernel" if fill == "megakernel"
                                else "rect_chunked")
        assert meta["distance"] == ("fused" if fill == "megakernel"
                                    else "plain")
        _close(got.phi, want)


def test_shard_options_need_the_sharded_engine():
    x, y, xt, yt = _problem(16, 4, seed=8)
    for method in ("sti", "knn_shapley"):
        for kw in (dict(shards=2), dict(devices=["cpu"] * 2)):
            with pytest.raises(ValueError, match="only meaningful"):
                get_method(method)(x, y, xt, yt, k=3, device="cpu", **kw)


# -------------------------------------------------------- DataValuator
def test_datavaluator_matches_jax(jx):
    x, y, xt, yt = _problem(32, 10, seed=12)
    ja = jx.arrays(x, y, xt, yt)
    jdv = jx.Valuator(k=3, fill="chunked")
    dv = DataValuator(k=3, fill="chunked", device="cpu")
    _close(dv.interaction_matrix(x, y, xt, yt),
           jdv.interaction_matrix(*ja))
    _close(dv.shapley_values(x, y, xt, yt), jdv.shapley_values(*ja))
    _close(dv.loo(x, y, xt, yt), jdv.loo(*ja))
    got, want = dv.run(x, y, xt, yt, method="wknn"), jdv.run(*ja,
                                                            method="wknn")
    assert got.method == want.method == "wknn"
    _close(got.point_values, want.point_values)
    sess = dv.session(x, y)
    assert type(sess) is ValuationSession
    _close(sess.update(xt, yt).finalize().phi, jdv.interaction_matrix(*ja))
    with pytest.raises(ValueError, match="engine='sharded'"):
        dv.session(x, y, shards=2)


def test_datavaluator_sharded_session_and_embedding(jx):
    """engine="sharded" opens a sharded session (8 row blocks here); the
    embedding applies to train and test features alike."""
    x, y, xt, yt = _problem(32, 10, seed=13)
    ja = jx.arrays(x, y, xt, yt)
    want = jx.Valuator(k=3, engine="sharded").session(*ja[:2]).update(
        *ja[2:]).finalize().phi
    shift = lambda a: a + 1.0  # distance-preserving: the same result
    dv = DataValuator(k=3, engine="sharded", embed_fn=shift, device="cpu")
    sess = dv.session(x, y, devices=CPU8)
    assert isinstance(sess, ShardedValuationSession) and sess.shards == 8
    _close(sess.update(xt, yt).finalize().phi, want)
    res = dv.run(x, y, xt, yt, devices=CPU8)
    assert res.meta["engine"] == "sharded" and res.meta["shards"] == 8
    _close(res.phi, want)
    # the valuator's interaction engine does not leak into a point method
    pts = dv.run(x, y, xt, yt, method="knn_shapley")
    assert pts.meta["engine"] == "sharded"
    with pytest.raises(ValueError, match="engine"):
        DataValuator(mode="loo", engine="fused")


@pytest.mark.parametrize("method,fill", [("sti", "auto"),
                                         ("knn_shapley", "megakernel")])
def test_launcher_runs_the_sharded_engine(monkeypatch, capsys, method,
                                          fill):
    """`--devices cpu` with `--shards 8`: one name repeated per shard."""
    from repro_torch.launch import valuate

    monkeypatch.setattr(sys, "argv", [
        "valuate", "--device", "cpu", "--engine", "sharded", "--shards",
        "8", "--devices", "cpu", "--n", "64", "--t", "16", "--test-batch",
        "8", "--method", method, "--fill", fill])
    valuate.main()
    out = capsys.readouterr().out
    assert f"{method} (sharded" in out and "shards=8" in out, out
    assert "efficiency gap" in out


# ---------------------------------------- JAX's own sharded engine, 8 devices
_SUBPROCESS = """
import os, tempfile
import numpy as np
import jax, jax.numpy as jnp
import repro
from repro.core.session import ShardedValuationSession as JSession
from repro.core.sti_knn import sti_knn_interactions
from repro.kernels.sti_pipeline import sharded_sti_knn_interactions as jsharded
from repro_torch.core.session import ShardedValuationSession as TSession
from repro_torch.kernels.sti_pipeline import sharded_sti_knn_interactions

assert jax.device_count() == 8
D = ["cpu"] * 8

def problem(n, t, seed, classes=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32),
            rng.normal(size=(t, 3)).astype(np.float32),
            rng.integers(0, classes, t).astype(np.int32))

def close(a, b):
    a = a.numpy() if hasattr(a, "numpy") and not hasattr(a, "block_until_ready") else np.asarray(a)
    err = float(np.abs(a - np.asarray(b)).max())
    assert err <= 1e-5, err
    return err

for n, k, mode in ((64, 5, "sti"), (256, 1, "sii")):
    x, y, xt, yt = problem(n, 40, n + k)
    want, jinfo = jsharded(*map(jnp.asarray, (x, y, xt, yt)), k, mode=mode,
                           test_batch=16, return_info=True)
    got, info = sharded_sti_knn_interactions(x, y, xt, yt, k, mode=mode,
                                             test_batch=16, devices=D,
                                             return_info=True)
    assert jinfo["shards"] == info["shards"] == 8, (jinfo, info)
    assert jinfo["fill"] == info["fill"] == "rect_chunked", (jinfo, info)
    print("parity", n, k, mode, close(got, want))

# mid-stream checkpoints cross-load both ways (t = 45 is ragged)
n, k, t = 64, 5, 45
x, y, xt, yt = problem(n, t, 7, classes=3)
jx_, jy, jxt, jyt = map(jnp.asarray, (x, y, xt, yt))
oracle = np.asarray(sti_knn_interactions(jx_, jy, jxt, jyt, k, fill="xla"))
with tempfile.TemporaryDirectory() as td:
    for mode in ("sti", "knn_shapley"):
        ref = (oracle if mode == "sti" else np.asarray(
            repro.get_method(mode)(jx_, jy, jxt, jyt, k=k,
                                   test_batch=16).point_values))
        js = JSession(jx_, jy, k=k, mode=mode, test_batch=16)
        ck = js.update(jxt[:20], jyt[:20]).checkpoint(
            os.path.join(td, "jax_" + mode))
        ts = TSession.restore(ck, x, y, devices=D)
        assert ts.shards == 8 and ts.t_seen == 20
        res = ts.update(xt[20:], yt[20:]).finalize()
        out = res.phi if mode == "sti" else res.point_values
        print("jax->port", mode, close(out, ref))
        ts2 = TSession(x, y, k=k, mode=mode, test_batch=16, devices=D)
        ck2 = ts2.update(xt[:20], yt[:20]).checkpoint(
            os.path.join(td, "port_" + mode))
        js2 = JSession.restore(ck2, jx_, jy)
        assert js2.shards == 8 and js2.t_seen == 20
        res2 = js2.update(jxt[20:], jyt[20:]).finalize()
        out2 = res2.phi if mode == "sti" else res2.point_values
        print("port->jax", mode, close(np.asarray(out2), ref))
print("ok")
"""


def test_port_matches_jax_sharded_and_checkpoints_cross_load():
    """One subprocess with 8 forced host devices (JAX locks the device
    count at first use): the port's sharded engine against JAX's
    `sharded_sti_knn_interactions`, and mid-stream sharded checkpoints
    (sti and knn_shapley) written by each package finished by the
    other, within 1e-5 of the reference."""
    pytest.importorskip("jax")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_SUBPROCESS)],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.strip().endswith("ok"), p.stdout


# ---------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sti", "sii"])
@pytest.mark.parametrize("fill", ["auto", "megakernel"])
def test_cuda_two_step_sharded_session_matches_single_device(cuda, mode,
                                                             fill):
    """Two steps on four shards of one card against the single-device
    session and against the plain versions (the same sharded session on
    CPU tensors): the rect kernel (or the megakernel at each row offset)
    launches once per shard per step, and the values agree within 1e-6
    of their largest |value| (sums of g and of the diagonal round in
    another order). Integer features make every distance exact, so the
    ranks agree on both sides."""
    rng = np.random.default_rng(3)
    x = rng.integers(-8, 9, (1024, 16)).astype(np.float32)
    xt = rng.integers(-8, 9, (48, 16)).astype(np.float32)
    y, yt = rng.integers(0, 3, 1024), rng.integers(0, 3, 48)
    counter = (sti_megakernel_cuda if fill == "megakernel"
               else sti_fill_acc_rect_cuda)
    before = counter.launches
    sess = ShardedValuationSession(x, y, k=5, mode=mode, test_batch=24,
                                   fill=fill, devices=[cuda] * 4)
    got = sess.update(xt, yt).finalize().phi
    assert counter.launches == before + 2 * 4
    assert sess._resolved["fill"] == ("megakernel" if fill == "megakernel"
                                      else "rect_cuda")
    want = ValuationSession(x, y, k=5, mode=mode, test_batch=24,
                            fill=fill, device=cuda).update(
        xt, yt).finalize().phi
    plain = ShardedValuationSession(x, y, k=5, mode=mode, test_batch=24,
                                    fill=fill, devices=["cpu"] * 4).update(
        xt, yt).finalize().phi
    torch.cuda.synchronize()
    tol = 1e-6 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    torch.testing.assert_close(got.cpu(), plain, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("method,opts", POINT_CASES)
def test_cuda_sharded_point_session_matches_single_device(cuda, method,
                                                          opts):
    x, y, xt, yt = _problem(1000, 30, seed=4, dim=8, classes=3)
    for fill in ("auto", "megakernel"):
        got = ShardedValuationSession(
            x, y, k=5, mode=method, test_batch=16, fill=fill,
            method_opts=opts, distance="cuda",
            devices=[cuda] * 4).update(xt, yt).finalize().point_values
        want = ValuationSession(
            x, y, k=5, mode=method, test_batch=16, fill=fill,
            method_opts=opts, distance="cuda",
            device=cuda).update(xt, yt).finalize().point_values
        torch.cuda.synchronize()
        tol = 1e-6 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_fill_hint_warning_for_square_only_names():
    """A square fill name with no rect twin runs the chunked rect scan on
    the sharded engine, with a warning."""
    x, y, xt, yt = _problem(16, 4, seed=9)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sess = ShardedValuationSession(x, y, k=3, test_batch=4,
                                       fill="onehot", devices=["cpu"] * 2)
    assert sess._resolved["fill"] == "rect_chunked"
    assert any("no rectangular variant" in str(w.message) for w in caught)


# -------------------------------------------- restore onto another backend
def test_restore_keeps_only_fills_of_the_restoring_backend(tmp_path):
    """A recorded fill is kept only where it names a fill of the restoring
    backend ("megakernel" runs on both); "cuda" recorded, then restored on
    the CPU, resolves anew to the chunked fill, and a CPU fill restored on
    a card would resolve anew to the card's kernel."""
    from repro_torch.core.session import _restorable_fill

    assert _restorable_fill("cuda", "cuda")
    assert _restorable_fill("megakernel", "cuda")
    assert _restorable_fill("megakernel", "cpu")
    for name in ("chunked", "onehot", "xla", "rect_cuda", "rect_chunked",
                 None):
        assert not _restorable_fill(name, "cuda")
    assert _restorable_fill("onehot", "cpu")
    assert not _restorable_fill("cuda", "cpu")
    x, y, xt, yt = _problem(24, 8, seed=12)
    want = ValuationSession(x, y, k=3, test_batch=4, fill="chunked",
                            device="cpu").update(xt, yt).finalize().phi
    for fill, kept in (("cuda", "chunked"), ("onehot", "onehot")):
        sess = ValuationSession(x, y, k=3, test_batch=4, fill=fill,
                                device="cpu")
        ck = sess.update(xt[:4], yt[:4]).checkpoint(tmp_path / fill)
        restored = ValuationSession.restore(ck, x, y, device="cpu")
        assert restored._resolved["fill"] == kept
        _close(restored.update(xt[4:], yt[4:]).finalize().phi, want)


@pytest.mark.cuda
def test_cuda_restore_of_a_cpu_checkpoint_runs_the_rect_kernel(cuda,
                                                                tmp_path):
    """A single-device CPU checkpoint records "chunked"; restored on four
    shards of the card it runs the CUDA rect kernel, not the plain scan."""
    x, y, xt, yt = _problem(256, 16, seed=13, dim=4)
    sess = ValuationSession(x, y, k=5, test_batch=8, device="cpu")
    assert sess._resolved["fill"] == "chunked"
    ck = sess.update(xt[:8], yt[:8]).checkpoint(tmp_path / "cpu")
    want = sess.update(xt[8:], yt[8:]).finalize().phi
    before = sti_fill_acc_rect_cuda.launches
    restored = ShardedValuationSession.restore(ck, x, y, devices=[cuda] * 4)
    assert restored._resolved["fill"] == "rect_cuda"
    got = restored.update(xt[8:], yt[8:]).finalize().phi
    assert sti_fill_acc_rect_cuda.launches == before + 4
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))
