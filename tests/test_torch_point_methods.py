"""The port's per-point methods (knn_shapley, wknn, loo), their streaming
engine and `ValuationSession` against the JAX package (CPU).

The same numpy inputs go through `repro` and `repro_torch`. Closed forms
agree within 1e-6, whole-method values within 1e-5 (the JAX suite's
cross-engine tolerance), the O(2^n) oracles within 1e-5 at n = 12, and
checkpoints load across the two packages in both directions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401
from repro.core import get_method as jget_method
from repro.core.knn_shapley import knn_shapley_from_sorted as jks
from repro.core.session import ValuationSession as JSession
from repro.core.wknn import distance_weights as jweights
from repro.kernels import stream_kernels as jsk
from repro.kernels import sti_pipeline as jpipe

import repro_torch
from repro_torch.core import get_method
from repro_torch.core.knn_shapley import knn_shapley_from_sorted
from repro_torch.core.session import ValuationSession
from repro_torch.core.wknn import WEIGHT_KINDS, distance_weights
from repro_torch.kernels import stream_kernels as tsk
from repro_torch.kernels import sti_pipeline as tpipe

POINT_CASES = [("knn_shapley", None), ("wknn", {"weights": "rbf"}),
               ("wknn", {"weights": "inverse"}),
               ("wknn", {"weights": "uniform"}), ("loo", None)]


def _problem(n, t, d=4, classes=3, seed=0, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-8, 9, (n, d)).astype(np.float32)
        xt = rng.integers(-8, 9, (t, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        xt = rng.normal(size=(t, d)).astype(np.float32)
    return (x, rng.integers(0, classes, n).astype(np.int32), xt,
            rng.integers(0, classes, t).astype(np.int32))


# ------------------------------------------------------------ closed forms
@pytest.mark.parametrize("n,k", [(1, 3), (5, 5), (17, 3), (64, 1), (40, 7)])
def test_knn_shapley_from_sorted_matches_jax(n, k):
    rng = np.random.default_rng(n * 10 + k)
    m = rng.normal(size=(3, n)).astype(np.float32)
    got = knn_shapley_from_sorted(torch.from_numpy(m), k).numpy()
    np.testing.assert_allclose(got, np.asarray(jks(jnp.asarray(m), k)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", WEIGHT_KINDS)
@pytest.mark.parametrize("sentinels", [False, True])
def test_distance_weights_match_jax(kind, sentinels):
    """All three kinds; with ~1e30 dead-slot distances in a row the rbf
    bandwidth is the mean over the real columns only."""
    rng = np.random.default_rng(7)
    d2 = (rng.normal(size=(4, 30)) ** 2 * 5).astype(np.float32)
    if sentinels:
        d2[1, ::3] = 1e30
        d2[2, :] = 1e30   # a row with no real column: count clamps to 1
    got = distance_weights(torch.from_numpy(d2), kind).numpy()
    want = np.asarray(jweights(jnp.asarray(d2), kind))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_distance_weights_sigma2_override_and_unknown_kind():
    d2 = np.linspace(0, 9, 12, dtype=np.float32).reshape(2, 6)
    s2 = np.asarray([[0.5], [4.0]], np.float32)
    got = distance_weights(torch.from_numpy(d2), "rbf",
                           sigma2=torch.from_numpy(s2)).numpy()
    want = np.asarray(jweights(jnp.asarray(d2), "rbf", sigma2=jnp.asarray(s2)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown weight kind"):
        distance_weights(torch.from_numpy(d2), "gauss")


@pytest.mark.parametrize("method,opts", POINT_CASES)
@pytest.mark.parametrize("n", [3, 40])
def test_megakernel_tables_match_jax(method, opts, n):
    """The sorted-coordinate table closures the megakernels run."""
    rng = np.random.default_rng(n)
    d2s = np.sort(rng.normal(size=(3, n)) ** 2, -1).astype(np.float32)
    ms = rng.integers(0, 2, (3, n)).astype(np.float32)
    mask = np.asarray([1.0, 1.0, 0.0], np.float32)
    got = tsk.make_megakernel_tables(method, 5, opts=opts)(
        torch.from_numpy(d2s), torch.from_numpy(ms), torch.from_numpy(mask))
    want = jsk.make_megakernel_tables(method, 5, opts=opts)(
        jnp.asarray(d2s), jnp.asarray(ms), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert not got[2].any()   # the padded row contributes exactly zero


def test_interaction_megakernel_tables_match_jax():
    rng = np.random.default_rng(3)
    d2s = np.sort(rng.normal(size=(3, 30)) ** 2, -1).astype(np.float32)
    ms = rng.integers(0, 2, (3, 30)).astype(np.float32)
    mask = np.asarray([1.0, 0.0, 1.0], np.float32)
    for mode in ("sti", "sii"):
        got = tsk.make_megakernel_tables(mode, 4)(
            torch.from_numpy(d2s), torch.from_numpy(ms),
            torch.from_numpy(mask))
        want = jsk.make_megakernel_tables(mode, 4)(
            jnp.asarray(d2s), jnp.asarray(ms), jnp.asarray(mask))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    with pytest.raises(KeyError, match="no megakernel tables"):
        tsk.make_megakernel_tables("shapley", 4)


def test_stream_registry_and_point_state():
    assert tsk.stream_methods() == ["knn_shapley", "loo", "sii", "sti",
                                    "wknn"]
    assert tsk.has_stream_kernel("wknn") and not tsk.has_stream_kernel("x")
    spec = tsk.accumulator_spec("loo")
    assert spec is tsk.POINT_STATE and spec.names == ("vec",)
    assert spec.layouts == ("vector",) and spec.kind == "point"
    state = spec.init(6, "cpu")
    state[0].add_(torch.arange(6.0))
    out = spec.result_arrays(state, 4)
    torch.testing.assert_close(out["point_values"], torch.arange(6.0) / 4)
    # the sharded update: per-shard lists, reduce-scattered onto each
    # shard's rows -- the single-device sum, split
    from repro_torch.distributed.sharding import ShardGroup

    group = ShardGroup(("cpu", "cpu"))
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.random((4, 6)).astype(np.float32))
    ranks = torch.stack([torch.randperm(6) for _ in range(4)])
    whole = tsk.make_update_kernel("loo", 3).update(
        spec.init(6, "cpu"), u, None, ranks, None)[0]
    parts = tsk.make_update_kernel("loo", 3, axis=group).update(
        spec.init_shards(6, group), [u[:2], u[2:]], [None, None],
        [ranks[:2], ranks[2:]], None)[0]
    assert [tuple(p.shape) for p in parts] == [(3,), (3,)]
    torch.testing.assert_close(torch.cat(parts), whole)


# --------------------------------------------------------- whole methods
@pytest.mark.parametrize("method,opts", POINT_CASES)
@pytest.mark.parametrize("n,t,tb", [(40, 11, 4), (64, 9, 9), (12, 5, 2)])
def test_stream_point_values_match_jax(method, opts, n, t, tb):
    x, y, xt, yt = _problem(n, t, seed=n + t)
    want = jpipe.stream_point_values(
        method, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt),
        jnp.asarray(yt), 5, test_batch=tb, method_opts=opts)
    got = tpipe.stream_point_values(method, x, y, xt, yt, 5, test_batch=tb,
                                    method_opts=opts, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("method", ["knn_shapley", "wknn", "loo"])
@pytest.mark.parametrize("engine", ["streamed", "eager"])
def test_point_engines_match_jax(method, engine):
    x, y, xt, yt = _problem(30, 7, seed=5)
    kw = {"weights": "inverse"} if method == "wknn" else {}
    want = jget_method(method)(x, y, xt, yt, k=3, engine=engine,
                               test_batch=4, **kw)
    got = get_method(method)(x, y, xt, yt, k=3, engine=engine, test_batch=4,
                             device="cpu", **kw)
    np.testing.assert_allclose(got.point_values.numpy(),
                               np.asarray(want.point_values), atol=1e-5)
    np.testing.assert_allclose(got.values().numpy(),
                               np.asarray(want.values()), atol=1e-5)
    assert got.phi is None and got.meta["engine"] == engine
    assert got.meta["method"] == method and got.meta["backend"] == "cpu"
    assert got.meta["streamed"] == (engine == "streamed")
    if engine == "streamed":
        assert got.meta["distance"] == "plain"


@pytest.mark.parametrize("method,weights", [("knn_shapley", None),
                                            ("wknn", "rbf"),
                                            ("wknn", "inverse")])
def test_point_engines_match_oracle_at_n12(method, weights):
    """The O(2^n) definitions at n = 12: the oracle engine, and the
    streamed engine against it, within 1e-5."""
    from repro_torch.core.sti_baseline import (
        brute_force_shapley, brute_force_wknn_shapley)

    x, y, xt, yt = _problem(12, 5, classes=2, seed=12, integer=True)
    kw = {} if weights is None else {"weights": weights}
    want = (brute_force_shapley(x, y, xt, yt, 3) if weights is None
            else brute_force_wknn_shapley(x, y, xt, yt, 3, **kw))
    for engine in ("oracle", "streamed"):
        got = get_method(method)(x, y, xt, yt, k=3, engine=engine,
                                 device="cpu", **kw)
        np.testing.assert_allclose(got.point_values.numpy(), want,
                                   atol=1e-5)


def test_point_method_option_errors():
    x, y, xt, yt = _problem(20, 3, seed=2)
    with pytest.raises(ValueError, match="valid engines"):
        get_method("loo")(x, y, xt, yt, engine="oracle", device="cpu")
    with pytest.raises(ValueError, match="valid engines"):
        get_method("knn_shapley")(x, y, xt, yt, engine="scan",
                                  device="cpu")
    with pytest.raises(ValueError, match="only meaningful"):
        get_method("knn_shapley")(x, y, xt, yt, shards=2, device="cpu")
    with pytest.raises(ValueError, match="does not accept"):
        get_method("knn_shapley")(x, y, xt, yt, fill="megakernel",
                                  device="cpu")
    with pytest.raises(ValueError, match="do not apply"):
        get_method("wknn")(x[:8], y[:8], xt, yt, engine="oracle",
                           test_batch=4, device="cpu")
    with pytest.raises(ValueError, match="n=20 > 16"):
        get_method("wknn")(x, y, xt, yt, engine="oracle", device="cpu")
    with pytest.raises(ValueError, match="not point values"):
        tpipe.stream_point_values("sti", x, y, xt, yt, 3, device="cpu")


def test_public_wrappers_match_jax():
    from repro.core import knn_shapley_values as jkv
    from repro.core import loo_values as jloo
    from repro.core import wknn_shapley_values as jwv

    x, y, xt, yt = _problem(25, 6, seed=8)
    pairs = [(repro_torch.knn_shapley_values, jkv, {}),
             (repro_torch.loo_values, jloo, {}),
             (repro_torch.wknn_shapley_values, jwv, {"weights": "uniform"})]
    for fn, jfn, kw in pairs:
        got = fn(x, y, xt, yt, 4, test_batch=4, device="cpu", **kw)
        want = jfn(x, y, xt, yt, 4, test_batch=4, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ------------------------------------------------------------- sessions
@pytest.mark.parametrize("mode,opts", [("knn_shapley", None),
                                       ("wknn", {"weights": "rbf"}),
                                       ("loo", None), ("sti", None),
                                       ("sii", None)])
def test_session_matches_jax_session(mode, opts):
    x, y, xt, yt = _problem(36, 10, seed=9)
    jsess = JSession(x, y, k=3, mode=mode, test_batch=4, fill="chunked",
                     distance="xla", method_opts=opts)
    sess = ValuationSession(x, y, k=3, mode=mode, test_batch=4,
                            fill="chunked", method_opts=opts, device="cpu")
    for s in (slice(0, 3), slice(3, 10)):
        jsess.update(xt[s], yt[s])
        sess.update(xt[s], yt[s])
    want, got = jsess.finalize(), sess.finalize()
    assert sess.t_seen == 10 and got.meta["t"] == 10
    attr = "phi" if mode in ("sti", "sii") else "point_values"
    np.testing.assert_allclose(getattr(got, attr).numpy(),
                               np.asarray(getattr(want, attr)), atol=1e-5)
    # finalize is a snapshot: the session stays live and consistent
    sess.update(xt[0], yt[0])
    again = sess.finalize()
    assert again.meta["t"] == 11
    jsess.update(xt[0:1], yt[0:1])
    np.testing.assert_allclose(getattr(again, attr).numpy(),
                               np.asarray(getattr(jsess.finalize(), attr)),
                               atol=1e-5)


def test_session_errors_and_set_train():
    x, y, xt, yt = _problem(20, 4, seed=1)
    with pytest.raises(ValueError, match="unknown mode"):
        ValuationSession(x, y, mode="banzhaf", device="cpu")
    sess = ValuationSession(x, y, k=3, mode="knn_shapley", device="cpu")
    with pytest.raises(ValueError, match="call update"):
        sess.finalize()
    with pytest.raises(ValueError, match="test batch must be"):
        sess.update(xt[:, :2], yt)
    with pytest.raises(ValueError, match="keep the train shape"):
        sess.set_train(x[:10], y[:10])
    x2 = x[::-1].copy()
    y2 = y[::-1].copy()
    sess.set_train(x2, y2)
    got = sess.update(xt, yt).finalize().point_values
    want = tpipe.stream_point_values("knn_shapley", x2, y2, xt, yt, 3,
                                     device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("mode", ["sti", "knn_shapley", "wknn"])
def test_checkpoint_cross_loads_between_packages(tmp_path, mode):
    """A port checkpoint restores in the JAX package and a JAX checkpoint
    in the port; each continues to the uninterrupted stream's result."""
    x, y, xt, yt = _problem(32, 12, seed=4)
    opts = {"weights": "inverse"} if mode == "wknn" else None
    attr = "phi" if mode == "sti" else "point_values"
    ref = JSession(x, y, k=3, mode=mode, test_batch=4, fill="chunked",
                   distance="xla", method_opts=opts)
    want = np.asarray(getattr(ref.update(xt, yt).finalize(), attr))

    sess = ValuationSession(x, y, k=3, mode=mode, test_batch=4,
                            fill="chunked", method_opts=opts, device="cpu")
    sess.update(xt[:5], yt[:5])
    p = sess.checkpoint(tmp_path / "port")
    assert p.suffix == ".npz" and not list(tmp_path.glob("*.tmp"))
    jres = JSession.restore(p, x, y)
    assert jres.t_seen == 5 and jres.method_opts == (opts or {})
    got = np.asarray(getattr(jres.update(xt[5:], yt[5:]).finalize(), attr))
    np.testing.assert_allclose(got, want, atol=1e-5)

    jsess = JSession(x, y, k=3, mode=mode, test_batch=4, fill="chunked",
                     distance="xla", method_opts=opts)
    jsess.update(xt[:7], yt[:7])
    jp = jsess.checkpoint(tmp_path / "jax")
    tres = ValuationSession.restore(jp, x, y, device="cpu")
    assert tres.t_seen == 7 and tres._resolved["distance"] == "plain"
    got = getattr(tres.update(xt[7:], yt[7:]).finalize(), attr).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_restore_rejects_a_different_train_size(tmp_path):
    x, y, xt, yt = _problem(16, 4, seed=6)
    sess = ValuationSession(x, y, k=3, mode="loo", device="cpu")
    p = sess.update(xt, yt).checkpoint(tmp_path / "c.npz")
    with pytest.raises(ValueError, match="n=16"):
        ValuationSession.restore(p, x[:8], y[:8], device="cpu")


def test_point_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    x, y, xt, yt = _problem(8, 2, seed=3)
    calls = [
        lambda: get_method("knn_shapley")(x, y, xt, yt, k=3),
        lambda: get_method("wknn")(x, y, xt, yt, k=3, engine="eager"),
        lambda: ValuationSession(x, y, mode="loo"),
        lambda: tpipe.stream_point_values("loo", x, y, xt, yt, 3,
                                          fill="megakernel"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("args,expect", [
    (["--method", "knn_shapley"], "knn_shapley (streamed, fill=None"),
    (["--method", "wknn", "--engine", "eager"], "wknn (eager, fill=None"),
    (["--method", "loo", "--fill", "megakernel"],
     "loo (session, fill=megakernel"),
    (["--method", "sii", "--fill", "megakernel"],
     "sii (fused, fill=megakernel"),
])
def test_launcher_runs_every_method_on_the_cpu(monkeypatch, capsys, args,
                                               expect):
    from repro_torch.launch import valuate

    monkeypatch.setattr("sys.argv", ["valuate", "--device", "cpu", "--n",
                                     "32", "--t", "8", *args])
    valuate.main()
    out = capsys.readouterr().out
    assert expect in out and "mislabel detection" in out
