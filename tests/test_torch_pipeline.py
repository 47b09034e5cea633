"""The port's fused engine and API layer against the JAX package (CPU).

The same numpy inputs go through `repro` and `repro_torch`. Whole-method
values agree within 1e-5 (the JAX suite's cross-engine tolerance), ranks
bit for bit on integer features, data sets and result files exactly.
Pallas runs in interpret mode, so its shapes stay at n <= 64, t <= 16.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401  (registers the Pallas fills)
from repro.core import analysis as janalysis
from repro.core import get_method as jget_method
from repro.core.results import ValuationResult as JResult
from repro.data import synthetic as jsyn
from repro.kernels import sti_pipeline as jpipe
from repro.kernels.distance import distance_pallas

import repro_torch
from repro_torch.core import analysis as tanalysis
from repro_torch.core import get_method
from repro_torch.core.results import ValuationResult
from repro_torch.core.sti_knn import ranks_from_distances
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import sti_pipeline as tpipe
from repro_torch.kernels.stream_kernels import INTERACTION_STATE

REPO = Path(__file__).resolve().parents[1]


def _problem(n, t, d, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-8, 9, (n, d)).astype(np.float32)
        xt = rng.integers(-8, 9, (t, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        xt = rng.normal(size=(t, d)).astype(np.float32)
    return (x, rng.integers(0, 2, n).astype(np.int32), xt,
            rng.integers(0, 2, t).astype(np.int32))


def _jax_fused(x, y, xt, yt, k, **kw):
    return np.asarray(jpipe.fused_sti_knn_interactions(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt), jnp.asarray(yt), k,
        **kw))


# ------------------------------------------------------------ fused engine
@pytest.mark.parametrize("mode", ["sti", "sii"])
@pytest.mark.parametrize("jax_impl", [
    {"fill": "pallas_interpret", "distance": "pallas_interpret"},
    {"fill": "chunked", "distance": "xla"},
])
def test_fused_matches_jax(mode, jax_impl):
    """t = 13 in batches of 5: the last batch is padded with a zero mask."""
    x, y, xt, yt = _problem(40, 13, 3, 7)
    want = _jax_fused(x, y, xt, yt, 3, mode=mode, test_batch=5,
                      fill_params={"block_n": 16} if "pallas" in
                      jax_impl["fill"] else None, **jax_impl)
    got = tpipe.fused_sti_knn_interactions(x, y, xt, yt, 3, mode=mode,
                                           test_batch=5, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fill,distance", [("cuda", "cuda"),
                                           ("onehot", "plain"),
                                           ("xla", "cuda")])
def test_fused_kernel_names_on_cpu_tensors_match_jax(fill, distance):
    """fill="cuda"/distance="cuda" on CPU tensors run the wrappers' plain
    versions: same values as the JAX chunked pipeline within 1e-5."""
    x, y, xt, yt = _problem(33, 11, 4, 3)
    want = _jax_fused(x, y, xt, yt, 5, test_batch=4, fill="chunked",
                      distance="xla")
    got = tpipe.fused_sti_knn_interactions(
        x, y, xt, yt, 5, test_batch=4, fill=fill, distance=distance,
        device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tb", [1, 4, 16])
def test_ragged_batches_contribute_exactly_their_points(tb):
    """Padding rows carry mask 0, so any batch split gives the same phi
    as one batch holding every test point (within f32 summation order)."""
    x, y, xt, yt = _problem(24, 9, 2, 5)
    whole = tpipe.fused_sti_knn_interactions(x, y, xt, yt, 3, test_batch=9,
                                             device="cpu")
    split = tpipe.fused_sti_knn_interactions(x, y, xt, yt, 3, test_batch=tb,
                                             device="cpu")
    torch.testing.assert_close(split, whole, rtol=1e-6, atol=1e-6)


def test_pad_test_batch():
    xb, yb = torch.ones(3, 2), torch.tensor([1, 0, 1], dtype=torch.int32)
    xp, yp, mask = tpipe.pad_test_batch(xb, yb, 5)
    assert xp.shape == (5, 2) and yp.shape == (5,) and yp.dtype == yb.dtype
    assert mask.tolist() == [1.0, 1.0, 1.0, 0.0, 0.0]
    assert torch.equal(xp[3:], torch.zeros(2, 2))
    xs, ys, ms = tpipe.pad_test_batch(xb, yb, 3)
    assert xs is xb and ms.tolist() == [1.0, 1.0, 1.0]
    with pytest.raises(ValueError, match="exceeds"):
        tpipe.pad_test_batch(xb, yb, 2)


def test_ranks_bit_equal_on_integer_features():
    """Integer features in [-8, 8]: every product is exact in f32, so the
    port's distances and ranks equal the Pallas kernel's bit for bit."""
    x, _, xt, _ = _problem(64, 16, 24, 9, integer=True)
    d2j = np.asarray(distance_pallas(jnp.asarray(xt), jnp.asarray(x),
                                     block_t=16, block_n=16, block_d=64,
                                     interpret=True))
    from repro_torch.kernels.distance import distance_cuda

    d2t = distance_cuda(torch.from_numpy(xt), torch.from_numpy(x))
    np.testing.assert_array_equal(d2t.numpy(), d2j)
    from repro.core.sti_knn import ranks_from_distances as jranks

    np.testing.assert_array_equal(
        ranks_from_distances(d2t).numpy(),
        np.asarray(jranks(jnp.asarray(d2j))))


def test_state_handoff_from_jax_mid_stream():
    """Batch 1 folds in JAX, its (acc, diag) cross as numpy arrays, batch
    2 folds in the port: equal to a whole-JAX run within 1e-5."""
    x, y, xt, yt = _problem(30, 10, 3, 13)
    tb, k = 6, 3
    jstep, _ = jpipe.prepare_fused_step(30, 3, k, test_batch=tb,
                                        fill="chunked", distance="xla")
    xb, yb, mask = jpipe.pad_test_batch(xt[:tb], yt[:tb], tb)
    acc, diag = jstep(jnp.zeros((30, 30), jnp.float32),
                      jnp.zeros((30,), jnp.float32), xb, yb, mask,
                      jnp.asarray(x), jnp.asarray(y))
    state = tpipe.interaction_state_from_numpy(np.asarray(acc),
                                               np.asarray(diag), "cpu")
    tstep, resolved = tpipe.prepare_fused_step(30, 3, k, test_batch=tb,
                                               device="cpu")
    assert resolved == {"fill": "chunked", "distance": "plain"}
    xb2, yb2, mask2 = tpipe.pad_test_batch(torch.from_numpy(xt[tb:]),
                                           torch.from_numpy(yt[tb:]), tb)
    state = tstep(*state, xb2, yb2, mask2, torch.from_numpy(x),
                  torch.from_numpy(y))
    got = INTERACTION_STATE.result_arrays(state, 10)["phi"]
    want = _jax_fused(x, y, xt, yt, k, test_batch=tb, fill="chunked",
                      distance="xla")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tpipe.interaction_state_from_numpy(np.zeros((4, 5)), np.zeros(4),
                                           "cpu")


def test_resolve_distance():
    assert tpipe.resolve_distance("auto", 8, 64, 3, backend="cpu") == "plain"
    assert tpipe.resolve_distance("auto", 8, 64, 3, backend="cuda") == "cuda"
    assert tpipe.resolve_distance("plain", 8, 64, 3) == "plain"
    with pytest.raises(ValueError, match="unknown distance"):
        tpipe.resolve_distance("pallas", 8, 64, 3)


@pytest.mark.parametrize("case", ["float64", "int64", "noncontig",
                                  "bfloat16"])
def test_fused_features_pass_the_distance_wrappers_checks(monkeypatch, case):
    """Features of any numeric dtype and layout reach the distance wrapper
    as two contiguous float32 (or two bfloat16) tensors. A spy runs the
    wrapper's own argument checks on the CPU, which the wrapper skips
    there. Integer features in [-8, 8] are exact in every dtype here, so
    phi equals the float32 run's bit for bit."""
    from repro_torch.kernels import distance as tdist

    x, y, xt, yt = _problem(20, 7, 3, 41, integer=True)
    want = tpipe.fused_sti_knn_interactions(x, y, xt, yt, 3, test_batch=4,
                                            distance="plain", device="cpu")
    if case in ("float64", "int64"):
        xa, xta = x.astype(case), xt.astype(case)
    elif case == "noncontig":  # transposed views of column-major copies
        xa = torch.from_numpy(np.ascontiguousarray(x.T)).T
        xta = torch.from_numpy(np.ascontiguousarray(xt.T)).T
        assert not (xa.is_contiguous() or xta.is_contiguous())
    else:
        xa = torch.from_numpy(x).to(torch.bfloat16)
        xta = torch.from_numpy(xt).to(torch.bfloat16)
    seen = []

    def spy(xb, x_train):
        tdist._check(xb, x_train)
        seen.append(xb.dtype)
        return tdist.distance_plain(xb, x_train)

    tpipe.make_fused_step.cache_clear()
    monkeypatch.setattr(tdist, "distance_cuda", spy)
    try:
        got = tpipe.fused_sti_knn_interactions(
            xa, y, xta, yt, 3, test_batch=4, distance="cuda", device="cpu")
    finally:
        tpipe.make_fused_step.cache_clear()
    want_dtype = torch.bfloat16 if case == "bfloat16" else torch.float32
    assert seen == [want_dtype, want_dtype]
    assert torch.equal(got, want)


# ---------------------------------------------------------------- API layer
@pytest.mark.parametrize("method", ["sti", "sii"])
@pytest.mark.parametrize("engine", ["fused", "scan"])
def test_get_method_matches_jax(method, engine):
    x, y, xt, yt = _problem(28, 7, 3, 17)
    want = jget_method(method)(x, y, xt, yt, k=3, engine=engine,
                               test_batch=4, fill="chunked")
    got = get_method(method)(x, y, xt, yt, k=3, engine=engine, test_batch=4,
                             device="cpu")
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(want.phi),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.values().numpy(),
                               np.asarray(want.values()), rtol=1e-5,
                               atol=1e-5)
    assert got.meta["engine"] == engine and got.meta["method"] == method
    assert got.meta["fill"] == "chunked" and got.meta["backend"] == "cpu"
    assert got.meta["resolved_fill"] == "chunked"
    if engine == "fused":
        assert got.meta["distance"] == "plain" and got.meta["streamed"]


def test_registry_errors_and_listing():
    assert repro_torch.list_methods() == ["knn_shapley", "loo", "sii", "sti",
                                          "wknn"]
    # the reference's table (src/repro/core/methods.py), every engine
    # ported
    assert repro_torch.ENGINES == {
        "sti": ("fused", "scan", "distributed", "sharded", "approx"),
        "sii": ("fused", "scan", "distributed", "sharded", "approx"),
        "knn_shapley": ("streamed", "eager", "sharded", "approx", "oracle"),
        "wknn": ("streamed", "eager", "sharded", "approx", "oracle"),
        "loo": ("streamed", "eager", "sharded", "approx"),
    }
    x, y, xt, yt = _problem(8, 2, 2, 1)
    # engines a method does not have are refused, not emulated
    for method, engine in (("wknn", "fused"), ("loo", "oracle")):
        with pytest.raises(ValueError, match="valid engines"):
            get_method(method)(x, y, xt, yt, k=3, engine=engine,
                               device="cpu")
    with pytest.raises(ValueError, match="unknown valuation method"):
        get_method("banzhaf")


def test_get_method_matches_oracle():
    """The O(2^n) definition at n = 11 through the registry, within 1e-5."""
    from repro_torch.core.sti_baseline import brute_force_sii, brute_force_sti

    x, y, xt, yt = _problem(11, 5, 2, 23, integer=True)
    for method, oracle in (("sti", brute_force_sti), ("sii", brute_force_sii)):
        got = get_method(method)(x, y, xt, yt, k=3, device="cpu")
        np.testing.assert_allclose(got.phi.numpy(),
                                   oracle(x, y, xt, yt, 3), atol=1e-5)


def test_analysis_matches_jax():
    x, y, xt, yt = _problem(20, 6, 2, 29)
    phi_t = get_method("sti")(x, y, xt, yt, k=3, device="cpu").phi
    phi = np.asarray(phi_t)
    jphi = jnp.asarray(phi)
    labels = y
    np.testing.assert_allclose(
        float(tanalysis.efficiency_gap(phi_t, 0.7)),
        float(janalysis.efficiency_gap(jphi, 0.7)), rtol=1e-5, atol=1e-6)
    for name in ("in_class_mean", "out_class_mean", "diag_mean_per_class"):
        np.testing.assert_allclose(
            np.asarray(getattr(tanalysis.class_block_summary(
                phi_t, torch.from_numpy(labels), 2), name)),
            np.asarray(getattr(janalysis.class_block_summary(
                jphi, jnp.asarray(labels), 2), name)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        tanalysis.mislabel_scores(phi_t, torch.from_numpy(labels), 2).numpy(),
        np.asarray(janalysis.mislabel_scores(jphi, jnp.asarray(labels), 2)),
        rtol=1e-5, atol=1e-7)
    vals = np.random.default_rng(0).normal(size=15).astype(np.float32)
    np.testing.assert_array_equal(
        tanalysis.summarize_keep_order(torch.from_numpy(vals)).numpy(),
        np.asarray(janalysis.summarize_keep_order(jnp.asarray(vals))))


def test_efficiency_gap_blocks_rows(monkeypatch):
    """The float64 row-block sum equals one upper-triangle sum."""
    monkeypatch.setattr(tanalysis, "_GAP_ROWS", 3)
    phi = torch.randn(10, 10)
    want = abs(float(torch.triu(phi).double().sum()) - 0.25)
    assert float(tanalysis.efficiency_gap(phi, 0.25)) == pytest.approx(
        want, rel=1e-12)


def test_result_files_cross_load(tmp_path):
    x, y, xt, yt = _problem(16, 4, 2, 37)
    ours = get_method("sti")(x, y, xt, yt, k=3, device="cpu")
    path = ours.save(tmp_path / "port")
    theirs = JResult.load(path)
    np.testing.assert_array_equal(np.asarray(theirs.phi), ours.phi.numpy())
    assert theirs.method == "sti" and theirs.meta["engine"] == "fused"
    jres = jget_method("sii")(x, y, xt, yt, k=3)
    jres.save(tmp_path / "jax.npz")
    back = ValuationResult.load(tmp_path / "jax")
    assert isinstance(back.phi, torch.Tensor) and back.method == "sii"
    np.testing.assert_array_equal(back.phi.numpy(), np.asarray(jres.phi))
    assert back.meta["engine"] == "fused"
    assert back.summary()["values_mean"] == pytest.approx(
        jres.summary()["values_mean"], rel=1e-6)


def test_synthetic_data_bit_identical():
    for tf, jf, args in (
        (tsyn.make_circles, jsyn.make_circles, (16, 0.08, 3)),
        (tsyn.make_gaussian_blobs, jsyn.make_gaussian_blobs, (10, 3, 5)),
    ):
        (xa, ya), (xb, yb) = tf(*args), jf(*args)
        np.testing.assert_array_equal(xa.numpy(), np.asarray(xb))
        np.testing.assert_array_equal(ya.numpy(), np.asarray(yb))
        assert xa.dtype == torch.float32 and ya.dtype == torch.int32
    y = np.arange(40, dtype=np.int32) % 3
    (ya, ma), (yb, mb) = (tsyn.flip_labels(torch.from_numpy(y), 0.2, 3, 4),
                          jsyn.flip_labels(jnp.asarray(y), 0.2, 3, 4))
    np.testing.assert_array_equal(ya.numpy(), np.asarray(yb))
    np.testing.assert_array_equal(ma.numpy(), np.asarray(mb))


# ----------------------------------------------- isolation and device rules
def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


def test_import_leaves_no_jax_or_repro_module():
    code = (
        "import sys, repro_torch, repro_torch.launch.valuate, "
        "repro_torch.kernels.build, repro_torch.configs.sti_knn_paper, "
        "repro_torch.distributed.sharding, repro_torch.core.valuation, "
        "repro_torch.kernels.sti_fill, repro_torch.kernels.autotune, "
        "repro_torch.models, repro_torch.serving.engine, "
        "repro_torch.launch.serve, repro_torch.kernels.flash_attention, "
        "repro_torch.launch.specs, repro_torch.launch.mesh, "
        "repro_torch.launch.train, repro_torch.training.optimizer, "
        "repro_torch.training.compression, repro_torch.training.trainer, "
        "repro_torch.data.pipeline, repro_torch.models.moe, "
        "repro_torch.models.ssm, repro_torch.configs.mixtral_8x7b, "
        "repro_torch.configs.phi35_moe, repro_torch.configs.xlstm_1_3b, "
        "repro_torch.configs.jamba_v01, repro_torch.models.whisper, "
        "repro_torch.configs.whisper_small, repro_torch.configs.internvl2_2b, "
        "repro_torch.configs.shapes, repro_torch.configs.registry, "
        "repro_torch.analysis, repro_torch.analysis.contracts, "
        "repro_torch.analysis.rules, repro_torch.launch.lint, "
        "repro_torch.launch.hlo_analysis, repro_torch.launch.dryrun\n"
        "bad = [m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    p = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for nm in names:
                assert nm.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                    f"{f} imports {nm}")


def test_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    x, y, xt, yt = _problem(8, 2, 2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_method("sti")(x, y, xt, yt, k=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.fused_sti_knn_interactions(x, y, xt, yt, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.sti_knn_interactions(x, y, xt, yt, 3)
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.valuate", "--n", "16",
         "--t", "4"], env=_env(), cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and "no CUDA device" in p.stderr


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
