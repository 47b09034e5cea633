"""The port's valuation launcher against the JAX package's, on the CPU.

Both `main()`s run in this process with `sys.argv` patched, at n = 64,
t = 16, test batches of 8: wknn with each weight kind, sti with
`--stream`, `--stream --engine sharded` (four shards of the CPU on the
port's side; the reference falls back to its fused step on one device),
`--stream --engine approx --top-m 64` (top_m = n: the exact step) and
`--mode sti`, and knn_shapley with `--stream` and `--stream --engine
approx --top-m 64`. Each saves its `ValuationResult`; the values agree
within 1e-5 of max |ref| (the whole-method tolerance) and each package
loads the other's file. With a real preselection (top_m < n) the two
packages draw different LSH planes, so there `--stream --engine approx`
is held against the port's own one-shot `--engine approx` run.
"""

import sys

import numpy as np
import pytest

from repro_torch.core.results import ValuationResult

COMMON = ["--n", "64", "--t", "16", "--k", "5", "--test-batch", "8"]

CASES = {
    "wknn-rbf": (["--method", "wknn", "--weights", "rbf"], []),
    "wknn-inverse": (["--method", "wknn", "--weights", "inverse"], []),
    "wknn-uniform": (["--method", "wknn", "--weights", "uniform"], []),
    "sti-stream": (["--method", "sti", "--stream"], []),
    "sti-stream-sharded": (["--method", "sti", "--stream", "--engine",
                            "sharded"], ["--shards", "4", "--devices",
                                         "cpu"]),
    "sti-stream-approx": (["--method", "sti", "--stream", "--engine",
                           "approx", "--top-m", "64"], []),
    "sti-mode": (["--mode", "sti"], []),
    "knn_shapley-stream": (["--method", "knn_shapley", "--stream"], []),
    "knn_shapley-stream-approx": (["--method", "knn_shapley", "--stream",
                                   "--engine", "approx", "--top-m", "64"],
                                  []),
}


def _run(monkeypatch, main, argv):
    monkeypatch.setattr(sys, "argv", ["valuate", *argv])
    main()


def _values(result) -> np.ndarray:
    arr = result.phi if result.phi is not None else result.point_values
    return np.asarray(arr.cpu() if hasattr(arr, "cpu") else arr,
                      dtype=np.float64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_launcher_saves_the_reference_launchers_result(case, monkeypatch,
                                                       capsys, tmp_path):
    pytest.importorskip("jax")
    from repro.core.results import ValuationResult as JResult
    from repro.launch import valuate as jvaluate
    from repro_torch.launch import valuate

    args, port_only = CASES[case]
    ref_path, port_path = tmp_path / "ref", tmp_path / "port"
    _run(monkeypatch, jvaluate.main, [*COMMON, *args, "--save",
                                      str(ref_path)])
    ref_out = capsys.readouterr().out
    _run(monkeypatch, valuate.main, [*COMMON, *args, *port_only, "--device",
                                     "cpu", "--save", str(port_path)])
    out = capsys.readouterr().out
    ref = JResult.load(ref_path)
    port = ValuationResult.load(port_path)
    want, got = _values(ref), _values(port)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)
    # the files cross-load: each package reads the other's
    np.testing.assert_array_equal(_values(ValuationResult.load(ref_path)),
                                  want)
    np.testing.assert_array_equal(_values(JResult.load(port_path)), got)
    if "--stream" in args:
        engine = next((e for e in ("sharded", "approx") if e in args),
                      "session")
        assert f"({engine}" in out, out
        if engine == "sharded":
            assert "shards=4" in out
        if engine == "approx":
            assert "top_m=64 exact=True" in out, out
    if args[1] in ("sti", "sii"):
        for line in ("KNN-Shapley corr with phi aggregate",
                     "LOO values range"):
            got_line = next(ln for ln in out.splitlines() if line in ln)
            ref_line = next(ln for ln in ref_out.splitlines() if line in ln)
            assert got_line == ref_line


@pytest.mark.parametrize("method", ["sti", "wknn"])
def test_stream_approx_preselects_as_the_one_shot_approx_engine(
        method, monkeypatch, capsys, tmp_path):
    """--stream --engine approx with top_m < n drives an
    `ApproxValuationSession` over --test-batch slices: the same planes and
    steps as the one-shot `--engine approx` run of the same invocation, so
    the same values bit for bit (wknn with its weight kind)."""
    from repro_torch.launch import valuate

    args = [*COMMON, "--method", method, "--engine", "approx", "--top-m",
            "16", "--device", "cpu"]
    if method == "wknn":
        args += ["--weights", "inverse"]
    got = {}
    for mode in ("one-shot", "stream"):
        path = tmp_path / mode
        _run(monkeypatch, valuate.main, [
            *args, *(["--stream"] if mode == "stream" else []), "--save",
            str(path)])
        out = capsys.readouterr().out
        assert "approx: top_m=16 exact=False" in out, out
        got[mode] = ValuationResult.load(path)
    assert "(approx" in out, out
    if method == "wknn":
        assert got["stream"].meta["opt_weights"] == "inverse"
    np.testing.assert_array_equal(_values(got["stream"]),
                                  _values(got["one-shot"]))


@pytest.mark.parametrize("engine", ["scan", "distributed", "eager",
                                    "oracle"])
def test_stream_ignores_an_engine_it_does_not_fold(engine, monkeypatch,
                                                   capsys):
    """--stream with an engine the session does not fold prints the JAX
    launcher's note and streams anyway."""
    from repro_torch.launch import valuate

    method = "sti" if engine in ("scan", "distributed") else "knn_shapley"
    _run(monkeypatch, valuate.main, [*COMMON, "--method", method,
                                     "--stream", "--engine", engine,
                                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"--engine {engine} ignored" in out
    assert f"{method} (session" in out


def test_weights_reach_wknn_only(monkeypatch, capsys, tmp_path):
    """A weight kind given to another method reaches no method; an unknown
    kind is refused by name."""
    from repro_torch.launch import valuate

    saved = []
    for extra in ([], ["--weights", "inverse"]):
        path = tmp_path / f"r{len(saved)}"
        _run(monkeypatch, valuate.main, [
            *COMMON, "--method", "knn_shapley", "--device", "cpu", *extra,
            "--save", str(path)])
        saved.append(_values(ValuationResult.load(path)))
    np.testing.assert_array_equal(saved[0], saved[1])
    capsys.readouterr()
    with pytest.raises(SystemExit):
        _run(monkeypatch, valuate.main, [*COMMON, "--method", "wknn",
                                         "--weights", "gaussian",
                                         "--device", "cpu"])
    assert "invalid choice: 'gaussian'" in capsys.readouterr().err
