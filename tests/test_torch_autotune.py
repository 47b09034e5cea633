"""The port's persistent autotuner (`repro_torch.kernels.autotune`) on the
CPU, in a `tmp_path` cache.

The cache: the schema stamp, a v1 (or corrupt) file discarded, bucketing,
the platform and device-count segments, and the gate that matters -- a
winner tuned on the CPU is never served to a CUDA process (the key's
platform segment differs), nor a "cuda" winner to a CPU one, nor a plain
fill to a card. The tuners run here with the plain candidates and
persist their winners; "auto" then resolves to the cached winner, and
with an empty cache to the heuristic, exactly as before the cache
existed. A candidate that fails fails the tune, which stores nothing.
The heuristics and candidate grids that need no device are held against
the JAX package's.
The `cuda` case tunes on a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_autotune.py -q
"""

import json

import numpy as np
import pytest
import torch

from repro_torch import DataValuator, ValuationSession
from repro_torch.core.sti_knn import resolve_fill, resolve_rect_fill
from repro_torch.kernels import autotune as at
from repro_torch.kernels import sti_pipeline as tpipe

CARD = "nvidiah10080gbhbm3"


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh cache file named by the port's environment variable."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    return path


@pytest.fixture
def card_slug(monkeypatch):
    """Key "cuda" entries as an H100 would, with no card present."""
    real = at.device_platform

    def platform(backend="cuda"):
        return CARD if backend == "cuda" else real(backend)

    monkeypatch.setattr(at, "device_platform", platform)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


def _plant(path, key, entry, schema=2):
    data = json.loads(path.read_text()) if path.exists() else {}
    data[key] = entry
    data["__schema__"] = schema
    path.write_text(json.dumps(data))


# --------------------------------------------------------------- the cache
def test_cache_path_env_and_default(cache, monkeypatch):
    assert at.cache_path() == str(cache)
    assert at.cache_path("/x/y.json") == "/x/y.json"
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    assert at.cache_path().endswith("/.cache/repro_torch/autotune.json")


def test_schema_stamp_written_and_v1_discarded(cache):
    at.autotune_fill(64, 4, backend="cpu")
    data = json.loads(cache.read_text())
    assert data["__schema__"] == 2
    key = at._key("fill", "cpu", 64, 4)
    assert data[key]["fill"] == "chunked" and data[key]["sample_t"] == 4
    assert at.lookup_fill(64, 4, backend="cpu") is not None
    # a v1 file (no stamp) is dropped whole: every entry misses
    v1 = {k: v for k, v in data.items() if k != "__schema__"}
    cache.write_text(json.dumps(v1))
    assert at.lookup_fill(64, 4, backend="cpu") is None
    assert at.best_fill(64, 4, backend="cpu") == ("chunked", {"chunk": 1})
    cache.write_text("{not json")
    assert at.lookup_fill(64, 4, backend="cpu") is None
    at.clear_cache()
    assert not cache.exists()


@pytest.mark.parametrize("x,want", [(0, 1), (1, 1), (2, 2), (3, 4),
                                    (256, 256), (257, 512), (65536, 65536)])
def test_bucketing(x, want):
    assert at._bucket(x) == want


def test_key_segments(card_slug):
    assert at.device_platform("cpu") == "cpu"
    assert at._key("fill", "cpu", 100, 7) == "fill:cpu:cpu:dev1:n128:t8"
    assert at._key("rectfill", "cpu", 100, 7, rows=30) == \
        "rectfill:cpu:cpu:dev1:rows32:n128:t8"
    assert at._key("fill", "cuda", 65536, 256, devices=1) == \
        f"fill:cuda:{CARD}:dev1:n65536:t256"


def test_a_cpu_winner_is_never_served_to_a_cuda_process(cache, card_slug):
    _plant(cache, at._key("fill", "cpu", 4096, 256),
           {"fill": "chunked", "params": {"chunk": 4}})
    _plant(cache, at._key("megastep_sti_d768", "cpu", 4096, 256),
           {"step": "megakernel", "params": {}})
    _plant(cache, at._key("distance_d768", "cpu", 4096, 256),
           {"distance": "plain", "params": {}})
    assert at.lookup_fill(4096, 256, backend="cpu") == ("chunked",
                                                        {"chunk": 4})
    assert at.lookup_fill(4096, 256, backend="cuda") is None
    assert at.best_fill(4096, 256, backend="cuda") == ("cuda", {})
    assert at.lookup_megastep(4096, 256, 768, backend="cuda") is None
    assert at.best_distance(256, 4096, 768, backend="cuda") == ("cuda", {})
    # and a "cuda" winner under a CPU key (a hand-edited file) is refused
    _plant(cache, at._key("fill", "cpu", 4096, 256), {"fill": "cuda"})
    assert at.best_fill(4096, 256, backend="cpu") == ("chunked",
                                                      {"chunk": 1})
    _plant(cache, at._key("distance_d768", "cpu", 4096, 256),
           {"distance": "cuda"})
    assert at.best_distance(256, 4096, 768, backend="cpu") == ("plain", {})


def test_a_card_winner_is_served_on_its_platform(cache, card_slug):
    _plant(cache, at._megastep_key(4096, 256, 768, "sti", "cuda"),
           {"step": "megakernel", "params": {"compute_dtype": "float32"}})
    assert at.best_megastep(4096, 256, 768, 5, backend="cuda") == (
        "megakernel", {"compute_dtype": "float32"})
    _plant(cache, at._ann_key(4096, 256, 768, 64, "cuda"),
           {"n_tables": 8, "window": 32})
    assert at.best_ann(4096, 256, 768, 64, backend="cuda") == (8, 32)
    # a bf16 step is never an "auto" verdict: a hand-written one misses
    _plant(cache, at._megastep_key(4096, 256, 768, "sti", "cuda"),
           {"step": "megakernel", "params": {"compute_dtype": "bfloat16"}})
    assert at.lookup_megastep(4096, 256, 768, backend="cuda") is None
    assert at.best_megastep(4096, 256, 768, 5, backend="cuda") == (
        "stages", {})
    # a card serves its kernel only: neither a plain fill nor an entry
    # naming nothing in the port's registry (a JAX winner)
    for fill in ("chunked", "pallas"):
        _plant(cache, at._key("fill", "cuda", 4096, 256),
               {"fill": fill, "params": {"chunk": 2}})
        assert at.best_fill(4096, 256, backend="cuda") == ("cuda", {})
    _plant(cache, at._key("rectfill", "cuda", 4096, 256, rows=1024),
           {"fill": "chunked", "params": {"chunk": 2}})
    assert at.best_rect_fill(1024, 4096, 256, backend="cuda") == ("cuda", {})


def test_empty_cache_resolves_as_the_heuristic(cache):
    assert resolve_fill("auto", 64, 16, backend="cpu") == (
        "chunked", (("chunk", 1),))
    assert resolve_rect_fill("auto", 16, 64, 16, backend="cpu") == (
        "chunked", (("chunk", 1),))
    assert tpipe.resolve_distance("auto", 16, 64, 4, backend="cpu") == \
        "plain"
    for method in ("sti", "knn_shapley"):
        _, resolved, _ = tpipe.prepare_stream_step(method, 64, 4, 3,
                                                   test_batch=16,
                                                   device="cpu")
        assert resolved["fill"] != "megakernel"
    assert not cache.exists()


# ---------------------------------------------------------------- tuners
def test_fill_and_rect_fill_tuners_persist_and_serve(cache):
    name, params = at.autotune_fill(96, 32, backend="cpu", reps=1)
    assert name == "chunked" and params["chunk"] in (1, 2, 4, 8)
    entry = json.loads(cache.read_text())[at._key("fill", "cpu", 96, 32)]
    assert set(entry["candidates"]) == {
        f'chunked {{"chunk": {c}}}' for c in (1, 2, 4, 8)}
    assert at.best_fill(96, 32, backend="cpu") == (name, params)
    assert resolve_fill("auto", 96, 32, backend="cpu") == (
        name, tuple(sorted(params.items())))
    rname, rparams = at.autotune_rect_fill(24, 96, 32, backend="cpu",
                                           reps=1)
    assert at.lookup_rect_fill(24, 96, 32, backend="cpu") == (rname,
                                                              rparams)
    assert resolve_rect_fill("auto", 24, 96, 32, backend="cpu")[0] == rname
    # another row height has its own key
    assert at.lookup_rect_fill(96, 96, 32, backend="cpu") is None


def test_chunk_candidates_fit_the_temporary_budget(monkeypatch):
    monkeypatch.setattr(at, "_temp_budget", lambda backend: 2 * 64 * 64 * 9)
    assert at.fill_candidates(64, 16, "cpu") == [
        ("chunked", {"chunk": 1}), ("chunked", {"chunk": 2})]
    assert at.fill_candidates(64, 1, "cpu") == [("chunked", {"chunk": 1})]
    # a card offers its kernel alone, whatever the budget
    assert at.fill_candidates(64, 16, "cuda") == [("cuda", {})]
    assert at.rect_fill_candidates(16, 64, 16, "cuda") == [("cuda", {})]


def test_distance_tuner_has_nothing_to_measure_on_the_cpu(cache):
    assert at.autotune_distance(16, 64, 4, backend="cpu") == ("plain", {})
    assert not cache.exists()
    assert at.distance_candidates("cuda") == [("cuda", {})]
    # nor does the plain one resolve on a card, whatever the cache holds
    _plant(cache, at._key("distance_d4", "cuda", 64, 16), {"distance": "plain"})
    assert at.best_distance(16, 64, 4, backend="cuda") == ("cuda", {})


def test_ann_tuner_persists_a_grid_entry(cache):
    n_tables, window = at.autotune_ann(256, 16, 8, 32, backend="cpu",
                                       reps=1)
    assert (n_tables, window) in at.ann_candidates(256, 32)
    entry = json.loads(cache.read_text())[at._ann_key(256, 16, 8, 32,
                                                      "cpu")]
    assert len(entry["candidates"]) == len(at.ann_candidates(256, 32))
    for cand in entry["candidates"].values():
        assert 0.0 <= cand["recall"] <= 1.0 and cand["us"] > 0
    good = [c for c in entry["candidates"].values() if c["recall"] >= 0.95]
    assert entry["floor_met"] == bool(good)
    if good:
        assert entry["us"] == min(c["us"] for c in good)
    else:  # no shape cleared the floor: the heuristic is kept
        assert (n_tables, window) == at.default_ann(256, 32)
    assert at.best_ann(256, 16, 8, 32, backend="cpu") == (n_tables, window)
    # an approx session without index options takes the cached shape
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 8)).astype(np.float32)
    y = rng.integers(0, 2, 256).astype(np.int32)
    from repro_torch import ApproxValuationSession

    sess = ApproxValuationSession(x, y, mode="knn_shapley", top_m=32,
                                  test_batch=16, device="cpu")
    assert (sess._resolved["n_tables"], sess._resolved["window"]) == (
        n_tables, window)


@pytest.mark.parametrize("method", ["sti", "knn_shapley"])
def test_megastep_tuner_and_auto_resolution(cache, method):
    name, params = at.autotune_megastep(64, 4, 3, 16, method=method,
                                        backend="cpu", reps=1)
    entry = json.loads(cache.read_text())[at._megastep_key(
        64, 16, 4, method, "cpu")]
    assert set(entry["candidates"]) == set(entry["rounds"]) == {
        "stages {}", 'megakernel {"compute_dtype": "float32"}'}
    assert at.megakernel_candidates(64, 16, "cuda") == [
        {"compute_dtype": "float32"}]
    # the megakernel wins only clear of the spread of the stages' rounds
    stages = entry["rounds"]["stages {}"]
    mega = entry["rounds"]['megakernel {"compute_dtype": "float32"}']
    assert len(stages) == len(mega) == at._ROUNDS
    assert (name == "megakernel") == (max(mega) < min(stages))
    assert at.lookup_megastep(64, 16, 4, method=method,
                              backend="cpu") == (name, params)
    # "auto" launches what the cache names, for each answer
    for step in ("megakernel", "stages"):
        _plant(cache, at._megastep_key(64, 16, 4, method, "cpu"),
               {"step": step, "params": {}})
        _, resolved, _ = tpipe.prepare_stream_step(
            method, 64, 4, 3, test_batch=16, device="cpu")
        assert (resolved["fill"] == "megakernel") == (step == "megakernel")
        # the sharded steps never take it from the cache
        _, sharded, _, _ = tpipe.prepare_sharded_stream_step(
            method, 64, 4, 3, devices=["cpu"] * 2, test_batch=16)
        assert sharded["fill"] != "megakernel"


def test_clear_winner_keeps_the_default_inside_the_spread():
    stages = "stages {}"
    mega = 'megakernel {"compute_dtype": "float32"}'
    assert at._clear_winner({stages: [10, 12, 11], mega: [9, 10.5, 9]},
                            stages) == ("stages", {})
    assert at._clear_winner({stages: [10, 12, 11], mega: [9, 9.5, 9]},
                            stages) == ("megakernel",
                                        {"compute_dtype": "float32"})


def _raises(*args, **kw):
    raise torch.cuda.OutOfMemoryError("the kernel candidate failed")


@pytest.mark.parametrize("tuner", ["fill", "rect_fill", "megastep", "ann"])
def test_a_failing_candidate_fails_the_tune(cache, monkeypatch, tuner):
    """A candidate that raises (here a stand-in kernel running out of
    memory) is never left out so that another one wins: the tune raises
    and stores nothing."""
    from repro_torch.core import sti_knn

    if tuner == "fill":
        monkeypatch.setitem(sti_knn._FILL_FNS, "cuda", _raises)
        monkeypatch.setattr(at, "fill_candidates", lambda n, t, backend: [
            ("chunked", {"chunk": 1}), ("cuda", {})])
        run = lambda: at.autotune_fill(64, 16, backend="cpu", reps=1)
    elif tuner == "rect_fill":
        monkeypatch.setitem(sti_knn._RECT_FILL_FNS, "cuda", _raises)
        monkeypatch.setattr(at, "rect_fill_candidates",
                            lambda rows, n, t, backend: [
                                ("chunked", {"chunk": 1}), ("cuda", {})])
        run = lambda: at.autotune_rect_fill(16, 64, 16, backend="cpu",
                                            reps=1)
    elif tuner == "megastep":
        real = tpipe.make_point_step

        def make(method, k, opts, dist, fill=None, static=()):
            return _raises if fill == "megakernel" else real(
                method, k, opts, dist, fill, static)

        monkeypatch.setattr(tpipe, "make_point_step", make)
        run = lambda: at.autotune_megastep(64, 4, 3, 16, method="loo",
                                           backend="cpu", reps=1)
    else:
        from repro_torch.kernels import ann

        monkeypatch.setattr(ann, "topm_candidates", _raises)
        run = lambda: at.autotune_ann(256, 16, 8, 32, backend="cpu", reps=1)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        run()
    assert not cache.exists()


def test_session_autotune_and_data_valuator_autotune(cache):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = rng.integers(0, 2, 64).astype(np.int32)
    sess = ValuationSession(x, y, k=3, test_batch=16, autotune=True,
                            device="cpu")
    data = json.loads(cache.read_text())
    step = data[at._megastep_key(64, 16, 4, "sti", "cpu")]["step"]
    if step == "megakernel":
        assert sess._resolved["fill"] == "megakernel"
    else:  # the three-stage step resolved (and tuned) its fill
        assert sess._resolved["fill"] == data[at._key(
            "fill", "cpu", 64, 16)]["fill"]
    at.clear_cache()
    dv = DataValuator(k=3, test_batch=16, device="cpu")
    assert dv.autotune(64, 16, d=4)[0] == "chunked"
    assert at.lookup_fill(64, 16, backend="cpu") is not None


# -------------------------------------------- against the JAX package
def test_heuristics_and_grids_match_jax():
    pytest.importorskip("jax")
    from repro.kernels import autotune as jat

    for x in (1, 3, 100, 4096, 70000):
        assert at._bucket(x) == jat._bucket(x)
    for n, m in ((192, 96), (65536, 64), (1 << 20, 256), (40, 200)):
        assert at.default_ann(n, m) == jat.default_ann(n, m)
        assert at.ann_candidates(n, m) == jat.ann_candidates(n, m)
    assert at._SCHEMA == jat._SCHEMA and at._SAMPLE_T == jat._SAMPLE_T
    assert at.default_fill("cpu") == jat.default_fill("cpu")


# --------------------------------------------------------------- the card
@pytest.mark.cuda
def test_tuners_on_the_card(cache, cuda):
    # the kernel is the card's one fill and distance: nothing to store
    assert at.autotune_fill(4096, 64, backend="cuda", reps=1) == ("cuda", {})
    assert at.autotune_distance(64, 4096, 64, backend="cuda") == ("cuda", {})
    assert not cache.exists()
    assert at.best_fill(4096, 64, backend="cuda") == ("cuda", {})
    step, _ = at.autotune_megastep(4096, 64, 5, 64, method="knn_shapley",
                                   backend="cuda", reps=1)
    assert at.best_megastep(4096, 64, 64, 5, method="knn_shapley",
                            backend="cuda")[0] == step
    assert at.lookup_fill(4096, 64, backend="cpu") is None
