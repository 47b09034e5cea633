"""The benchmark is driven by data: `BENCHMARK.json` names every cell,
configuration, mix, limits file and metric reader, and the harness finds
each by name. These tests hold the file to the benchmark's rules and show
that a new cell needs new files and entries only."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"][1] == "portbench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_units_and_whys():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    for nm in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(nm), nm
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for entry in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_configurations():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
            assert not key.endswith(("_dim", "_rank")) and key != "d"
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads():
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(CELLS)
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    assert {w["config"] for w in SPEC["workloads"]} == \
        {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    assert callable(harness.reader(metric["name"], ROOT))
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
        if metric["name"] != "setup_s":
            assert metric["bound"] >= 0.01
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_and_reports_what_it_must(cell):
    r = harness.resolve(SPEC, cell, ROOT)
    e2e = {m["name"] for m in r["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert r["per_layer"]
    for m in r["per_layer"]:
        # a layer metric moves one end-to-end metric its cell reports
        assert m["moves"] in e2e
    assert r["mix"]["test_batch"] > 0 and r["mix"]["in_flight"] >= 1
    assert set(r["limits"]["limits"]) >= {"fold_gap"}


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A later change adds a mix, its limits and a cell entry; the harness
    finds them with no edit to any file it has."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    (root / "portbench" / "traffic" / "batch64.json").write_text(
        json.dumps({"test_batch": 64, "in_flight": 2}))
    (root / "portbench" / "limits" / "sti-imagenet-92k.batch64.json") \
        .write_text((root / "portbench" / "limits"
                     / "sti-imagenet-92k.batch256.json").read_text())
    spec["workloads"].append({"name": "sti-imagenet-92k.batch64",
                              "config": "sti-imagenet-92k",
                              "traffic": "batch64", "chips": 1,
                              "why": "64-point batches"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "sti-imagenet-92k.batch256" in m.get("workloads", []):
            m["workloads"].append("sti-imagenet-92k.batch64")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = harness.resolve(harness.load_spec(root), "sti-imagenet-92k.batch64",
                        root)
    assert r["mix"]["test_batch"] == 64
    assert {m["name"] for m in r["per_layer"]} >= {"fill.roofline"}
    r["config"] = dict(r["config"], n=128, d=8, classes=4)
    r["limits"] = dict(r["limits"], sample_rows=8)
    out = harness.run_cell(r, 5, 0.2, False, device="cpu")
    assert out["line"]["correct"]
    assert out["records"]["rows_per_step"] == 64
    assert set(out["line"]["metrics"]) == {"valuation_rate", "setup_s"}


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    """Without a card, and in a directory that holds only the benchmark's
    own files, a run exits non-zero with no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "portbench", bare / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for where in (ROOT, bare):
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "sti-imagenet-92k.batch256", "--seed", "3000000019", "--seconds", "1",
             "--trace", "0"], cwd=where, capture_output=True, text=True,
            env=env, timeout=120)
        assert p.returncode != 0
        assert not p.stdout.strip()


def test_trace_reduction_on_a_known_timeline():
    """Two kernels in a 100 us window, one launched from inside
    `aten::sort`; the card's mirror of a span is not device work."""
    from torch.autograd import DeviceType

    from portbench import trace

    class Ev:
        def __init__(self, name, dev, ts, dur, corr=0):
            self.args = (name, dev, ts, dur, corr)

        def name(self):
            return self.args[0]

        def device_type(self):
            return self.args[1]

        def start_ns(self):
            return self.args[2] * 1000

        def duration_ns(self):
            return self.args[3] * 1000

        def correlation_id(self):
            return self.args[4]

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [Ev("window", cpu, 0, 100), Ev("update", cpu, 10, 30),
              Ev("aten::sort", cpu, 12, 5, 1),
              Ev("cudaLaunchKernel", cpu, 13, 1, 77),
              Ev("sort_kernel", gpu, 20, 10, 77),
              Ev("cudaLaunchKernel", cpu, 30, 1, 78),
              Ev("other_kernel", gpu, 50, 20, 78),
              Ev("update", gpu, 10, 60)]
    r = trace.reduce([trace._event(e) for e in events])
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["trace_window_s"] == pytest.approx(100e-6)
    assert r["rank_s"] == pytest.approx(10e-6)
    assert r["kernels"] == {"sort_kernel": [1, pytest.approx(1e-5)],
                            "other_kernel": [1, pytest.approx(2e-5)]}
    assert r["breakdown"]["idle_gaps"][0] == ["window", pytest.approx(3e-5)]
    assert [g[0] for g in r["breakdown"]["idle_gaps"][1:]] == ["update"] * 2
