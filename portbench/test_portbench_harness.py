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
    kind = harness.kind(r["config"], ROOT)
    assert callable(kind.build) and callable(kind.check)


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


TOY_KIND = '''"""A model-fed kind at toy size: token sequences drawn from
the seed, embedded by a seeded table and a mean over each sequence's own
length, valued by knn_shapley through `ValuationSession.update`, and checked
against `KnnShapleyReference` on the reference's own embedding."""

import time

import torch

from portbench.reference import KnnShapleyReference
from portbench.traffic import generator

TABLE, TRAIN, TEST0 = 0, 1, 1 << 20


def tokens(cfg, seed, stream, rows):
    gen = generator(seed, stream, "cpu")
    ids = torch.randint(0, cfg["vocab"], (rows, cfg["seq"]), generator=gen)
    lengths = torch.randint(1, cfg["seq"] + 1, (rows,), generator=gen)
    labels = torch.randint(0, cfg["classes"], (rows,), generator=gen,
                           dtype=torch.int32)
    return ids, lengths, labels


def table(cfg, seed):
    return torch.randn((cfg["vocab"], cfg["d"]),
                       generator=generator(seed, TABLE, "cpu"))


def program_embed(tab, ids, lengths):
    """The program's side: a masked mean over the padded batch."""
    mask = torch.arange(ids.shape[1])[None, :] < lengths[:, None]
    return (tab[ids] * mask[..., None]).sum(1) / lengths[:, None]


def reference_embed(tab, ids, lengths):
    """The reference's own: each sequence's tokens averaged in f64."""
    return torch.stack([tab[ids[r, :lengths[r]]].double().mean(0)
                        for r in range(ids.shape[0])]).float()


class Driver:
    def __init__(self, cfg, mix, seed, dev):
        from repro_torch import ValuationSession

        self.cfg, self.seed, self.tb = cfg, seed, int(mix["test_batch"])
        self.records = {"n": cfg["n"], "d": cfg["d"], "config": cfg,
                        "mix": mix}
        t0 = time.perf_counter()
        self.tab = table(cfg, seed)
        ids, lengths, y = tokens(cfg, seed, TRAIN, cfg["n"])
        self.sess = ValuationSession(
            program_embed(self.tab, ids, lengths), y, k=cfg["k"],
            mode="knn_shapley", test_batch=self.tb, device=dev)
        t1 = time.perf_counter()
        self.batches = 0
        self.fold()
        self.phases = {"session": t1 - t0, "warm": time.perf_counter() - t1}

    def fold(self):
        ids, lengths, y = tokens(self.cfg, self.seed, TEST0 + self.batches,
                                 self.tb)
        self.sess.update(program_embed(self.tab, ids, lengths), y)
        self.batches += 1

    def window(self, seconds, span):
        start, t0 = self.batches, time.perf_counter()
        with span("window"):
            while time.perf_counter() - t0 < seconds:
                with span("update"):
                    self.fold()
        steps = self.batches - start
        return {"window_s": time.perf_counter() - t0, "steps": steps,
                "points": steps * self.tb, "attempted": steps, "failed": 0,
                "rows_per_step": self.tb}


def build(cfg, mix, seed, dev):
    return Driver(cfg, mix, seed, dev)


def check(cfg, limits, seed, driver, control=False):
    res = driver.sess.finalize()
    got, t = res.point_values.double(), int(res.meta["t"])
    del driver.sess, res
    tab = table(cfg, seed)
    ids, lengths, y = tokens(cfg, seed, TRAIN, cfg["n"])
    x = reference_embed(tab, ids, lengths)
    refs = {p: KnnShapleyReference(x, y, cfg["k"], precision=p)
            for p in (("f64", "tf32") if control else ("f64",))}
    for i in range(driver.batches):
        ids, lengths, yb = tokens(cfg, seed, TEST0 + i, driver.tb)
        xb = reference_embed(tab, ids, lengths)
        for r in refs.values():
            r.add(xb, yb)
    want = refs["f64"].result()

    def gap(a):
        return float((a - want["values"]).norm() / want["values"].norm())

    numbers = {"values": gap(got),
               "fold_gap": float(abs(t - driver.batches * driver.tb)
                                 + abs(t - want["t"]))}
    ctl = ({"values": gap(refs["tf32"].result()["values"])}
           if control else None)
    return numbers, ctl
'''


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "flipped"])
def test_a_new_kind_needs_only_new_files(tmp_path, monkeypatch, fault):
    """A later change adds a kind of configuration (here a toy model-fed
    one: tokens from the seed, a seeded embedding table, a length-masked
    mean, knn_shapley through `ValuationSession.update`), a configuration
    of that kind, a mix, its limits and the entries; the harness runs
    the cell with no edit to any file it has. One token flipped in the
    program's input, and not in the reference's, fails the check."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = root / "portbench"
    (pb / "kinds" / "toy_tokens.py").write_text(TOY_KIND)
    cfg = {"name": "toy-tokens", "kind": "toy_tokens", "source": "a toy",
           "n": 256, "d": 16, "vocab": 1000, "seq": 16, "classes": 3, "k": 5,
           "reduced": []}
    (pb / "configs" / "toy-tokens.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "batch16.json").write_text(
        json.dumps({"test_batch": 16}))
    (pb / "limits" / "toy-tokens.batch16.json").write_text(
        json.dumps({"limits": {"values": 2.5e-3, "fold_gap": 0}}))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "toy-tokens", "source": "a toy",
                            "file": "portbench/configs/toy-tokens.json",
                            "reduced": [], "why": "tokens embedded"})
    spec["workloads"].append({"name": "toy-tokens.batch16",
                              "config": "toy-tokens", "traffic": "batch16",
                              "chips": 1, "why": "16-sequence batches"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = harness.resolve(harness.load_spec(root), "toy-tokens.batch16", root)
    kind = harness.kind(r["config"], root)
    assert kind.__file__ == str(pb / "kinds" / "toy_tokens.py")
    if fault:
        def flipped(tab, ids, lengths, embed=kind.program_embed):
            ids = ids.clone()
            ids[0, 0] = (ids[0, 0] + 1) % tab.shape[0]
            return embed(tab, ids, lengths)
        monkeypatch.setattr(kind, "program_embed", flipped)
    out = harness.run_cell(r, 3_000_000_019, 0.2, False, device="cpu")
    line = out["line"]
    assert line["correct"] is (not fault), line["checks"]
    assert line["attempted"] > 0 and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"valuation_rate", "setup_s"}
    assert out["records"]["rows_per_step"] == 16


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
    """Two kernels in a 100 us window, both launched inside the harness's
    `update`, one of them from inside `aten::sort`; the card's mirror of
    a span is not device work. The records put both kernels' time under
    `update`."""
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
    r = trace.read([trace._event(e) for e in events])
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["trace_window_s"] == pytest.approx(100e-6)
    assert set(r["spans"]) == {"window", "update"}
    assert r["spans"]["update"]["device_s"] == pytest.approx(30e-6)
    assert r["kernels"] == {"sort_kernel": [1, pytest.approx(1e-5)],
                            "other_kernel": [1, pytest.approx(2e-5)]}
    # gaps 70-100 in the window alone, 0-20 in `update`, and 30-50, whose
    # middle is where `update` closes, in the window again
    assert r["breakdown"]["idle_gaps"] == [
        ["window", pytest.approx(3e-5)], ["update", pytest.approx(2e-5)],
        ["window", pytest.approx(2e-5)]]
