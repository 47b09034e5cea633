"""The check that decides `correct`, at a size a test run holds, on the
CPU: a sound run passes it; the control (the reference computed in TF32
in the program's place) and each fault a cell can have, planted under the
timed path, fail it. Each cell runs with its own configuration, mix and
limits file; only n, the step's rows and the sampled rows are cut. The card's own check of the
same cells is `test_cells_are_correct_on_the_card` (marked `cuda`)."""

import json
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[1]
SPEC = harness.load_spec(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2_147_483_659


def tiny(cell: str) -> dict:
    """The cell at n = 1024 (knn_shapley: 4096), 32-row steps and 16
    sampled rows."""
    r = harness.resolve(SPEC, cell, ROOT)
    cfg = r["config"]
    n = 4096 if cfg["method"] == "knn_shapley" else 1024
    r["config"] = dict(cfg, n=n)
    r["mix"] = dict(r["mix"], test_batch=32)
    if "sample_rows" in r["limits"]:
        r["limits"] = dict(r["limits"], sample_rows=16)
    return r


def _unchanged(orig):
    def update(self, xb, yb):  # the step returns its state unchanged
        self._t += 1 if xb.ndim == 1 else int(xb.shape[0])
        return self
    return update


def _half(orig):
    def update(self, xb, yb):  # half of each batch left out
        h = max(1, int(xb.shape[0]) // 2)
        return orig(self, xb[:h], yb[:h])
    return update


def _altered(orig):
    def update(self, xb, yb):  # one label of each batch altered
        yb = yb.clone()
        yb[0] = (yb[0] + 1) % 2
        return orig(self, xb, yb)
    return update


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = harness.run_cell(tiny(cell), SEED, 0.3, False, device="cpu")
    line = out["line"]
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(cell):
    out = harness.run_cell(tiny(cell), SEED + 1, 0.3, False, device="cpu",
                           control=True)
    limits = out["line"]["checks"]
    failed = [k for k, v in out["control"].items()
              if v > limits[k]["limit"]]
    assert failed, (out["control"], limits)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_under_the_timed_path_fails_the_check(cell, fault,
                                                      monkeypatch):
    from repro_torch.core.session import ValuationSession

    monkeypatch.setattr(ValuationSession, "update",
                        FAULTS[fault](ValuationSession.update))
    out = harness.run_cell(tiny(cell), SEED + 2, 0.3, False, device="cpu")
    assert not out["line"]["correct"], out["line"]["checks"]


def _skip_tile(orig, tile):
    def update(self, xb, yb):  # the fill leaves one tile as it was
        keep = self._state[0][tile].clone()
        out = orig(self, xb, yb)
        self._state[0][tile] = keep
        return out
    return update


@pytest.mark.parametrize(
    "cell", [c for c in CELLS
             if harness.resolve(SPEC, c, ROOT)["config"]["method"] == "sti"])
def test_a_tile_the_fill_skips_fails_the_check(cell, monkeypatch):
    """One off-diagonal 128 x 128 tile of the accumulator (the fill
    kernel's tile) misses every step, in rows and columns that no sampled
    row reads: the sampled rows pass, and the projections, which see
    every entry, fail. Four sampled rows of 1024, so that two of the
    eight row blocks hold none (the cell samples 64 of 92160)."""
    from repro_torch.core.session import ValuationSession

    r = tiny(cell)
    r["limits"] = dict(r["limits"], sample_rows=4)
    n, seed, t = int(r["config"]["n"]), SEED + 4, 128
    sampled = set(harness.kind(r["config"], ROOT).sample_rows(n, 4, seed)
                  .tolist())
    free = [b for b in range(0, n, t) if not sampled & set(range(b, b + t))]
    assert len(free) >= 2
    tile = (slice(free[0], free[0] + t), slice(free[1], free[1] + t))
    monkeypatch.setattr(ValuationSession, "update",
                        _skip_tile(ValuationSession.update, tile))
    out = harness.run_cell(r, seed, 0.3, False, device="cpu")
    checks = out["line"]["checks"]
    assert checks["rows_median"]["value"] <= checks["rows_median"]["limit"], \
        checks
    assert checks["proj"]["value"] > checks["proj"]["limit"], checks
    assert not out["line"]["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cells_are_correct_on_the_card(cell, cuda_device):
    """Each cell at its own size, a 2 s window and a traced run."""
    r = harness.resolve(SPEC, cell, ROOT)
    for trace in (False, True):
        out = harness.run_cell(r, SEED + 3, 2.0, trace, device=cuda_device)
        assert out["line"]["correct"], out["line"]["checks"]
        assert out["line"]["device"]["platform"] == "gpu"
        torch.cuda.empty_cache()
