"""The PyTorch port's examples (`examples/*_torch.py`) on the CPU.

Each runs in this process (`runpy`, `sys.argv` patched) with `--device
cpu` at a small size, chosen so that the example's own assertions hold,
and prints its closing "[ok]" line. On the card, chip_smoke.py runs them
with `--device cuda` at their default sizes.
"""

import runpy
import sys
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

CASES = {
    "quickstart_torch": (["--n", "64", "--t", "16"],
                         "wknn vs knn_shapley rank agreement"),
    "end_to_end_valuation_torch": (
        ["--steps", "2", "--d-model", "32", "--layers", "1", "--batch",
         "4"], "[ok] end-to-end pipeline complete"),
    "distributed_valuation_torch": (
        ["--n", "64", "--t", "16"],
        "[ok] sharded streaming engine matches the single-host algorithm"),
    "serve_lm_torch": (["--requests", "2", "--max-len", "16"],
                       "[ok] all requests served"),
}


def test_every_torch_example_is_held():
    assert sorted(p.stem for p in EXAMPLES.glob("*_torch.py")) == \
        sorted(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, monkeypatch, capsys):
    args, last = CASES[name]
    path = EXAMPLES / f"{name}.py"
    monkeypatch.setattr(sys, "argv", [str(path), "--device", "cpu", *args])
    runpy.run_path(str(path), run_name="__main__")
    out = capsys.readouterr().out
    assert last in out, out


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_defaults_to_the_card(name):
    src = (EXAMPLES / f"{name}.py").read_text()
    assert 'ap.add_argument("--device", default="cuda"' in src
