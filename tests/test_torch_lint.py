"""The port's reprolint, layer 1: every ported rule trips on its fixture
and stays quiet on the fixed twin; suppression, fingerprints (byte-equal
to the reference's), the baseline and the CLI's exit codes behave as the
reference's; the port's own tree lints clean."""

import json

import pytest

from repro_torch.analysis import lint_source, lint_tree, load_baseline
from repro_torch.analysis.baseline import split_baselined, write_baseline
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import all_rules

# code -> (tripping source, fixed source), written in PyTorch. Each fixed
# twin is the tripping snippet with exactly the rule's fix applied.
FIXTURES = {
    "R202": (
        """
import functools
@functools.lru_cache(maxsize=None)
def make_step(k, fill="cuda", fill_static=()):
    return (k, fill, fill_static)
step = make_step(3, fill_static=[("chunk", 4)])
""",
        """
import functools
@functools.lru_cache(maxsize=None)
def make_step(k, fill="cuda", fill_static=()):
    return (k, fill, fill_static)
step = make_step(3, fill_static=(("chunk", 4),))
""",
    ),
    "R403": (
        """
TILE = 128
def launch(x):
    grid = (x.shape[0] // TILE, x.shape[1] // TILE)
    return grid
""",
        """
TILE = 128
def launch(x):
    grid = (-(-x.shape[0] // TILE), -(-x.shape[1] // TILE))
    return grid
""",
    ),
    "R601": (
        """
import torch
OFFSETS = torch.arange(128)
def shift(x):
    return x + OFFSETS
""",
        """
import torch
DTYPE = torch.float32
def shift(x):
    return x + torch.arange(128, dtype=DTYPE, device=x.device)
""",
    ),
    "R602": (
        """
import torch
HAS_CARD = torch.cuda.is_available()
def default_device():
    return "cuda" if HAS_CARD else "cpu"
""",
        """
import torch
def default_device():
    return "cuda" if torch.cuda.is_available() else "cpu"
""",
    ),
    "R701": (
        """
import torch
def serve(batch):
    out = batch.sum()
    return out.item()
""",
        """
import torch
def serve(batch):
    out = batch.sum()
    return out.item()  # sync-point: the client reads a host float
""",
    ),
}

# path-scoped rules' fixtures are linted as if they lived at this path
FIXTURE_PATHS = {"R403": "kernels/sti_fill.py",
                 "R701": "serving/valuation_service.py"}


@pytest.mark.parametrize("code", sorted(FIXTURES))
def test_rule_trips_on_fixture(code):
    trip, _ = FIXTURES[code]
    relpath = FIXTURE_PATHS.get(code, "<snippet>")
    got = {f.code for f in lint_source(trip, relpath, codes={code})}
    assert got == {code}


@pytest.mark.parametrize("code", sorted(FIXTURES))
def test_rule_passes_fixed_fixture(code):
    _, fixed = FIXTURES[code]
    relpath = FIXTURE_PATHS.get(code, "<snippet>")
    assert lint_source(fixed, relpath, codes={code}) == []


def test_all_ported_rule_codes_have_fixtures():
    assert set(FIXTURES) == set(all_rules()) == {
        "R202", "R403", "R601", "R602", "R701"}


@pytest.mark.parametrize("spelling", [
    "x.tolist()", "x.cpu()", "x.numpy()", "np.asarray(x)",
    "torch.cuda.synchronize()", "torch.cuda.current_stream().synchronize()",
])
def test_hostsync_rule_flags_each_sync(spelling):
    src = f"import numpy as np\nimport torch\ndef serve(x):\n    {spelling}\n"
    assert {f.code for f in lint_source(src, "serving/engine.py",
                                        codes={"R701"})} == {"R701"}
    annotated = src.replace(
        "def serve(x):", "def serve(x):  # sync-point: host staging")
    assert lint_source(annotated, "serving/engine.py", codes={"R701"}) == []


def test_path_scoped_rules_stay_in_scope():
    # R701 reads the request path only, R403 the kernel wrappers only
    trip, _ = FIXTURES["R701"]
    assert lint_source(trip, "kernels/sti_pipeline.py", codes={"R701"}) == []
    assert {f.code for f in lint_source(
        trip, "core/resilient.py", codes={"R701"})} == {"R701"}
    trip, _ = FIXTURES["R403"]
    assert lint_source(trip, "models/attention.py", codes={"R403"}) == []


def test_r403_padding_and_small_divisors_stay_quiet():
    padded = """
TILE = 128
def launch(x):
    pad = (-x.shape[0]) % TILE
    return (x.shape[0] + pad) // TILE
"""
    assert lint_source(padded, "kernels/x.py", codes={"R403"}) == []
    halves = "def f(w):\n    return w // 2\n"
    assert lint_source(halves, "kernels/x.py", codes={"R403"}) == []


def test_r601_legal_import_time_calls():
    src = """
import torch
from torch import finfo
DEV = torch.device("cpu")
EPS = finfo(torch.float32).eps
BIG = torch.iinfo(torch.int32).max
@torch.no_grad()
def f(x, shape=torch.Size([2, 2])):
    return x
"""
    assert lint_source(src, codes={"R601", "R602"}) == []
    defaults = "import torch.nn.functional as F\ndef f(x, p=F.pad):\n" \
               "    return x\nW = F.softmax(torch.ones(2), 0)\n"
    got = [f.code for f in lint_source(defaults, codes={"R601"})]
    assert got == ["R601", "R601"]   # F.softmax and torch.ones


def test_inline_suppression():
    trip, _ = FIXTURES["R601"]
    line = "OFFSETS = torch.arange(128)"
    assert lint_source(trip.replace(
        line, line + "  # reprolint: disable=R601")) == []
    wrong = lint_source(trip.replace(
        line, line + "  # reprolint: disable=R602"))
    assert {f.code for f in wrong} == {"R601"}
    assert lint_source(trip.replace(
        line, line + "  # reprolint: disable=all")) == []


def test_findings_carry_fixits_and_locations():
    for code, (trip, _) in FIXTURES.items():
        got = lint_source(trip, FIXTURE_PATHS.get(code, "<snippet>"),
                          codes={code})
        assert got
        for f in got:
            assert f.line > 0 and f.message and f.fixit, code
            assert f"{f.path}:{f.line}: {code}" in f.render()


@pytest.mark.parametrize("fields", [
    ("R601", "kernels/x.py", 3, "msg", "fix", "  OFFSETS = torch.arange(128)"),
    ("C102", "registry://acc_fill/cuda", 0, "returns a new tensor", "", ""),
    ("R701", "serving/engine.py", 140, "é ünïcode", "", "x.item()  # ü"),
])
def test_fingerprint_equals_the_reference(fields):
    from repro.analysis.findings import Finding as RefFinding

    ours, ref = Finding(*fields), RefFinding(*fields)
    assert ours.fingerprint == ref.fingerprint
    assert ours.render() == ref.render()
    assert ours.baseline_entry("why") == ref.baseline_entry("why")


def test_fingerprint_survives_line_shift():
    trip, _ = FIXTURES["R601"]
    (a,) = lint_source(trip, codes={"R601"})
    (b,) = lint_source("# a new leading comment\n\n" + trip, codes={"R601"})
    assert a.line != b.line and a.fingerprint == b.fingerprint


def test_baseline_roundtrip(tmp_path):
    trip, _ = FIXTURES["R601"]
    findings = lint_source(trip, codes={"R601"})
    path = tmp_path / "baseline.txt"
    write_baseline(findings, path)
    baseline = load_baseline(path)
    new, old = split_baselined(findings, baseline)
    assert new == [] and len(old) == 1
    # justifications survive a rewrite
    fp = findings[0].fingerprint
    write_baseline(findings, path, keep={fp: "kept on purpose"})
    assert load_baseline(path) == {fp: "kept on purpose"}
    # an edited offending line changes the fingerprint: the entry is stale
    edited = lint_source(trip.replace("arange(128)", "arange(256)"),
                         codes={"R601"})
    new, old = split_baselined(edited, load_baseline(path))
    assert len(new) == 1 and old == []
    assert load_baseline(tmp_path / "absent.txt") == {}


def test_malformed_baseline_rejected(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("R601 deadbeef extra-token\n")
    with pytest.raises(ValueError, match="malformed"):
        load_baseline(p)


def test_port_tree_is_clean_under_its_baseline():
    new, _ = split_baselined(lint_tree(), load_baseline())
    assert new == [], "\n".join(f.render() for f in new)


def test_checked_in_baseline_entries_are_justified():
    for fingerprint, justification in load_baseline().items():
        assert len(justification) > 20, (
            f"baseline entry {fingerprint} needs a real justification")


# ------------------------------------------------------------------ CLI
def test_cli_strict_clean_tree_exits_zero(capsys):
    from repro_torch.launch.lint import main

    assert main(["--strict", "--no-contracts"]) == 0
    assert "0 actionable finding(s)" in capsys.readouterr().out


def test_cli_strict_fails_on_new_finding(tmp_path, capsys):
    from repro_torch.launch.lint import main

    (tmp_path / "mod.py").write_text(FIXTURES["R601"][0])
    args = ["--no-contracts", "--root", str(tmp_path),
            "--baseline", str(tmp_path / "empty.txt")]
    assert main(["--strict"] + args) == 1
    assert "R601" in capsys.readouterr().out
    assert main(args) == 0   # not strict: reported, exit 0


def test_cli_json_output(tmp_path, capsys):
    from repro_torch.launch.lint import main

    (tmp_path / "mod.py").write_text(FIXTURES["R602"][0])
    assert main(["--json", "--no-contracts", "--root", str(tmp_path),
                 "--baseline", str(tmp_path / "empty.txt")]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert [f["code"] for f in payload["new"]] == ["R602"]
    assert payload["new"][0]["fingerprint"]
    assert payload["baselined"] == [] and payload["contracts"] == []


def test_cli_update_baseline_roundtrip(tmp_path, capsys):
    from repro_torch.launch.lint import main

    (tmp_path / "mod.py").write_text(FIXTURES["R601"][0])
    baseline = tmp_path / "baseline.txt"
    assert main(["--update-baseline", "--no-contracts",
                 "--root", str(tmp_path), "--baseline", str(baseline)]) == 0
    capsys.readouterr()
    assert main(["--strict", "--no-contracts", "--root", str(tmp_path),
                 "--baseline", str(baseline)]) == 0
    assert "1 baselined" in capsys.readouterr().out


def test_cli_exclusive_flags_rejected():
    from repro_torch.launch.lint import main

    assert main(["--no-contracts", "--contracts-only"]) == 2


def test_cli_contracts_need_a_card_unless_cpu_is_asked(capsys):
    import torch

    from repro_torch.launch.lint import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--contracts-only"])
    assert main(["--strict", "--contracts-only", "--device", "cpu"]) == 0
    assert "0 actionable finding(s)" in capsys.readouterr().out
