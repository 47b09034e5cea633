"""Suppression baseline: the checked-in ledger of intentional findings.

Format — one finding per line, `#` comments and blank lines ignored:

    R701 3f1c9a2b44de  # serving/x.py: why this finding is intentional

The second token is the finding's `fingerprint` (code + path + source-line
hash, see `repro_torch.analysis.findings`), so entries survive line-number
churn but go stale the moment the offending line is edited — a changed
line must be re-justified. `python -m repro_torch.launch.lint
--update-baseline` rewrites the file from the current findings
(justifications for already-baselined entries are preserved).

A copy of `repro.analysis.baseline`; the default file is the port's own
`reprolint_baseline.txt` beside this module.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

from repro_torch.analysis.findings import Finding

DEFAULT_BASELINE = Path(__file__).resolve().parent / "reprolint_baseline.txt"


def load_baseline(path: Path | str | None = None) -> dict[str, str]:
    """Parse the baseline file into {fingerprint: justification}.

    A missing file is an empty baseline (fresh checkouts of a clean tree
    need no ledger to pass)."""
    p = Path(path) if path is not None else DEFAULT_BASELINE
    if not p.exists():
        return {}
    entries: dict[str, str] = {}
    for raw in p.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        body, _, comment = line.partition("#")
        parts = body.split()
        if len(parts) != 2:
            raise ValueError(f"malformed baseline line: {raw!r}")
        entries[parts[1]] = comment.strip()
    return entries


def write_baseline(
    findings: Iterable[Finding],
    path: Path | str | None = None,
    *,
    keep: dict[str, str] | None = None,
) -> Path:
    """Write a baseline covering `findings`, preserving justifications from
    `keep` (the previously loaded baseline) where fingerprints match."""
    p = Path(path) if path is not None else DEFAULT_BASELINE
    keep = keep or {}
    lines = [
        "# reprolint suppression baseline of the port — one intentional",
        "# finding per line: `CODE fingerprint  # justification`.",
        "# Regenerate with",
        "#   python -m repro_torch.launch.lint --update-baseline",
        "# Entries go stale (and the gate fails) when the offending source",
        "# line changes: re-justify or fix, never blind-refresh.",
        "",
    ]
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.code)):
        lines.append(f.baseline_entry(keep.get(f.fingerprint, "")))
    p.write_text("\n".join(lines) + "\n")
    return p


def split_baselined(
    findings: Iterable[Finding], baseline: dict[str, str]
) -> tuple[list[Finding], list[Finding]]:
    """Partition findings into (new, baselined) against a loaded baseline."""
    new: list[Finding] = []
    old: list[Finding] = []
    for f in findings:
        (old if f.fingerprint in baseline else new).append(f)
    return new, old
