"""reprolint Layer 1 driver of the port: run every registered AST rule
over a tree.

Pure static analysis — the analyzed code is parsed, never imported, so
the lint runs in milliseconds and cannot be perturbed by the package's
own import-time behavior (which rule R601 exists to police). Inline
suppression: append ``# reprolint: disable=R601`` (comma-separated codes,
or ``disable=all``) to the offending line. Tree-wide intentional findings
live in the checked-in baseline instead (`repro_torch.analysis.baseline`).

    from repro_torch.analysis import lint_tree
    findings = lint_tree()          # over src/repro_torch
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterable, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import ModuleContext, all_rules

DEFAULT_ROOT = Path(__file__).resolve().parents[1]  # src/repro_torch

_SUPPRESS_RE = re.compile(r"#\s*reprolint:\s*disable=([A-Za-z0-9,]+)")

# the analyzer does not lint itself: rule sources quote the very patterns
# they flag
_EXCLUDE_PARTS = {"analysis"}


def _suppressed(finding: Finding, lines: list[str]) -> bool:
    """Whether the finding's source line carries a matching inline
    `# reprolint: disable=...` marker."""
    if not (0 < finding.line <= len(lines)):
        return False
    m = _SUPPRESS_RE.search(lines[finding.line - 1])
    if not m:
        return False
    codes = {c.strip() for c in m.group(1).split(",")}
    return "all" in codes or finding.code in codes


def lint_source(source: str, relpath: str = "<snippet>",
                codes: Optional[Iterable[str]] = None) -> list[Finding]:
    """Lint raw source text; `codes` restricts to a subset of rules
    (fixture tests exercise one rule at a time). `relpath` places the
    snippet in the tree (R403 reads only `kernels/`, R701 only the request
    path)."""
    ctx = ModuleContext.parse(source, relpath)
    wanted = set(codes) if codes is not None else None
    out: list[Finding] = []
    for code, (_, fn) in all_rules().items():
        if wanted is not None and code not in wanted:
            continue
        out.extend(fn(ctx))
    return [f for f in out if not _suppressed(f, ctx.lines)]


def lint_file(path: Path | str, root: Path | str | None = None
              ) -> list[Finding]:
    """Lint one file; paths in findings are relative to `root` (or the
    file's parent) so fingerprints are checkout-independent."""
    p = Path(path)
    base = Path(root) if root is not None else p.parent
    try:
        rel = p.resolve().relative_to(base.resolve()).as_posix()
    except ValueError:
        rel = p.name
    return lint_source(p.read_text(), rel)


def lint_tree(root: Path | str | None = None) -> list[Finding]:
    """Lint every `*.py` under `root` (default: src/repro_torch), excluding
    the analyzer's own sources, sorted by (path, line, code)."""
    base = Path(root) if root is not None else DEFAULT_ROOT
    findings: list[Finding] = []
    for p in sorted(base.rglob("*.py")):
        if _EXCLUDE_PARTS & set(p.relative_to(base).parts[:-1]):
            continue
        findings.extend(lint_file(p, base))
    return sorted(findings, key=lambda f: (f.path, f.line, f.code))
