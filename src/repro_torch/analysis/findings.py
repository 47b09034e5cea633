"""Finding: one lint/contract diagnostic, with a stable fingerprint.

A finding is identified across refactors by its *fingerprint* — a short
hash of (rule code, repo-relative path, stripped source line text) — not
its line number, so the suppression baseline survives unrelated edits to
the same file and goes stale exactly when the offending line itself
changes (the desired behavior: a changed line must be re-justified).
Contract-checker findings have no source line; they fingerprint on
(code, path, message) instead.

A copy of `repro.analysis.findings` (there is no framework in it): the
same fields give the same fingerprint in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: rule `code`, location, human message, fix-it hint.

    `line` is 1-based (0 for whole-file / contract findings); `source_line`
    is the stripped text of the offending line (empty for contract
    findings) and feeds the fingerprint.
    """

    code: str          # "R501", "C201", ...
    path: str          # repo-relative posix path, or "<contracts>"
    line: int          # 1-based; 0 when no source anchor exists
    message: str       # what is wrong
    fixit: str = ""    # how to fix it (one line)
    source_line: str = ""

    @property
    def fingerprint(self) -> str:
        """Stable 12-hex id: hash of (code, path, line text or message)."""
        anchor = self.source_line.strip() or self.message
        key = f"{self.code}|{self.path}|{anchor}".encode()
        return hashlib.sha256(key).hexdigest()[:12]

    def render(self) -> str:
        """One-line diagnostic: `path:line: CODE message [fix: ...]`."""
        loc = f"{self.path}:{self.line}" if self.line else self.path
        fix = f"  [fix: {self.fixit}]" if self.fixit else ""
        return f"{loc}: {self.code} {self.message}{fix}"

    def baseline_entry(self, justification: str = "") -> str:
        """The line `write_baseline` emits for this finding."""
        note = justification or f"{self.path}:{self.line} {self.message}"
        return f"{self.code} {self.fingerprint}  # {note}"
