"""R7xx — request-path host-sync discipline for the serving layer.

R701: a blocking host synchronization (`.item()`, `.tolist()`, `.cpu()`,
      `.numpy()`, `np.asarray(...)`, `torch.cuda.synchronize()`,
      `<stream or event>.synchronize()`) inside a REQUEST-PATH module:
      `serving/*` and `core/resilient.py`. Each makes the host wait for
      every kernel queued before it, so one stray call turns the request
      pipeline into a lockstep round-trip per request.

      Deliberate synchronization points stay allowed when ANNOTATED with
      a ``# sync-point: <why>`` comment -- on the flagged line, the
      comment line(s) directly above it, or in the enclosing function's
      header (the ``def`` line through the first body statement): the
      placement rules of the reference's `rules/hostsync.py`. The
      annotation is the reviewable contract: every blocking sync on the
      request path must say why it is there.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import (
    ModuleContext,
    dotted_name,
    rule,
    walk_functions,
)

# modules where request latency is the contract
_SCOPE_PREFIXES = ("serving/",)
_SCOPE_FILES = ("core/resilient.py",)

_SYNC_CALLS = {"np.asarray", "numpy.asarray", "torch.cuda.synchronize"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}


def _in_scope(relpath: str) -> bool:
    return relpath.startswith(_SCOPE_PREFIXES) or relpath in _SCOPE_FILES


def _sync_call(node: ast.Call) -> Optional[str]:
    """The offending sync spelling, or None for a benign call."""
    name = dotted_name(node.func)
    if name in _SYNC_CALLS:
        return name
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_METHODS and not node.args
            and not node.keywords):
        # method form, on a name or a computed value: x.item(),
        # state[0].cpu(), f(x).numpy(), stream.synchronize()
        return f".{node.func.attr}()"
    return None


def _function_spans(tree: ast.Module) -> list[tuple[int, int, int]]:
    """(def_line, first_body_line, end_line) per function."""
    spans = []
    for fn in walk_functions(tree):
        body_start = fn.body[0].lineno if fn.body else fn.lineno
        spans.append((fn.lineno, body_start, fn.end_lineno or fn.lineno))
    return spans


def _annotated(ctx: ModuleContext, line: int,
               spans: list[tuple[int, int, int]]) -> bool:
    """Whether `line` is covered by a ``# sync-point:`` annotation."""

    def has(ln: int) -> bool:
        return (0 < ln <= len(ctx.lines)
                and "sync-point:" in ctx.lines[ln - 1])

    if has(line):
        return True
    ln = line - 1  # the comment block directly above the flagged line
    while ln >= 1 and ctx.lines[ln - 1].lstrip().startswith("#"):
        if has(ln):
            return True
        ln -= 1
    for def_line, body_start, end in spans:  # enclosing function header
        if def_line <= line <= end and any(
                has(h) for h in range(def_line, body_start)):
            return True
    return False


@rule("R701", "request-path-host-sync")
def check_request_path_host_sync(ctx: ModuleContext) -> Iterator[Finding]:
    """Unannotated blocking host syncs in serving/resilient modules."""
    if not _in_scope(ctx.relpath):
        return
    spans = _function_spans(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        spelling = _sync_call(node)
        if spelling is None:
            continue
        if _annotated(ctx, node.lineno, spans):
            continue
        yield ctx.finding(
            "R701", node,
            f"blocking host sync '{spelling}' on the request path "
            f"({ctx.relpath}): this stalls the service until every "
            f"queued kernel finishes",
            fixit="keep values on the device or move the sync off the hot "
                  "path; a deliberate sync must be annotated "
                  "'# sync-point: <why>' on the line, directly above it, "
                  "or in the enclosing def header",
        )
