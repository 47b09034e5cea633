"""Rule registry + shared AST helpers for the port's reprolint AST layer.

A rule is a function ``fn(ctx: ModuleContext) -> Iterable[Finding]``
registered under a stable code with the `@rule` decorator. The driver
(`repro_torch.analysis.lint`) builds one `ModuleContext` per source file
and runs every registered rule over it; rules never import the analyzed
code (pure AST — the semantic layer is `repro_torch.analysis.contracts`).

Codes keep the reference's numbers, so one code names one hazard in both
packages. The port keeps the rules whose hazard exists in eager PyTorch:

  R202  unhashable literal for a cached step factory (retrace.py)
  R403  launch dimension by floor division, no round-up (pallas.py)
  R601  tensor compute at import time (imports.py)
  R602  device probe at import time (imports.py)
  R701  unannotated host sync on the request path (hostsync.py)

The reference's R101, R201, R203, R301, R302, R401, R402 and R501 have no
counterpart: the port has no donation, nothing traced or compiled, no
free collective axis name and no Pallas call (README, "reprolint").
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Iterator

from repro_torch.analysis.findings import Finding

_RULES: dict[str, tuple[str, Callable]] = {}


def rule(code: str, name: str) -> Callable:
    """Register a lint rule under a stable `code` (e.g. "R601")."""

    def deco(fn: Callable) -> Callable:
        _RULES[code] = (name, fn)
        return fn

    return deco


def all_rules() -> dict[str, tuple[str, Callable]]:
    """{code: (name, fn)} for every registered rule, insertion-ordered."""
    return dict(_RULES)


@dataclasses.dataclass
class ModuleContext:
    """One analyzed source file: parsed tree + raw lines + location info."""

    relpath: str
    source: str
    tree: ast.Module
    lines: list[str]

    @classmethod
    def parse(cls, source: str, relpath: str) -> "ModuleContext":
        """Build a context from raw source (a syntax error raises here)."""
        return cls(relpath, source, ast.parse(source), source.splitlines())

    def finding(self, code: str, node: ast.AST, message: str,
                fixit: str = "") -> Finding:
        """A Finding anchored at `node`'s line of this module."""
        line = getattr(node, "lineno", 0)
        text = self.lines[line - 1] if 0 < line <= len(self.lines) else ""
        return Finding(code, self.relpath, line, message, fixit, text)


# ------------------------------------------------------------ AST helpers
def dotted_name(node: ast.AST) -> str:
    """`torch.cuda.synchronize` -> "torch.cuda.synchronize"; "" when not a
    plain dotted chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def last_part(name: str) -> str:
    """Final attribute of a dotted name ("torch.cuda.init" -> "init")."""
    return name.rsplit(".", 1)[-1] if name else ""


def walk_functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    """Every (async) function definition under `tree`, any nesting."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def mutable_display(node: ast.expr) -> bool:
    """Whether an expression is a list/dict/set display or comprehension
    (an unhashable value)."""
    return isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp))


def lru_cached_functions(tree: ast.Module) -> set[str]:
    """Names of the functions decorated with `functools.lru_cache` or
    `functools.cache`, plain or called (`lru_cache(maxsize=None)`)."""
    out: set[str] = set()
    for fn in walk_functions(tree):
        for dec in fn.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if last_part(dotted_name(target)) in ("lru_cache", "cache"):
                out.add(fn.name)
    return out


# Importing the rule modules registers them; keep this at the bottom so
# the helpers above exist when they import back.
from repro_torch.analysis.rules import (  # noqa: E402,F401
    retrace,
    pallas,
    imports,
    hostsync,
)
