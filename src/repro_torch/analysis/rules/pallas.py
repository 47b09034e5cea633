"""R4xx — launch-dimension checks of the Python kernel wrappers.

R403: a launch dimension computed with a plain floor division `a // B`,
      B a tile or block size, in a function under `kernels/` that never
      rounds up (`-(-a // B)`) or pads (`%` arithmetic). For a size that B
      does not divide, the last partial tile is dropped: its rows are
      never computed. The port's wrappers round up
      (`kernels/sti_fill.py::fill_tile_walk`,
      `kernels/flash_attention.py::_check`) and mask the tail in the
      kernel.

A divisor counts as a tile or block size when it is an int literal of at
least 32, or a name whose last part is upper case (`TILE`) or mentions a
tile, block, warp, thread or CTA.

The reference's R401 and R402 (BlockSpec index maps, input/output aliases)
belong to Pallas and have no counterpart: the port's kernels are CUDA C++,
not Python.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import (
    ModuleContext,
    dotted_name,
    last_part,
    rule,
    walk_functions,
)

_SCOPE_PREFIX = "kernels/"
_TILE_HINTS = ("tile", "block", "warp", "thread", "cta")


def _enclosing_function(tree: ast.Module,
                       node: ast.AST) -> Optional[ast.FunctionDef]:
    """Innermost function whose span contains `node` (by line range)."""
    best: Optional[ast.FunctionDef] = None
    for fn in walk_functions(tree):
        if fn.lineno <= node.lineno <= (fn.end_lineno or fn.lineno):
            if best is None or fn.lineno >= best.lineno:
                best = fn
    return best


def _tile_size(node: ast.expr) -> bool:
    """Whether a divisor reads as a tile or block size."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int) and node.value >= 32
    name = last_part(dotted_name(node))
    if not name:
        return False
    return name.isupper() or any(h in name.lower() for h in _TILE_HINTS)


def _rounds_up(fn: ast.AST) -> bool:
    """Whether `fn` rounds up (`-(-a // b)`) or does `%` arithmetic: the
    idioms that make a floor-divided launch dimension safe."""
    for node in ast.walk(fn):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
            return True
        if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
                and isinstance(node.operand, ast.BinOp)
                and isinstance(node.operand.op, ast.FloorDiv)
                and isinstance(node.operand.left, ast.UnaryOp)
                and isinstance(node.operand.left.op, ast.USub)):
            return True
    return False


@rule("R403", "grid-floordiv-without-padding")
def check_grid_divisibility(ctx: ModuleContext) -> Iterator[Finding]:
    """`a // TILE` in a kernel wrapper that never rounds up or pads."""
    if not ctx.relpath.startswith(_SCOPE_PREFIX):
        return
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.BinOp)
                and isinstance(node.op, ast.FloorDiv)
                and _tile_size(node.right)):
            continue
        fn = _enclosing_function(ctx.tree, node)
        if _rounds_up(fn if fn is not None else ctx.tree):
            continue
        yield ctx.finding(
            "R403", node,
            "launch dimension uses floor division by a tile size with no "
            "round-up or padding in sight: a size the tile does not "
            "divide silently drops the last partial tile",
            "round up (-(-n // TILE)) and mask the tail in the kernel, or "
            "pad the inputs to a tile multiple ((-n) % TILE)",
        )
