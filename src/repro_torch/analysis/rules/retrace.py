"""R2xx — cache-key hazards of the step factories.

R202: an unhashable literal (list/dict/set display or comprehension)
      passed to a cached step factory (`functools.lru_cache`-wrapped in
      the same module) or to a `*_static` keyword. The port builds each
      step once per configuration through such factories
      (`kernels/sti_pipeline.py`, `kernels/autotune.py`); their cache
      keys on the arguments' hash, so a list raises `TypeError` at the
      call. The convention is hashable tuples — `_method_static` /
      `resolve_fill` produce them.

The reference's R201 and R203 (a jit closure over a mutable, a shape
branch inside jit) have no counterpart: nothing in the port is traced or
compiled, so nothing can go stale or be traced again.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import (
    ModuleContext,
    dotted_name,
    last_part,
    lru_cached_functions,
    mutable_display,
    rule,
)


@rule("R202", "unhashable-static-argument")
def check_unhashable_static(ctx: ModuleContext) -> Iterator[Finding]:
    """List/dict/set literal passed to a cached step factory or a
    `*_static` keyword."""
    cached = lru_cached_functions(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = dotted_name(node.func)
        is_cached = last_part(callee) in cached
        for kw in node.keywords:
            if kw.arg and kw.arg.endswith("_static") and \
                    mutable_display(kw.value):
                yield ctx.finding(
                    "R202", kw.value,
                    f"unhashable literal for static keyword '{kw.arg}' of "
                    f"'{callee}'",
                    "pass the hashable tuple form (e.g. "
                    "tuple(sorted(d.items())) — see _method_static)",
                )
            elif is_cached and mutable_display(kw.value):
                yield ctx.finding(
                    "R202", kw.value,
                    f"unhashable literal for '{kw.arg}' of lru_cached "
                    f"'{callee}': the step cache keys on argument hash "
                    f"and raises TypeError",
                    "pass a hashable tuple instead",
                )
        if is_cached:
            for arg in node.args:
                if mutable_display(arg):
                    yield ctx.finding(
                        "R202", arg,
                        f"unhashable positional literal passed to "
                        f"lru_cached '{callee}'",
                        "pass a hashable tuple instead",
                    )
