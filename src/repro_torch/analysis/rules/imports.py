"""R6xx — import-time compute: keep `import repro_torch` free of device
work.

R601: a module-level statement (or a default argument, or a decorator)
      calls a tensor factory or op in `torch.*` (`torch.zeros`,
      `torch.tensor`, `torch.arange`, `torch.randn`, `torch.empty`,
      `F.pad`, ...): it allocates at import, on whatever device is the
      default, before the entry point has resolved `device=`, and a CUDA
      tensor there initializes the card in every process that imports
      the package (the tests' workers included). Dtypes are attributes,
      not calls, and stay legal, as do `torch.device(...)`,
      `torch.finfo`/`iinfo`, `torch.Size` and the grad-mode decorators.
R602: a device probe at module level (`torch.cuda.is_available`,
      `device_count`, `current_device`, `get_device_properties`,
      `get_device_name`, `init`): it initializes the CUDA runtime at
      import and fixes what the process saw then. Probe inside the
      function that needs the answer (`repro_torch.device.resolve_device`).
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import (
    ModuleContext,
    dotted_name,
    last_part,
    rule,
)

_DEVICE_PROBES = {
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "torch.cuda.get_device_properties",
    "torch.cuda.get_device_name", "torch.cuda.init",
}
# calls into torch.* that build no tensor and touch no device
_LEGAL = {"device", "finfo", "iinfo", "Size", "dtype", "no_grad",
          "enable_grad", "inference_mode", "set_grad_enabled"}


def _module_level_exprs(tree: ast.Module) -> Iterable[ast.expr]:
    """Expressions evaluated at import: module-level statements (descending
    through top-level if/try/with bodies and class bodies, NOT into
    function bodies) plus every function's default-argument expressions
    and decorators."""
    stack: list[ast.stmt] = list(tree.body)
    while stack:
        stmt = stack.pop()
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield from stmt.args.defaults
            yield from (d for d in stmt.args.kw_defaults if d is not None)
            yield from stmt.decorator_list
            continue  # the body runs only when called
        if isinstance(stmt, ast.ClassDef):
            yield from stmt.decorator_list
            stack.extend(stmt.body)  # class bodies DO run at import
            continue
        for attr in ("body", "orelse", "finalbody", "handlers"):
            sub = getattr(stmt, attr, None)
            if isinstance(sub, list):
                for s in sub:
                    if isinstance(s, ast.excepthandler):
                        stack.extend(s.body)
                    elif isinstance(s, ast.stmt):
                        stack.append(s)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            yield from (item.context_expr for item in stmt.items)
        for field in ("value", "test", "iter", "targets", "target"):
            val = getattr(stmt, field, None)
            if isinstance(val, ast.expr):
                yield val
            elif isinstance(val, list):
                yield from (v for v in val if isinstance(v, ast.expr))


def _aliases(tree: ast.Module) -> dict[str, str]:
    """{local name: full dotted name} for this module's imports of torch
    (`import torch.nn.functional as F`, `from torch import zeros`)."""
    out = {"torch": "torch"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == "torch":
                    out[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else "torch")
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] == "torch":
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _torch_name(call: ast.Call, aliases: dict[str, str]) -> str:
    """The callee's full `torch.*` name, or "" when it is not torch's."""
    name = dotted_name(call.func)
    head, _, rest = name.partition(".")
    if head not in aliases:
        return ""
    return aliases[head] + ("." + rest if rest else "")


def _import_time_calls(ctx: ModuleContext) -> Iterator[tuple[ast.Call,
                                                             str]]:
    aliases = _aliases(ctx.tree)
    for expr in _module_level_exprs(ctx.tree):
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                name = _torch_name(sub, aliases)
                if name:
                    yield sub, name


@rule("R601", "import-time-torch-compute")
def check_import_time_compute(ctx: ModuleContext) -> Iterator[Finding]:
    """Module-scope / default-arg torch tensor calls run at import time."""
    for call, name in _import_time_calls(ctx):
        if name in _DEVICE_PROBES or last_part(name) in _LEGAL:
            continue
        yield ctx.finding(
            "R601", call,
            f"import-time torch compute: '{name}(...)' allocates (and may "
            f"initialize the card) when the module is imported",
            "build the tensor lazily inside the function that uses it "
            "(or functools.lru_cache a builder keyed by device)",
        )


@rule("R602", "device-probe-at-import")
def check_device_probe(ctx: ModuleContext) -> Iterator[Finding]:
    """Module-scope CUDA probes initialize the runtime at import."""
    for call, name in _import_time_calls(ctx):
        if name in _DEVICE_PROBES:
            yield ctx.finding(
                "R602", call,
                f"device probe '{name}()' at import time: initializes the "
                f"CUDA runtime before any entry point has resolved its "
                f"device",
                "probe inside the function that needs the answer "
                "(repro_torch.device.resolve_device)",
            )
