"""reprolint Layer 2 of the port: the contract checker over the LIVE
kernel registries, the counterpart of `repro.analysis.contracts`.

The reference abstract-evaluates each entry (`jax.eval_shape`,
`jax.make_jaxpr`). A ctypes kernel has no abstract form, so the port runs
each entry on tiny real tensors on `device=` (n = 64, tb = 8, d = 8,
k = 4 by default): on the CPU every kernel wrapper takes its plain
version, on the card it launches the hand-written kernel. At these sizes
the compute is negligible. The checks:

  * C101/C102/C103: every entry of `core/sti_knn.py`'s square, accumulate
    and rect fill tables returns `(n, n)` / `(nr, n)` float32 (nr = n/2),
    and an accumulate form returns the `acc` it was given (same
    `data_ptr()`) holding acc + the fill (the "xla" oracle's).
  * C201: every prepared step of `stream_methods()`, single-device and
    sharded (one shard), maps its `AccumulatorSpec` state to the same
    shapes and dtypes.
  * C301: the port's "no copy breaks donation". A `TorchDispatchMode`
    logs the step's ops: no op may read a state tensor into a fresh
    tensor of its shape (a copy or out-of-place update of the state), no
    op may allocate a fresh tensor of the (n, n) accumulator's shape, and
    the state tensors come back with their own `data_ptr()`.
  * C302: the single-device step dispatches no copy between devices.
  * C401: the port's "one jaxpr": for batch sizes {tb, tb - 3, 1} sent
    through `pad_test_batch` the step dispatches the same sequence of
    (op, input shapes).
  * C501: `core/methods.py::ENGINES` and the stream-kernel registry agree.
  * C601: every method prepared with `fill="megakernel"`, single-device
    and sharded, calls its megakernel entry exactly once a step and the
    distance and fill entries never.

A kernel entry is one record in the op log, as a `pallas_call` is one eqn
in a jaxpr: the ops its plain version dispatches on the CPU are not
logged (they are the kernel's inside, one launch on the card). Entry
calls are counted as the wrappers' `.launches` (the card) plus the calls
into their plain versions (the CPU). Every check runs even when an
earlier one fails. Findings use `registry://...` paths.

    from repro_torch.analysis.contracts import check_contracts
    findings = check_contracts(device="cpu")      # [] when all hold
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import traceback
from collections import Counter
from typing import Callable, Iterator

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding
from repro_torch.device import resolve_device

__all__ = [
    "ENTRIES",
    "check_contracts",
    "check_fill_registries",
    "check_step_contracts",
    "check_step_ops",
    "check_retrace_sentinel",
    "check_engine_table",
    "check_megakernel_contract",
    "entry_calls",
]

# the kernel entries: name -> (module, CUDA wrapper, its plain version)
ENTRIES = {
    "distance": ("repro_torch.kernels.distance", "distance_cuda",
                 "distance_plain"),
    "sti_fill_acc": ("repro_torch.kernels.sti_fill", "sti_fill_acc_cuda",
                     "sti_fill_acc_plain"),
    "sti_fill_acc_rect": ("repro_torch.kernels.sti_fill",
                          "sti_fill_acc_rect_cuda",
                          "sti_fill_acc_rect_plain"),
    "sti_megakernel": ("repro_torch.kernels.sti_megakernel",
                       "sti_megakernel_cuda", "sti_megakernel_plain"),
    "point_megakernel": ("repro_torch.kernels.sti_megakernel",
                         "point_megakernel_cuda", "point_megakernel_plain"),
    "rank_sort": ("repro_torch.kernels.rank_sort", "rank_order_cuda",
                  "rank_order_plain"),
    "point_update": ("repro_torch.kernels.point_update",
                     "point_update_cuda", "point_update_plain"),
}

# the implementations the steps are prepared with: the registered kernels
# ("cuda" launches on the card, the plain versions on the CPU), no
# tuning-cache IO
_FILL = "cuda"
_DISTANCE = "cuda"
_COPIES = {"aten::_to_copy", "aten::copy_"}


def _finding(code: str, where: str, message: str, fixit: str = "") -> Finding:
    """A contract finding anchored to a registry entry, not a source line."""
    return Finding(code=code, path=f"registry://{where}", line=0,
                   message=message, fixit=fixit)


def _err(exc: Exception) -> str:
    """One-line rendering of an exception for a finding."""
    return traceback.format_exception_only(type(exc), exc)[-1].strip()


# ------------------------------------------------------- op log, entries
def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _tensors(tree) -> list:
    """The tensors of an op's args / outputs."""
    return [t for t in _pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


class _OpLog(TorchDispatchMode):
    """Records each dispatched op as (name, input shapes, input storages,
    outputs, devices); a kernel entry's call is one record `kernel:<name>`
    and the ops inside its plain version are not recorded."""

    def __init__(self):
        super().__init__()
        self.ops: list[dict] = []
        self.opaque = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.opaque:
            ins = _tensors((args, kwargs))
            outs = _tensors(out)
            self.ops.append({
                "name": func.name(),
                "shapes": tuple(tuple(t.shape) for t in ins),
                "reads": {_storage(t) for t in ins if t.numel()},
                "outs": [(tuple(t.shape), _storage(t)) for t in outs
                         if t.numel()],
                "devices": {t.device for t in ins + outs},
            })
        return out


_CALLS: Counter = Counter()      # calls into the plain versions
_ACTIVE_LOGS: list = []          # the op logs an entry call records into


def _counting(name: str, fn: Callable) -> Callable:
    @functools.wraps(fn)
    def plain(*args, **kwargs):
        _CALLS[name] += 1
        for log in _ACTIVE_LOGS:
            log.ops.append({
                "name": f"kernel:{name}", "reads": set(), "outs": [],
                "shapes": tuple(tuple(t.shape) for t in _tensors(
                    (args, kwargs))), "devices": set()})
            log.opaque += 1
        try:
            return fn(*args, **kwargs)
        finally:
            for log in _ACTIVE_LOGS:
                log.opaque -= 1
    return plain


@contextlib.contextmanager
def _entries() -> Iterator[None]:
    """The plain versions of the kernel entries counted (`entry_calls`)
    and recorded as one op each in the active logs, for the length of the
    block."""
    saved = []
    for name, (mod, _, plain) in ENTRIES.items():
        m = importlib.import_module(mod)
        saved.append((m, plain, getattr(m, plain)))
        setattr(m, plain, _counting(name, getattr(m, plain)))
    try:
        yield
    finally:
        for m, plain, fn in saved:
            setattr(m, plain, fn)


@contextlib.contextmanager
def _logging(log: _OpLog) -> Iterator[_OpLog]:
    _ACTIVE_LOGS.append(log)
    try:
        with log:
            yield log
    finally:
        _ACTIVE_LOGS.remove(log)


def entry_calls() -> dict:
    """{entry: calls so far}: each CUDA wrapper's `.launches` plus the
    calls into its plain version made under `_entries` (the checker's
    own)."""
    out = {}
    for name, (mod, wrapper, _) in ENTRIES.items():
        m = importlib.import_module(mod)
        out[name] = getattr(m, wrapper).launches + _CALLS[name]
    return out


# ----------------------------------------------------------- the inputs
def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _fill_inputs(n: int, tb: int, dev: torch.device):
    gen = _gen()
    g = torch.randn((tb, n), generator=gen).to(dev)
    ranks = torch.argsort(torch.rand((tb, n), generator=gen), dim=1).to(dev)
    return g, ranks


def _batch(n: int, d: int, tb: int, dev: torch.device, b: int | None = None):
    """(xb, yb, mask, x_train, y_train): b <= tb real test points padded to
    tb through `pad_test_batch`, as a session sends them."""
    from repro_torch.kernels.sti_pipeline import pad_test_batch

    gen = _gen(1)
    x_train = torch.randn((n, d), generator=gen).to(dev)
    y_train = torch.randint(0, 2, (n,), generator=gen).to(dev)
    xb = torch.randn((tb if b is None else b, d), generator=gen).to(dev)
    yb = torch.randint(0, 2, (xb.shape[0],), generator=gen).to(dev)
    xb, yb, mask = pad_test_batch(xb, yb, tb)
    return xb, yb, mask, x_train, y_train


# ----------------------------------------------------------- fill tables
def check_fill_registries(n: int = 64, tb: int = 8,
                          device="cuda") -> list[Finding]:
    """C101/C102/C103: every registered square/rect fill entry maps the
    canonical inputs to the accumulator's (shape, f32) contract.

    Square fills: `fn(g(tb, n), ranks(tb, n)) -> (n, n) f32`; their
    accumulate forms take `acc` first and must return it, updated in
    place with the fill (held to the "xla" oracle, 1e-5 of its largest
    value). Rect fills: `fn(g(tb, n), r_rows(tb, nr), r_cols(tb, n)) ->
    (nr, n) f32`, nr = n/2 (a row block strictly smaller than n, so a
    kernel that confuses the two bases cannot pass by coincidence); the
    row table is the window of the column table at n - nr, as the sharded
    engine's row blocks are."""
    from repro_torch.core.sti_knn import (
        _ACC_FILL_FNS, _FILL_FNS, _RECT_ACC_FILL_FNS, _RECT_FILL_FNS)
    from repro_torch.kernels.sti_fill import rect_row_view

    dev = resolve_device(device)
    nr = n // 2
    g, ranks = _fill_inputs(n, tb, dev)
    r_rows = rect_row_view(ranks, n - nr, nr)
    want_sq = _FILL_FNS["xla"](g, ranks)
    want_rect = _RECT_FILL_FNS["xla"](g, r_rows, ranks)
    tables = (
        ("fill", _FILL_FNS, (g, ranks), None, "C101"),
        ("acc_fill", _ACC_FILL_FNS, (g, ranks), want_sq, "C102"),
        ("rect_fill", _RECT_FILL_FNS, (g, r_rows, ranks), None, "C103"),
        ("rect_acc_fill", _RECT_ACC_FILL_FNS, (g, r_rows, ranks),
         want_rect, "C103"),
    )
    out: list[Finding] = []
    for table, fns, args, oracle, code in tables:
        want = (n, n) if table in ("fill", "acc_fill") else (nr, n)
        for name in sorted(fns):
            where = f"{table}/{name}"
            acc = before = None
            if oracle is not None:
                acc = torch.randn(want, generator=_gen(2)).to(dev)
                before = acc.clone()
                args_ = (acc,) + args
            else:
                args_ = args
            try:
                with _entries():
                    res = fns[name](*args_)
            except Exception as exc:  # noqa: BLE001 - report, don't crash
                out.append(_finding(
                    code, where,
                    f"registry entry failed on {dev.type} tensors: "
                    f"{_err(exc)}",
                    "the entry must run with its default static params "
                    "on the CPU and on the card"))
                continue
            if tuple(res.shape) != want:
                out.append(_finding(
                    code, where,
                    f"fill returns shape {tuple(res.shape)}, accumulator "
                    f"contract requires {want}",
                    "the fill result is added into the accumulator: "
                    "shapes must match exactly"))
            if res.dtype != torch.float32:
                out.append(_finding(
                    code, where,
                    f"fill returns dtype {res.dtype}, accumulators are "
                    f"float32",
                    "accumulate in f32 (cast inputs up, not the result "
                    "down): the t*n^2 sum loses mass in low precision"))
            if acc is None:
                continue
            if res.data_ptr() != acc.data_ptr():
                out.append(_finding(
                    code, where,
                    "accumulate fill returns a new tensor, not the acc it "
                    "was given",
                    "update acc in place (add_ / the kernel's own write) "
                    "and return it"))
            elif tuple(acc.shape) == want:
                err = float((acc - before - oracle).abs().max())
                if not err <= 1e-5 * max(1.0, float(oracle.abs().max())):
                    out.append(_finding(
                        code, where,
                        f"acc was not updated in place with the fill "
                        f"(max |acc - (acc0 + xla)| = {err:.3e})",
                        "add the fill into acc itself"))
    return out


# ------------------------------------------------------ step preparation
def _prepared_steps(n: int, d: int, k: int, tb: int, dev: torch.device,
                    sharded: bool, fill: str = _FILL):
    """Yield `(label, step, spec, tb, group)` for every registered stream
    method, prepared single-device (group None) or sharded over one shard
    of `dev`; a method that fails to prepare yields its exception in
    place of the step."""
    from repro_torch.kernels.sti_pipeline import (
        prepare_sharded_stream_step, prepare_stream_step)
    from repro_torch.kernels.stream_kernels import stream_methods

    prefix = ("sharded_" if sharded else "") + (
        "megakernel" if fill == "megakernel" else "step")
    for method in stream_methods():
        label = f"{prefix}/{method}"
        try:
            if sharded:
                step, resolved, group, spec = prepare_sharded_stream_step(
                    method, n, d, k, devices=[dev], test_batch=tb,
                    fill=fill, distance=_DISTANCE)
                yield label, step, spec, resolved["test_batch"], group, \
                    resolved
            else:
                step, resolved, spec = prepare_stream_step(
                    method, n, d, k, test_batch=tb, fill=fill,
                    distance=_DISTANCE, device=dev)
                yield label, step, spec, tb, None, resolved
        except Exception as exc:  # noqa: BLE001
            yield label, exc, None, tb, None, {}


def _state(spec, n: int, dev: torch.device, group):
    return spec.init(n, dev) if group is None else spec.init_shards(n, group)


def _args(batch: tuple, group):
    """A batch as the step takes it: per-shard lists when sharded."""
    return batch if group is None else tuple([a] for a in batch)


def _flat(state) -> list:
    """The state's tensors (a sharded entry is a per-shard list)."""
    return [t for entry in state for t in (
        entry if isinstance(entry, (list, tuple)) else [entry])]


def _run(step, state, batch, group, log=None):
    """One step under the counted entries (and `log`, when given)."""
    with _entries(), (_logging(log) if log is not None
                      else contextlib.nullcontext()):
        return step(state, *_args(batch, group))


def check_step_contracts(n: int = 64, d: int = 8, k: int = 4, tb: int = 8,
                         device="cuda") -> list[Finding]:
    """C201: every prepared step maps its `AccumulatorSpec` state to an
    IDENTICALLY shaped/typed state. A state that grows, reshapes, or
    changes dtype would silently break checkpointing, the running-mean
    finalize and the in-place update all at once."""
    dev = resolve_device(device)
    out: list[Finding] = []
    for sharded in (False, True):
        for label, step, spec, tb_r, group, _ in _prepared_steps(
                n, d, k, tb, dev, sharded):
            if isinstance(step, Exception):
                out.append(_finding("C201", label,
                                    f"step failed to prepare: {_err(step)}"))
                continue
            state = _state(spec, n, dev, group)
            want = [(tuple(t.shape), t.dtype) for t in _flat(state)]
            try:
                res = _run(step, state, _batch(n, d, tb_r, dev), group)
            except Exception as exc:  # noqa: BLE001
                out.append(_finding("C201", label,
                                    f"prepared step failed: {_err(exc)}"))
                continue
            got = [(tuple(t.shape), t.dtype) for t in _flat(res)]
            if got != want:
                out.append(_finding(
                    "C201", label,
                    f"state contract broken: in {want} != out {got}",
                    "a streaming step must return state of exactly the "
                    "shapes/dtypes it received (AccumulatorSpec.shapes)"))
    return out


# ------------------------------------------------------------ op scans
def check_step_ops(n: int = 64, d: int = 8, k: int = 4, tb: int = 8,
                   device="cuda") -> list[Finding]:
    """C301/C302: run every prepared step under the op log.

    C301: an op that reads a state tensor into a fresh tensor of its
    shape, or any fresh (n, n) allocation, or a state tensor that comes
    back with another `data_ptr()`: the accumulator round-trips through a
    new buffer and peak memory doubles exactly where the streaming engine
    promises it won't (the JAX package's donation, the port's in-place
    update).
    C302: a copy between devices in the single-device step: a hidden
    transfer (a host round trip, or a tensor left on another device)."""
    dev = resolve_device(device)
    out: list[Finding] = []
    for sharded in (False, True):
        for label, step, spec, tb_r, group, _ in _prepared_steps(
                n, d, k, tb, dev, sharded):
            if isinstance(step, Exception):
                out.append(_finding("C301", label,
                                    f"step failed to prepare: {_err(step)}"))
                continue
            state = _state(spec, n, dev, group)
            tensors = _flat(state)
            ptrs = [t.data_ptr() for t in tensors]
            shapes = {_storage(t): tuple(t.shape) for t in tensors}
            try:
                log = _OpLog()
                res = _run(step, state, _batch(n, d, tb_r, dev), group, log)
            except Exception as exc:  # noqa: BLE001
                out.append(_finding("C301", label,
                                    f"step failed: {_err(exc)}"))
                continue
            for op in log.ops:
                for shape, ptr in op["outs"]:
                    if ptr in op["reads"]:
                        continue  # in place, or a view
                    read = [shapes[p] for p in op["reads"] if p in shapes]
                    if shape in read or shape == (n, n):
                        out.append(_finding(
                            "C301", label,
                            f"`{op['name']}` allocates a fresh {shape} "
                            f"tensor{' from the state' if read else ''}: "
                            f"the accumulator round-trips through a new "
                            f"buffer",
                            "update the state in place (add_ / the "
                            "kernel's own write); no copy, no out-of-place "
                            "op on it"))
                if not sharded and op["name"] in _COPIES and \
                        len(op["devices"]) > 1:
                    out.append(_finding(
                        "C302", label,
                        f"`{op['name']}` copies between devices "
                        f"{sorted(str(x) for x in op['devices'])} inside "
                        f"the single-device step",
                        "keep every operand of the step on its device; "
                        "stage host data before the step"))
            if [t.data_ptr() for t in _flat(res)] != ptrs:
                out.append(_finding(
                    "C301", label,
                    "state tensors come back with other data_ptr()s: the "
                    "step replaced its accumulator",
                    "return the state tensors it was given, updated in "
                    "place"))
    return out


# ------------------------------------------------------ retrace sentinel
def check_retrace_sentinel(n: int = 64, d: int = 8, k: int = 4,
                           tb: int = 8, device="cuda") -> list[Finding]:
    """C401: the pad-and-mask contract must dispatch ONE op sequence per
    prepared step across full, ragged and single-row test batches.

    Each raw batch size (tb, tb - 3, 1) goes through `pad_test_batch`
    exactly as a session sends it, the step runs under the op log, and
    the sequences of (op, input shapes) must be one: the step's work does
    not depend on how many test points are real (what a CUDA graph of the
    step would later need)."""
    dev = resolve_device(device)
    out: list[Finding] = []
    for sharded in (False, True):
        for label, step, spec, tb_r, group, _ in _prepared_steps(
                n, d, k, tb, dev, sharded):
            if isinstance(step, Exception):
                out.append(_finding("C401", label,
                                    f"step failed to prepare: {_err(step)}"))
                continue
            sizes = sorted({tb_r, max(1, tb_r - 3), 1})
            seqs = set()
            try:
                for b in sizes:
                    log = _OpLog()
                    _run(step, _state(spec, n, dev, group),
                         _batch(n, d, tb_r, dev, b), group, log)
                    seqs.add(tuple((op["name"], op["shapes"])
                                   for op in log.ops))
            except Exception as exc:  # noqa: BLE001
                out.append(_finding("C401", label,
                                    f"retrace sentinel failed: {_err(exc)}"))
                continue
            if len(seqs) != 1:
                out.append(_finding(
                    "C401", label,
                    f"{len(seqs)} distinct op sequences across padded "
                    f"batch sizes {sizes}: the step's work depends on the "
                    f"real batch size",
                    "pad_test_batch must give the step the (tb, d) shape "
                    "for every b <= tb, and the step must not branch on "
                    "the mask"))
    return out


# ------------------------------------------------------------ engine table
# ENGINES entries that route through the streaming pipeline and therefore
# require a registered stream kernel
_STREAMING_ENGINES = {"fused", "scan", "distributed", "sharded", "streamed"}


def check_engine_table() -> list[Finding]:
    """C501: the ENGINES table and the stream-kernel registry must agree —
    a method advertising a streaming engine without a kernel fails at
    dispatch; a kernel absent from the table is unreachable dead code."""
    from repro_torch.core.methods import ENGINES
    from repro_torch.kernels.stream_kernels import (
        has_stream_kernel, stream_methods)

    out: list[Finding] = []
    for method, engines in sorted(ENGINES.items()):
        if _STREAMING_ENGINES & set(engines) and not has_stream_kernel(method):
            out.append(_finding(
                "C501", f"engines/{method}",
                f"ENGINES advertises streaming engines "
                f"{sorted(_STREAMING_ENGINES & set(engines))} but no "
                f"update kernel is registered",
                "register_update_kernel(...) or drop the streaming "
                "engines from the ENGINES entry"))
    for method in stream_methods():
        if method not in ENGINES:
            out.append(_finding(
                "C501", f"engines/{method}",
                "stream kernel registered but method missing from the "
                "ENGINES table: unreachable from get_method()",
                "add the method (with its engine list) to "
                "repro_torch.core.methods.ENGINES"))
    return out


# ------------------------------------------------------------ megakernel
def check_megakernel_contract(n: int = 64, d: int = 8, k: int = 4,
                              tb: int = 8, device="cuda") -> list[Finding]:
    """C601: `fill="megakernel"` must resolve to a step that calls its
    megakernel entry (`sti_megakernel` for an interaction method,
    `point_megakernel` for a point method) exactly once a step, and the
    distance and fill entries never: distance, sort, tables and update
    in one launch, single-device and sharded alike."""
    from repro_torch.kernels.stream_kernels import accumulator_spec

    dev = resolve_device(device)
    out: list[Finding] = []
    for sharded in (False, True):
        for label, step, spec, tb_r, group, resolved in _prepared_steps(
                n, d, k, tb, dev, sharded, fill="megakernel"):
            if isinstance(step, Exception):
                out.append(_finding(
                    "C601", label,
                    f"megakernel step failed to prepare: {_err(step)}"))
                continue
            if resolved.get("fill") != "megakernel":
                out.append(_finding(
                    "C601", label,
                    f"fill='megakernel' resolved to "
                    f"{resolved.get('fill')!r}"))
                continue
            method = label.split("/", 1)[1]
            mega = ("sti_megakernel" if accumulator_spec(method).kind ==
                    "interaction" else "point_megakernel")
            state = _state(spec, n, dev, group)
            before = entry_calls()
            try:
                _run(step, state, _batch(n, d, tb_r, dev), group)
            except Exception as exc:  # noqa: BLE001
                out.append(_finding("C601", label,
                                    f"megakernel step failed: {_err(exc)}"))
                continue
            calls = {name: c - before[name]
                     for name, c in entry_calls().items()}
            want = {name: int(name == mega) for name in calls}
            if calls != want:
                out.append(_finding(
                    "C601", label,
                    f"one step called the kernel entries {calls}, the "
                    f"megakernel contract requires {want}",
                    "the fused step must run distance, sort, tables and "
                    "update inside one launch of its megakernel"))
    return out


def check_contracts(n: int = 64, d: int = 8, k: int = 4, tb: int = 8,
                    device="cuda") -> list[Finding]:
    """Run every Layer 2 contract check on `device`; [] means all hold.

    Sizes are tiny by default, and every check runs even if an earlier
    one fails, so one broken registry entry reports alongside, not
    instead of, the rest."""
    out: list[Finding] = []
    out.extend(check_fill_registries(n, tb, device))
    out.extend(check_step_contracts(n, d, k, tb, device))
    out.extend(check_step_ops(n, d, k, tb, device))
    out.extend(check_retrace_sentinel(n, d, k, tb, device))
    out.extend(check_engine_table())
    out.extend(check_megakernel_contract(n, d, k, tb, device))
    return sorted(out, key=lambda f: (f.code, f.path))
