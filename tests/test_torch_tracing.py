"""The port's spans (`repro_torch.tracing`), on the CPU: one shared no-op
while no profiler records; under the profiler, each
`ValuationSession.update` opens the streaming step's spans nested as
`tracing` lists them; and every span the package opens is named in
`SPANS`, apart from the benchmark's own span names."""

import ast
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import ShardedValuationSession, ValuationSession, tracing
from repro_torch.tracing import SPANS, span

REPO = Path(__file__).resolve().parents[1]
STEP = ("step.distance", "step.rank", "step.contrib", "step.g",
        "step.update")


def _problem(n=64, d=4, t=20, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=gen)
    y = torch.randint(0, 3, (n,), generator=gen)
    xt = torch.randn((t, d), generator=gen)
    yt = torch.randint(0, 3, (t,), generator=gen)
    return x, y, xt, yt


def _spans(fn) -> list:
    """(name, parent's name) of each span `fn` opens, in the order they
    open, and whether any of them was a user annotation."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    evs = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                   e.is_user_annotation())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() in SPANS), key=lambda s: (s[0], -s[1]))
    assert not any(e[3] for e in evs)  # function-scope: no device mirror
    out, stack = [], []
    for s0, s1, name, _ in evs:
        while stack and stack[-1][1] <= s0:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((s0, s1, name))
    return out


def test_span_is_one_no_op_while_no_profiler_records(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd._profiler_enabled()
    assert span("step.rank") is span("session.update")
    x, y, xt, yt = _problem()
    for mode in ("sti", "knn_shapley"):
        sess = ValuationSession(x, y, k=3, mode=mode, test_batch=8,
                                device="cpu")
        sess.update(xt, yt)
        assert sess.t_seen == len(yt)


@pytest.mark.parametrize("mode", ["sti", "knn_shapley"])
def test_one_update_opens_the_step_s_spans_nested(mode):
    x, y, xt, yt = _problem()
    sess = ValuationSession(x, y, k=3, mode=mode, test_batch=8,
                            device="cpu")
    got = _spans(lambda: sess.update(xt[:8], yt[:8]))
    step = [s for s in STEP if mode == "sti" or s != "step.g"]
    assert got == [("session.update", None),
                   ("session.pad", "session.update")] + [
        (s, "session.update") for s in step]


def test_a_ragged_batch_opens_one_pad_and_one_step_a_slice():
    x, y, xt, yt = _problem(t=20)
    sess = ValuationSession(x, y, k=3, mode="sti", test_batch=8,
                            device="cpu")
    got = _spans(lambda: sess.update(xt, yt))
    names = [nm for nm, _ in got]
    assert names == ["session.update"] + ["session.pad", *STEP] * 3
    assert all(parent == "session.update" for _, parent in got[1:])


def test_the_sharded_step_opens_a_prologue_a_shard_and_one_update():
    x, y, xt, yt = _problem()
    sess = ShardedValuationSession(x, y, k=3, test_batch=8,
                                   devices=["cpu", "cpu"])
    names = [nm for nm, _ in _spans(lambda: sess.update(xt[:8], yt[:8]))]
    assert names == ["session.update", "session.pad"] + [
        "step.distance", "step.rank", "step.contrib", "step.g"] * 2 + [
        "step.update"]


@pytest.mark.parametrize("mode", ["sti", "knn_shapley"])
def test_the_spans_change_nothing_the_step_computes(mode):
    x, y, xt, yt = _problem()
    plain = ValuationSession(x, y, k=3, mode=mode, test_batch=8,
                             device="cpu")
    traced = ValuationSession(x, y, k=3, mode=mode, test_batch=8,
                              device="cpu")
    plain.update(xt, yt)
    _spans(lambda: traced.update(xt, yt))
    for a, b in zip(plain._state, traced._state):
        assert torch.equal(a, b)


def _span_literals() -> list:
    """Every argument of a `span(...)` call under src/repro_torch, with
    where it is; None for an argument that is not a string literal."""
    found = []
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id",
                                getattr(node.func, "attr", None)) == "span"):
                arg = node.args[0] if node.args else None
                lit = (arg.value if isinstance(arg, ast.Constant)
                       and isinstance(arg.value, str) else None)
                found.append((lit, f"{path.name}:{node.lineno}"))
    return found


def _benchmark_span_names() -> set:
    tree = ast.parse((REPO / "portbench" / "trace.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and [getattr(t, "id", None) for t in node.targets]
                == ["SPANS"]):
            return set(ast.literal_eval(node.value))
    raise AssertionError("portbench/trace.py names no SPANS")


def test_every_span_opened_is_named_in_spans_and_every_name_is_opened():
    found = _span_literals()
    assert found
    for lit, where in found:
        assert lit in SPANS, where
    assert {lit for lit, _ in found} == set(SPANS)
    assert len(set(SPANS)) == len(SPANS)
    assert tracing.SPANS is SPANS


def test_the_program_s_span_names_are_not_the_benchmark_s():
    assert not set(SPANS) & _benchmark_span_names()
