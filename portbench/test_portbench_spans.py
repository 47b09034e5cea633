"""The program's spans in a traced window (`portbench/spans.py`): on a
known timeline, the benchmark's own reduction is the same with and
without the program's span events, and `spans.reduce` puts each device
op, idle gap and blocking call under the innermost span; on a tiny CPU
window, every step opens its spans; on the card (marked `cuda`), each
cell at its own size puts every kernel under one span."""

from pathlib import Path

import pytest
from torch.autograd import DeviceType

from portbench import harness, spans, trace

ROOT = Path(__file__).resolve().parents[1]
SPEC = harness.load_spec(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2_147_483_659
CPU, GPU = DeviceType.CPU, DeviceType.CUDA
PROGRAM = ("session.update", "session.pad", "step.distance", "step.rank",
           "step.contrib", "step.g", "step.update")


class Ev:
    """A profiler event as `trace._event` reads one (times in us)."""

    def __init__(self, name, dev, ts, dur, corr=0):
        self.args = (name, dev, ts, dur, corr)

    def name(self):
        return self.args[0]

    def device_type(self):
        return self.args[1]

    def start_ns(self):
        return self.args[2] * 1000

    def duration_ns(self):
        return self.args[3] * 1000

    def correlation_id(self):
        return self.args[4]


# A 200 us window: one harness `update` that opens the program's spans,
# four kernels launched from them and one whose launch was not recorded,
# a wait on the stream inside `step.update` and a harness `sync`.
TIMELINE = [
    Ev("window", CPU, 0, 200), Ev("update", CPU, 10, 100),
    Ev("session.update", CPU, 12, 96), Ev("session.pad", CPU, 14, 5),
    Ev("step.distance", CPU, 20, 10),
    Ev("cudaLaunchKernel", CPU, 22, 1, 1),
    Ev("step.rank", CPU, 30, 20), Ev("aten::sort", CPU, 31, 14),
    Ev("cudaLaunchKernel", CPU, 32, 1, 2), Ev("cudaMalloc", CPU, 46, 3, 5),
    Ev("step.contrib", CPU, 50, 10),
    Ev("cudaLaunchKernel", CPU, 52, 1, 3),
    Ev("step.update", CPU, 60, 46),
    Ev("cudaLaunchKernel", CPU, 61, 1, 4),
    Ev("cudaStreamSynchronize", CPU, 70, 30, 6),
    Ev("sync", CPU, 150, 40), Ev("cudaDeviceSynchronize", CPU, 151, 4, 7),
    Ev("sq_dist_kernel", GPU, 40, 20, 1), Ev("sort_kernel", GPU, 60, 30, 2),
    Ev("gather_kernel", GPU, 120, 10, 3),
    Ev("fill_acc_kernel", GPU, 130, 20, 4),
    Ev("stray_kernel", GPU, 160, 5, 99),
    Ev("update", GPU, 40, 110),  # the card's mirror of the harness span
]


def _events(timeline):
    return [trace._event(e) for e in timeline]


def test_the_program_spans_leave_the_benchmark_s_reduction_as_it_was():
    """The program's spans are function-scope ranges: host events with no
    mirror on the card. `trace.reduce` gives the same records with and
    without them, its gaps named by the benchmark's spans alone."""
    with_spans = trace.reduce(_events(TIMELINE))
    without = trace.reduce(_events(
        [e for e in TIMELINE if e.name() not in PROGRAM]))
    assert with_spans == without
    assert with_spans["busy_s"] == pytest.approx(85e-6)
    assert with_spans["rank_s"] == pytest.approx(30e-6)
    assert set(with_spans["kernels"]) == {
        "sq_dist_kernel", "sort_kernel", "gather_kernel", "fill_acc_kernel",
        "stray_kernel"}
    assert [g[0] for g in with_spans["breakdown"]["idle_gaps"]] == [
        "update", "sync", "update", "sync"]


def test_a_span_mirrored_on_the_card_is_no_device_work_to_spans_reduce():
    """Were a program span a user annotation, the profiler would mirror it
    on the card and `trace.reduce` would take the mirror for a kernel;
    `spans.reduce` never counts it."""
    mirrored = TIMELINE + [Ev("step.update", GPU, 130, 20)]
    assert "step.update" in trace.reduce(_events(mirrored))["kernels"]
    got = spans.reduce(_events(mirrored))["spans"]
    assert got == spans.reduce(_events(TIMELINE))["spans"]
    assert sum(r["device_s"] for r in got.values()) == pytest.approx(80e-6)


def test_spans_reduce_on_a_known_timeline():
    r = spans.reduce(_events(TIMELINE))
    sp = r["spans"]
    assert set(sp) == {"window", "update", "sync"} | set(PROGRAM) - {
        "step.g"}
    assert all(sp[nm]["count"] == 1 for nm in sp)
    host = {"window": 200, "update": 100, "session.update": 96,
            "session.pad": 5, "step.distance": 10, "step.rank": 20,
            "step.contrib": 10, "step.update": 46, "sync": 40}
    self_ = dict(host, window=60, update=4, **{"session.update": 5})
    device = {"step.distance": 20, "step.rank": 30, "step.contrib": 10,
              "step.update": 20}
    idle = {"step.distance": 40, "step.update": 30, "sync": 45}
    for nm, rec in sp.items():
        assert rec["host_s"] == pytest.approx(host[nm] * 1e-6), nm
        assert rec["self_s"] == pytest.approx(self_[nm] * 1e-6), nm
        assert rec["device_s"] == pytest.approx(device.get(nm, 0) * 1e-6)
        assert rec["idle_s"] == pytest.approx(idle.get(nm, 0) * 1e-6), nm
    assert sp["step.rank"]["ops"] == {"sort_kernel": [1, pytest.approx(3e-5)]}
    assert sp["step.rank"]["blocking"] == {
        "cudaMalloc": [1, pytest.approx(3e-6)]}
    assert sp["step.update"]["blocking"] == {
        "cudaStreamSynchronize": [1, pytest.approx(3e-5)]}
    assert sp["sync"]["blocking"] == {
        "cudaDeviceSynchronize": [1, pytest.approx(4e-6)]}
    assert r["unattributed"] == [1, pytest.approx(5e-6)]
    assert r["idle_gaps"] == [["step.distance", pytest.approx(4e-5)],
                              ["sync", pytest.approx(3.5e-5)],
                              ["step.update", pytest.approx(3e-5)],
                              ["sync", pytest.approx(1e-5)]]
    # the window's idle time is split among the spans, none left over
    assert sum(x["idle_s"] for x in sp.values()) == pytest.approx(115e-6)


def test_spans_reduce_needs_a_window():
    assert spans.reduce(_events(TIMELINE[1:])) == {}


def test_per_step_on_hand_built_spans():
    def rec(host=0.0, device=0.0, idle=0.0, blocking=None):
        return {"count": 2, "host_s": host, "self_s": host,
                "device_s": device, "idle_s": idle,
                "blocking": blocking or {}, "ops": {}}

    sp = {"update": rec(host=9.0, idle=5.0,
                        blocking={"cudaFree": [1, 7.0]}),
          "session.update": rec(host=0.8, idle=0.25),
          "step.rank": rec(device=0.5, idle=0.5,
                           blocking={"cudaMalloc": [2, 0.1]}),
          "step.contrib": rec(device=0.3),
          "step.g": rec(device=0.1),
          "step.update": rec(device=0.6,
                             blocking={"cudaStreamSynchronize": [1, 0.3]})}
    got = spans.per_step(sp, steps=2, window_s=10.0)
    assert got == pytest.approx({
        "session.enqueue_ms": 400.0, "session.blocking_ms": 200.0,
        "device.idle.program": 7.5, "contrib.ms": 200.0,
        "point_update.ms": 300.0})
    knn = {k: v for k, v in sp.items() if k != "step.g"}
    assert spans.per_step(knn, 2, 10.0)["contrib.ms"] == pytest.approx(150.0)


def _tiny(cell: str) -> dict:
    r = harness.resolve(SPEC, cell, ROOT)
    n = 4096 if r["config"]["method"] == "knn_shapley" else 1024
    r["config"] = dict(r["config"], n=n)
    r["mix"] = dict(r["mix"], test_batch=32)
    return r


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_window_on_the_cpu_opens_every_span_each_step(cell):
    r = _tiny(cell)
    rec, events = spans.traced_window(r, SEED, 0.3, device="cpu")
    out = spans.summary(rec, events)
    assert out["accepted_unchanged"]
    got = out["spans_ms_per_step"]
    steps = rec["steps"]
    g = r["config"]["method"] == "sti"
    for nm in PROGRAM:
        if nm == "step.g" and not g:
            assert nm not in got
        else:
            assert got[nm]["count"] == steps, nm
    assert got["update"]["count"] == steps
    # the session's enqueue is the harness's `update` less its own call
    assert got["session.update"]["host_ms"] <= got["update"]["host_ms"]
    assert out["unattributed"] == [0, 0.0]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_every_kernel_on_the_card_falls_under_one_span(cell, cuda_device):
    """Each cell at its own size, a 2 s traced window: every device op of
    the window is launched inside a span and counted once; the kernels
    `rank_s` reads are all under `step.rank`; the distance kernel
    launches only under `step.distance` and the fill only under
    `step.update`."""
    import torch

    r = harness.resolve(SPEC, cell, ROOT)
    rec, events = spans.traced_window(r, SEED + 5, 2.0, device=cuda_device)
    torch.cuda.empty_cache()
    base = trace.reduce(events)
    assert base == trace.reduce([e for e in events
                                 if e["name"] not in PROGRAM])
    got = spans.reduce(events)
    sp = got["spans"]
    assert got["unattributed"] == [0, 0.0]
    total = sum(c[1] for c in base["kernels"].values())
    assert sum(x["device_s"] for x in sp.values()) == pytest.approx(total)
    assert sum(x["idle_s"] for x in sp.values()) == pytest.approx(
        base["trace_window_s"] - base["busy_s"])
    # the kernels launched inside aten::sort and aten::scatter_
    rank = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e["cat"] == "cpu_op" and e["name"] in trace.RANK_OPS)
    named = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e["name"] in set(trace.SPANS) | set(PROGRAM)
                    and e["cat"] in spans.HOST_CATS),
                   key=lambda s: (s[0], -s[1]))
    nest = spans._Nest(named)
    for lo, hi in rank:
        for e in events:
            if e["cat"] == "cuda_runtime" and lo <= e["ts"] <= hi:
                assert named[nest.owner(e["ts"])][2] == "step.rank"
    assert sp["step.rank"]["device_s"] >= base["rank_s"] * (1 - 1e-9)
    for kernel, home in (("sq_dist_kernel", "step.distance"),
                         ("fill_acc_kernel", "step.update")):
        where = {nm for nm, x in sp.items()
                 if any(kernel in op for op in x["ops"])}
        assert where <= {home}, (kernel, where)
    assert any("sq_dist_kernel" in op for op in sp["step.distance"]["ops"])
