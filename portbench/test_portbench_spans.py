"""The program's spans in a traced window (`portbench/spans.py`): on a
known timeline, the benchmark's own reduction is the same with and
without the program's span events, `spans.reduce` puts each device op,
idle gap and blocking call under the innermost span, the records
(`trace.read`) carry the spans, and each span metric's reader gives
`spans.per_step`'s number; on a tiny CPU window, every step opens its
spans; on the card (marked `cuda`), each cell at its own size puts every
kernel under one span."""

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
    mirror on the card. `trace.reduce` gives the same kernels, busy time
    and device ops with and without them; the records (`trace.read`) add
    the spans and name each idle gap by the innermost span, the
    program's among them."""
    with_spans = trace.reduce(_events(TIMELINE))
    without = trace.reduce(_events(
        [e for e in TIMELINE if e.name() not in PROGRAM]))
    assert with_spans == without
    assert with_spans["busy_s"] == pytest.approx(85e-6)
    assert set(with_spans["kernels"]) == {
        "sq_dist_kernel", "sort_kernel", "gather_kernel", "fill_acc_kernel",
        "stray_kernel"}
    full = trace.read(_events(TIMELINE))
    assert {k: v for k, v in full.items() if k != "spans"} == dict(
        with_spans, breakdown=dict(with_spans["breakdown"],
                                   idle_gaps=full["breakdown"]["idle_gaps"]))
    assert [g[0] for g in full["breakdown"]["idle_gaps"]] == [
        "step.distance", "sync", "step.update", "sync"]
    assert full["spans"]["step.rank"]["device_s"] == pytest.approx(30e-6)


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
        "device.idle.program": 7.5, "rank.ms": 250.0, "contrib.ms": 200.0,
        "point_update.ms": 300.0})
    knn = {k: v for k, v in sp.items() if k != "step.g"}
    assert spans.per_step(knn, 2, 10.0)["contrib.ms"] == pytest.approx(150.0)
    # a reading none of whose spans ran is None, not 0
    assert spans.per_step({"update": sp["update"]}, 2, 10.0) == dict.fromkeys(
        got)


READERS = ("rank.ms", "session.enqueue_ms", "session.blocking_ms",
           "device.idle.program", "contrib.ms", "point_update.ms")


@pytest.mark.parametrize("name", READERS)
def test_each_span_reader_reads_per_step_from_the_records(name):
    """On the known timeline's records (two steps), each span metric's
    reader gives `per_step`'s number; with no spans in the records, or
    no step, it gives None."""
    full = trace.read(_events(TIMELINE))
    records = dict(full, steps=2)
    want = spans.per_step(full["spans"], 2, full["trace_window_s"])[name]
    read = harness.reader(name, ROOT)
    assert want is not None and read(records) == want
    assert read(dict(records, spans={})) is None
    assert read(dict(records, steps=0)) is None
    assert read({}) is None


def test_rank_ms_is_step_rank_s_device_time_a_step():
    """`rank.ms` reads the device time of the ops launched under
    `step.rank` a step (the 30 us sort kernel over two steps), and None
    where no `step.rank` span ran."""
    read = harness.reader("rank.ms", ROOT)
    full = trace.read(_events(TIMELINE))
    assert read(dict(full, steps=2)) == pytest.approx(1e3 * 30e-6 / 2)
    without = trace.read(_events([e for e in TIMELINE
                                  if e.name() != "step.rank"]))
    assert "step.rank" not in without["spans"]
    assert read(dict(without, steps=2)) is None


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
    the window is launched inside a span and counted once; the rank
    stage's kernels (`csrc/rank_sort.cu`) launch only under `step.rank`,
    the distance kernel only under `step.distance` and the fill only
    under `step.update`."""
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
    for kernel, home in (("sq_dist_kernel", "step.distance"),
                         ("minmax_kernel", "step.rank"),
                         ("pass_kernel", "step.rank"),
                         ("invert_kernel", "step.rank"),
                         ("fill_acc_kernel", "step.update")):
        where = {nm for nm, x in sp.items()
                 if any(kernel in op for op in x["ops"])}
        assert where <= {home}, (kernel, where)
    for kernel, home in (("sq_dist_kernel", "step.distance"),
                         ("pass_kernel", "step.rank")):
        assert any(kernel in op for op in sp[home]["ops"]), kernel
