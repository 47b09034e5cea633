"""The traced run's records: host spans and the device timeline.

Spans are `torch.profiler.record_function` ranges that the benchmark
opens around its calls into the program (`SPANS`: `window`, `generate`,
`update`, `sync`); with tracing off they cost nothing. The program opens
its own (`repro_torch.tracing.SPANS`) while the profiler records.
With it on, `torch.profiler` (CPU and CUDA activities) records the
window; its events are read in memory (nothing is written to disk) and
reduced (`read`) to what the per-layer readers take:

  * `kernels`: {device op name: [count, seconds]} inside the window;
  * `busy_s`: the union of the device's kernel, copy and set intervals
    inside the `window` span, and `trace_window_s` that span's length;
  * `spans`: {span name: `count`, `host_s`, `self_s`, `device_s`,
    `idle_s`, `blocking`, `ops`} for each span, the benchmark's and the
    program's, open in the window (`portbench.spans.reduce`);
  * `breakdown`: the ten device ops that took most time, and the ten
    longest idle gaps named by the innermost span open at their middle,
    the program's among them.
"""

from __future__ import annotations

import contextlib

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("window", "generate", "update", "sync")


class Spans:
    """`spans(name)` opens a named host span while tracing, else nothing."""

    def __init__(self, on: bool):
        self.on = bool(on)

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiled(on: bool, device: torch.device):
    """Profile the block when `on`; yields a dict that holds, after the
    block, the reduced trace (`read`) or nothing."""
    out: dict = {}
    if not on:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield out
    out.update(read([_event(e) for e in
                     prof.profiler.kineto_results.events()]))


def _event(e) -> dict:
    """One profiler event as `reduce` takes it. Its kind follows from
    where it ran and its name: on the card, a kernel, copy or set (or the
    card's mirror of a span, by name); on the host, a span, a CUDA API
    call (`cu...`, which carries the launch's correlation id) or an op."""
    from torch.autograd import DeviceType

    name = e.name()
    if e.device_type() == DeviceType.CUDA:
        cat = "gpu_user_annotation" if name in SPANS else "kernel"
    elif name in SPANS:
        cat = "user_annotation"
    elif name.startswith("cu"):
        cat = "cuda_runtime"
    else:
        cat = "cpu_op"
    return {"cat": cat, "name": name, "ts": e.start_ns() / 1e3,
            "dur": e.duration_ns() / 1e3, "corr": e.correlation_id()}


def _merge(intervals: list) -> list:
    merged: list = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def reduce(xs: list) -> dict:
    """Profiler events ({"cat", "name", "ts", "dur" in microseconds,
    "corr": the launch's correlation id}) -> `kernels`, `busy_s`,
    `trace_window_s` and the breakdown's `device_ops`, in seconds; {}
    without a `window` span."""
    win = [e for e in xs if e.get("cat") == "user_annotation"
           and e.get("name") == "window"]
    if not win:
        return {}
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and w0 <= e["ts"] <= w1]
    kernels: dict = {}
    for e in dev:
        c = kernels.setdefault(e["name"], [0, 0.0])
        c[0] += 1
        c[1] += e["dur"] / 1e6
    busy = _merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                   for e in dev])
    busy_us = sum(hi - lo for lo, hi in busy)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "kernels": kernels,
        "busy_s": busy_us / 1e6,
        "trace_window_s": (w1 - w0) / 1e6,
        "breakdown": {"device_ops": [[nm[:160], c[1]] for nm, c in top]},
    }


def read(xs: list) -> dict:
    """Profiler events -> the records of the module doc: `reduce`'s, and
    the spans and the breakdown's `idle_gaps` of `portbench.spans.reduce`
    (each gap named by the innermost span open at its middle, the
    program's among them)."""
    out = reduce(xs)
    if out:
        from portbench import spans

        sp = spans.reduce(xs)
        out["spans"] = sp["spans"]
        out["breakdown"]["idle_gaps"] = sp["idle_gaps"]
    return out
