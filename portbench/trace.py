"""The traced run's records: host spans and the device timeline.

Spans are `torch.profiler.record_function` ranges that the benchmark
opens around its calls into the program (`SPANS`: `window`, `generate`,
`update`, `sync`); with tracing off they cost nothing.
With it on, `torch.profiler` (CPU and CUDA activities) records the
window; its events are read in memory (nothing is written to disk) and
reduced to what the per-layer readers take:

  * `kernels`: {device op name: [count, seconds]} inside the window;
  * `busy_s`: the union of the device's kernel, copy and set intervals
    inside the `window` span, and `trace_window_s` that span's length;
  * `rank_s`: device seconds of the kernels launched from inside
    `aten::sort` or `aten::scatter_` (the stable sort and the rank
    inversion);
  * `breakdown`: the ten device ops that took most time, and the ten
    longest idle gaps named by the innermost span open at their middle.
"""

from __future__ import annotations

import bisect
import contextlib

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANK_OPS = ("aten::sort", "aten::scatter_")
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
    block, the reduced trace (`reduce`) or nothing."""
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
    out.update(reduce([_event(e) for e in
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


def _inside(merged: list, starts: list, ts: float) -> bool:
    i = bisect.bisect_right(starts, ts) - 1
    return i >= 0 and ts <= merged[i][1]


def reduce(xs: list) -> dict:
    """Profiler events ({"cat", "name", "ts", "dur" in microseconds,
    "corr": the launch's correlation id}) -> the records described in the
    module doc, in seconds."""
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

    rank_iv = _merge([(e["ts"], e["ts"] + e["dur"]) for e in xs
                      if e.get("cat") == "cpu_op"
                      and e.get("name") in RANK_OPS])
    rank_starts = [lo for lo, _ in rank_iv]
    launch_ts = {e["corr"]: e["ts"] for e in xs
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    rank_us = 0.0
    for e in dev:
        ts = launch_ts.get(e["corr"])
        if ts is not None and _inside(rank_iv, rank_starts, ts):
            rank_us += e["dur"]

    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                   if e.get("cat") == "user_annotation"
                   and e.get("name") != "window")
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((hi - lo, lo, hi) for lo, hi in
                   zip(edges[0::2], edges[1::2]) if hi > lo), reverse=True)
    named = []
    for us, lo, hi in gaps[:10]:
        mid, name = 0.5 * (lo + hi), "window"
        for s0, s1, nm in spans:  # innermost: the last to open
            if s0 > mid:
                break
            if s1 >= mid:
                name = nm
        named.append([name, us / 1e6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "kernels": kernels,
        "busy_s": busy_us / 1e6,
        "trace_window_s": (w1 - w0) / 1e6,
        "rank_s": rank_us / 1e6,
        "breakdown": {
            "device_ops": [[nm[:160], c[1]] for nm, c in top],
            "idle_gaps": named,
        },
    }
