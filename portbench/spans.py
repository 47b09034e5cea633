"""The program's spans in a traced window: where the card's time, its idle
gaps and the host's waits go, span by span.

    python3 portbench/spans.py --workload knn-shapley-imagenet.batch256 \
        --seed 7 --seconds 10

Sets the cell up as `run.py` does, runs its window once under the
profiler with the benchmark's spans on (as `--trace 1` does), and prints
one JSON line: every span's milliseconds a step. It runs no check. It
needs a card (exit 2 without one).

`reduce(xs)` takes the profiler's events as `trace._event` gives them;
`trace.read` puts its spans in every traced run's records, and the span
metrics' readers take them through `reading`.
The program opens its spans (`repro_torch.tracing.SPANS`) as
function-scope ranges, which `trace._event` files as host ops, so
`reduce` reads them by name. For each span open in the window, the
benchmark's (`trace.SPANS`, `window` among them) and the program's, it
returns:

  * `count` instances; `host_s`, their summed durations; `self_s`,
    `host_s` less the parts their child spans cover;
  * `device_s`: device seconds of the window's kernels, copies and sets
    whose launch (the runtime call with the same correlation id) falls
    inside the span as the innermost span open then; `ops` splits it by
    device op;
  * `idle_s`: the window's idle seconds (no kernel, copy or set on the
    card) whose gap has its midpoint inside the span as the innermost
    span open there;
  * `blocking`: {runtime call: [count, seconds]} of the host runtime
    calls inside the span, as the innermost span, that wait on the card
    or the allocator: cudaDeviceSynchronize, cudaStreamSynchronize,
    cudaEventSynchronize, cudaMemcpy, cudaMalloc, cudaFree,
    cudaHostAlloc and cudaMallocHost (`BLOCKING`).

Beside them: `unattributed`, [count, seconds] of the window's device ops
launched in no span, and `idle_gaps`, the ten longest gaps named by the
innermost span open at their midpoint, the program's spans included.
`per_step` turns the spans into milliseconds a step and shares of the
window, the numbers of the span metrics (`PERF.md` names what each is
for).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BLOCKING = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
            "cudaEventSynchronize", "cudaMemcpy", "cudaMalloc", "cudaFree",
            "cudaHostAlloc", "cudaMallocHost")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime")


class _Nest:
    """Spans of one thread, sorted by start (longer first on a tie), as
    nested intervals: the innermost open at a time, and the time each
    span's direct children cover."""

    def __init__(self, spans: list):
        self.times: list = []
        self.owners: list = []
        self.child_us = [0.0] * len(spans)
        ends: list = []
        stack: list = []

        def close(t: float) -> None:
            while stack and ends[-1] <= t:
                self.times.append(ends.pop())
                stack.pop()
                self.owners.append(stack[-1] if stack else None)

        for i, (s0, s1, _) in enumerate(spans):
            close(s0)
            if stack:
                s1 = min(s1, ends[-1])  # a child ends with its parent
                self.child_us[stack[-1]] += s1 - s0
            stack.append(i)
            ends.append(s1)
            self.times.append(s0)
            self.owners.append(i)
        close(float("inf"))

    def owner(self, ts):
        """Index of the innermost span open at `ts`, or None."""
        if ts is None:
            return None
        k = bisect.bisect_right(self.times, ts) - 1
        return self.owners[k] if k >= 0 else None


def reduce(xs: list) -> dict:
    """Profiler events ({"cat", "name", "ts", "dur" in microseconds,
    "corr"}, as `trace._event` gives them) -> {"spans", "unattributed",
    "idle_gaps"} as the module doc describes, in seconds; {} without a
    `window` span."""
    from portbench import trace
    from repro_torch.tracing import SPANS

    program = set(SPANS)
    names = set(trace.SPANS) | program
    win = [e for e in xs if e["cat"] == "user_annotation"
           and e["name"] == "window"]
    if not win:
        return {}
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    # a program span is a host range whatever the profiler filed it as;
    # a device event of its name is a mirror of one, never device work
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                    if e["name"] in names and e["cat"] in HOST_CATS),
                   key=lambda s: (s[0], -s[1]))
    nest = _Nest(spans)
    out = {nm: {"count": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0,
                "idle_s": 0.0, "blocking": {}, "ops": {}}
           for nm in sorted({s[2] for s in spans})}
    for (s0, s1, nm), child in zip(spans, nest.child_us):
        r = out[nm]
        r["count"] += 1
        r["host_s"] += (s1 - s0) / 1e6
        r["self_s"] += (s1 - s0 - child) / 1e6

    dev = [e for e in xs if e["cat"] in trace.DEVICE_CATS
           and e["name"] not in program and w0 <= e["ts"] <= w1]
    launch_ts = {e["corr"]: e["ts"] for e in xs
                 if e["cat"] == "cuda_runtime"}
    unattributed = [0, 0.0]
    for e in dev:
        i = nest.owner(launch_ts.get(e["corr"]))
        if i is None:
            unattributed[0] += 1
            unattributed[1] += e["dur"] / 1e6
            continue
        r = out[spans[i][2]]
        r["device_s"] += e["dur"] / 1e6
        op = r["ops"].setdefault(e["name"][:160], [0, 0.0])
        op[0] += 1
        op[1] += e["dur"] / 1e6

    busy = trace._merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                         for e in dev])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = []
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi > lo:
            i = nest.owner(0.5 * (lo + hi))
            nm = spans[i][2] if i is not None else "window"
            out[nm]["idle_s"] += (hi - lo) / 1e6
            gaps.append((hi - lo, nm))

    for e in xs:
        if e["cat"] == "cuda_runtime" and e["name"] in BLOCKING:
            i = nest.owner(e["ts"])
            if i is not None:
                b = out[spans[i][2]]["blocking"].setdefault(e["name"],
                                                            [0, 0.0])
                b[0] += 1
                b[1] += e["dur"] / 1e6
    gaps.sort(key=lambda g: -g[0])
    return {"spans": out, "unattributed": unattributed,
            "idle_gaps": [[nm, us / 1e6] for us, nm in gaps[:10]]}


def per_step(spans: dict, steps: int, window_s: float) -> dict:
    """The spans of `reduce` in milliseconds a step and % of the traced
    window `window_s`, each None where none of its spans ran:

      * `session.enqueue_ms`: host time of `session.update`;
      * `session.blocking_ms`: the blocking runtime calls' time inside
        the program's spans;
      * `device.idle.program`: % of the window idle under the program's
        spans;
      * `rank.ms`: device time of `step.rank`;
      * `contrib.ms`: device time of `step.contrib` and `step.g`;
      * `point_update.ms`: device time of `step.update`.
    """
    from repro_torch.tracing import SPANS

    def ms(names: tuple, key: str):
        got = [spans[nm][key] for nm in names if nm in spans]
        return 1e3 * sum(got) / steps if got else None

    mine = [spans[nm] for nm in SPANS if nm in spans]
    return {
        "session.enqueue_ms": ms(("session.update",), "host_s"),
        "session.blocking_ms":
            (1e3 * sum(c[1] for r in mine for c in r["blocking"].values())
             / steps if mine else None),
        "device.idle.program":
            (100.0 * sum(r["idle_s"] for r in mine) / window_s
             if mine else None),
        "rank.ms": ms(("step.rank",), "device_s"),
        "contrib.ms": ms(("step.contrib", "step.g"), "device_s"),
        "point_update.ms": ms(("step.update",), "device_s"),
    }


def reading(records: dict, name: str):
    """`per_step`'s `name` from a traced run's records, or None."""
    if not records.get("spans") or not records.get("steps") \
            or not records.get("trace_window_s"):
        return None
    return per_step(records["spans"], records["steps"],
                    records["trace_window_s"])[name]


def traced_window(cell: dict, seed: int, seconds: float,
                  device="cuda") -> tuple:
    """Set `cell` (as `harness.resolve` returns it) up as
    `harness.run_cell` does, through its configuration's kind, and run
    its window once under the profiler with the benchmark's spans on.
    Returns the window's record and the profiler's events as
    `trace._event` gives them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness, trace

    dev = torch.device(device)
    cfg = cell["config"]
    cell_kind = harness.kind(cfg, cell.get("root", harness.ROOT))
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    cache = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    try:
        with tempfile.TemporaryDirectory(prefix="portbench-") as work:
            # "auto" resolves as on a fresh install: an empty tuning cache
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
                work, "autotune.json")
            driver = cell_kind.build(cfg, cell["mix"], seed, dev)
            with profile(activities=acts) as prof:
                rec = driver.window(seconds, trace.Spans(True))
            events = [trace._event(e)
                      for e in prof.profiler.kineto_results.events()]
            del driver, prof
    finally:
        if cache is None:
            os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache
    return rec, events


def summary(rec: dict, events: list) -> dict:
    """What `main` prints of one traced window: the benchmark's own
    reduction (`trace.reduce`) and whether the program's span events leave
    it unchanged, and the spans, each in ms a step."""
    from portbench import trace
    from repro_torch.tracing import SPANS

    base = trace.reduce(events)
    without = trace.reduce([e for e in events if e["name"] not in SPANS])
    sp = reduce(events)
    steps = rec["steps"]
    ms = {nm: {"count": r["count"],
               **{k[:-1] + "ms": 1e3 * r[k] / steps for k in
                  ("host_s", "self_s", "device_s", "idle_s")},
               "blocking": {c: [n, 1e3 * s / steps]
                            for c, (n, s) in r["blocking"].items()},
               "ops": dict(sorted(((op, [n, 1e3 * s / steps])
                                   for op, (n, s) in r["ops"].items()),
                                  key=lambda kv: -kv[1][1])[:8])}
          for nm, r in sp["spans"].items()}
    return {
        "steps": steps, "window_s": rec["window_s"],
        "trace_window_s": base["trace_window_s"],
        "busy_s": base["busy_s"],
        "idle_pct": 100.0 * (1.0 - base["busy_s"] / base["trace_window_s"]),
        "accepted_unchanged": base == without,
        "per_step": per_step(sp["spans"], steps, base["trace_window_s"]),
        "unattributed": sp["unattributed"],
        "idle_gaps": sp["idle_gaps"],
        "spans_ms_per_step": ms,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        q for q in sys.path if Path(q or ".").resolve() != ROOT / "portbench"]

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: spans need a CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(harness.load_spec(ROOT), args.workload, ROOT)
    rec, events = traced_window(cell, args.seed, args.seconds)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(0),
                      "setup_and_window_s": time.perf_counter() - T_START,
                      **summary(rec, events)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
