"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the metrics.

Everything a cell needs is found by name from `BENCHMARK.json`:

  * the configuration, `configs[].file`, and its kind,
    `portbench/kinds/<kind>.py` (`"kind"` in the file, `blobs` without
    it): the kind draws the inputs from the seed, sets the program up,
    drives the window and checks the result against the plain reference;
  * the traffic mix, `portbench/traffic/<traffic>.json`, that the kind
    reads;
  * the limits of the check, `portbench/limits/<cell>.json`;
  * one reader per metric, `portbench/metrics/<metric>.py`, whose
    `read(records)` returns the number or None.

`run_cell` keeps what every kind shares: the set-up's clock, an empty
tuning cache, the peak, the profiled window, the checks against the
limits and the metrics. It runs on any device, so the CPU tests drive it
at a tiny size; `portbench/run.py` refuses to run without a card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

import torch

from portbench import trace as tracing
from portbench.traffic import load_mix

PB = Path(__file__).resolve().parent
ROOT = PB.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


# ------------------------------------------------------------ finding by name
def load_spec(root: Path = ROOT) -> dict:
    """`BENCHMARK.json` of the checkout at `root`."""
    return json.loads((root / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str) -> bool:
    """Whether `metric` is reported in `cell`: listed in its `workloads`,
    or in every cell without that key."""
    return cell in metric.get("workloads", [cell])


def resolve(spec: dict, cell: str, root: Path = ROOT) -> dict:
    """The cell's workload entry, configuration, mix, limits and metrics."""
    work = {w["name"]: w for w in spec["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; "
                       f"known: {sorted(work)}")
    wl = work[cell]
    centry = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    return {
        "name": cell,
        "workload": wl,
        "config": json.loads((root / centry["file"]).read_text()),
        "mix": load_mix(wl["traffic"], root / "portbench" / "traffic"),
        "limits": json.loads((root / "portbench" / "limits"
                              / f"{cell}.json").read_text()),
        "end_to_end": [m for m in spec["end_to_end"] if applies(m, cell)],
        "per_layer": [m for m in spec["per_layer"] if applies(m, cell)],
        "root": root,
    }


def _module(path: Path, what: str, name: str):
    """The module at `path`, loaded by file path once and kept in
    `sys.modules` as `portbench_<what>_<name>` until another path takes
    that name."""
    key = f"portbench_{what}_" + re.sub(r"\W", "_", name)
    mod = sys.modules.get(key)
    if mod is not None and mod.__file__ == str(path):
        return mod
    if not path.is_file():
        raise FileNotFoundError(f"no {what} {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules[key] = mod
    return mod


def reader(name: str, root: Path = ROOT):
    """`read` of `portbench/metrics/<name>.py`."""
    return _module(root / "portbench" / "metrics" / f"{name}.py",
                   "metric", name).read


def kind(cfg: dict, root: Path = ROOT):
    """The module of the configuration's kind,
    `portbench/kinds/<cfg["kind"]>.py` (`blobs` without the key)."""
    name = cfg.get("kind", "blobs")
    return _module(root / "portbench" / "kinds" / f"{name}.py", "kind",
                   name)


def banned_modules(names=None) -> list[str]:
    """Of `names` (default: the loaded modules), the top-level names that
    are JAX's, Flax's or the JAX package's (whole names compared:
    `repro_torch` is not `repro`)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


# ------------------------------------------------------------------------ run
def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None,
             control: bool = False) -> dict:
    """Run `cell` (as `resolve` returns it) once; returns the result line
    (the contract's keys, `checks` last) and, under `records`, what the
    metric readers read. `control=True` adds `control`: the same
    comparison of the reference computed in TF32 in the program's place,
    on the same inputs."""
    if t_start is None:
        t_start = time.perf_counter()
    dev = torch.device(device)
    phases = {"imports": time.perf_counter() - t_start}
    cfg, limits, root = cell["config"], cell["limits"], cell.get("root",
                                                                 ROOT)
    cell_kind = kind(cfg, root)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        # "auto" resolves as on a fresh install: an empty tuning cache
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            work, "autotune.json")
        driver = cell_kind.build(cfg, cell["mix"], seed, dev)
        phases.update(driver.phases)
        span = tracing.Spans(trace)
        with tracing.profiled(trace, dev) as traced:
            setup_s = time.perf_counter() - t_start
            rec = driver.window(seconds, span)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        t_check = time.perf_counter()
        numbers, ctl = cell_kind.check(cfg, limits, seed, driver, control)
        kept = driver.records
        del driver
        check_s = time.perf_counter() - t_check
    checks = {name: {"value": numbers[name], "limit": float(lim)}
              for name, lim in limits["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    records = {**rec, **kept, "setup_s": setup_s, "setup_phases": phases,
               "check_s": check_s, "peak_bytes": peak, **traced}
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = reader(m["name"], root)(records)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        device_info["busy_s"] = traced.get("busy_s", 0.0)
        device_info["window_s"] = traced.get("trace_window_s",
                                             rec["window_s"])
    out = {"correct": bool(correct), "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]), "metrics": metrics,
           "device": device_info}
    if trace and traced.get("breakdown"):
        out["breakdown"] = traced["breakdown"]
    out["checks"] = checks
    return {"line": out, "records": records, "numbers": numbers,
            "control": ctl}
