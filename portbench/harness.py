"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the metrics.

Everything a cell needs is found by name from `BENCHMARK.json`:

  * the configuration, `configs[].file` (sizes, method, data);
  * the traffic mix, `portbench/traffic/<traffic>.json`, read by the one
    generator in `portbench/traffic`;
  * the limits of the check, `portbench/limits/<cell>.json`;
  * one reader per metric, `portbench/metrics/<metric>.py`, whose
    `read(records)` returns the number or None.

The window is a closed loop of one client folding `test_batch`-point
batches through `ValuationSession.update`, at most `in_flight` steps
queued on the card.

`run_cell` runs on any device, so the CPU tests drive it at a tiny size;
`portbench/run.py` refuses to run without a card.
"""

from __future__ import annotations

import collections
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

from portbench import trace as tracing
from portbench.reference import REFERENCES
from portbench.traffic import Blobs, load_mix, stream_seed

PB = Path(__file__).resolve().parent
ROOT = PB.parent
BANNED = ("jax", "jaxlib", "flax", "repro")
SAMPLE_STREAM = 3
PROJ_STREAM = 4


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


def reader(name: str, root: Path = ROOT):
    """`read` of `portbench/metrics/<name>.py`."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules(names=None) -> list[str]:
    """Of `names` (default: the loaded modules), the top-level names that
    are JAX's, Flax's or the JAX package's (whole names compared:
    `repro_torch` is not `repro`)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


# -------------------------------------------------------------------- helpers
def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _event(dev: torch.device):
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def sample_rows(n: int, count: int, seed: int) -> torch.Tensor:
    """The sorted train rows of phi the sti check compares, drawn from
    the seed."""
    gen = torch.Generator().manual_seed(stream_seed(seed, SAMPLE_STREAM))
    return torch.sort(torch.randperm(n, generator=gen)[:count]).values


def projection_vecs(n: int, count: int, seed: int) -> torch.Tensor:
    """The (n, count) f64 Gaussian vectors the off-diagonal part of phi
    is multiplied by, drawn from the seed."""
    gen = torch.Generator().manual_seed(stream_seed(seed, PROJ_STREAM))
    return torch.randn((n, count), generator=gen, dtype=torch.float64)


def _phi_readings(phi: torch.Tensor, rows: torch.Tensor,
                  vecs: torch.Tensor) -> dict:
    """Of an (n, n) phi: the sampled rows, every row sum and
    (phi - diag(phi)) @ vecs, f64 on `vecs`' device, 4096 rows at a
    time."""
    dev = vecs.device
    sums, proj = [], []
    for r0 in range(0, phi.shape[0], 4096):
        blk = phi[r0:r0 + 4096].to(dev, torch.float64)
        sums.append(blk.sum(1))
        proj.append(blk @ vecs)
        del blk
    diag = torch.diagonal(phi).to(dev, torch.float64)
    return {"rows": phi[rows.to(phi.device)].to(dev, torch.float64),
            "rowsums": torch.cat(sums),
            "proj": torch.cat(proj) - diag[:, None] * vecs}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| (0 when both vanish)."""
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    return num / den if den > 0 else num


def compare(method: str, got: dict, ref: dict, rows=None) -> dict:
    """The numbers the check compares: sti, the off-diagonal entries of
    the sampled rows, every row sum and the off-diagonal part's
    projections; knn_shapley, the whole vector; each as ||got - ref|| /
    ||ref||."""
    if method == "knn_shapley":
        return {"values": rel_l2(got["values"], ref["values"])}
    off = torch.ones_like(ref["rows"], dtype=torch.bool)
    off[torch.arange(len(rows), device=off.device),
        rows.to(off.device)] = False
    return {"rows": rel_l2(got["rows"][off], ref["rows"][off]),
            "rowsums": rel_l2(got["rowsums"], ref["rowsums"]),
            "proj": rel_l2(got["proj"], ref["proj"])}


# -------------------------------------------------------------------- drivers
class SessionLoop:
    """Closed loop: one client folds `test_batch`-point batches back to
    back through `ValuationSession.update`; before it queues step i it
    waits for step i - `in_flight`, and the window ends on a card sync.
    Set-up folds batch 0, so the window's own call has run every shape
    before the window opens."""

    def __init__(self, cfg: dict, mix: dict, blobs: Blobs, x, y, dev):
        from repro_torch import ValuationSession

        self.blobs, self.dev = blobs, dev
        self.tb = int(mix["test_batch"])
        self.in_flight = max(1, int(mix["in_flight"]))
        t0 = time.perf_counter()
        self.sess = ValuationSession(
            x, y, k=int(cfg["k"]), mode=cfg["method"], test_batch=self.tb,
            fill=cfg["fill"], distance=cfg["distance"], device=dev)
        _sync(dev)
        t1 = time.perf_counter()
        self.sess.update(*blobs.test_batch(0, self.tb))
        self.batches = 1
        _sync(dev)
        self.phases = {"session": t1 - t0, "warm": time.perf_counter() - t1}

    def window(self, seconds: float, span) -> dict:
        waits = collections.deque()
        start = self.batches
        t0 = time.perf_counter()
        with span("window"):
            while time.perf_counter() - t0 < seconds:
                if len(waits) >= self.in_flight:
                    with span("sync"):
                        waits.popleft().synchronize()
                with span("generate"):
                    xb, yb = self.blobs.test_batch(self.batches, self.tb)
                with span("update"):
                    self.sess.update(xb, yb)
                ev = _event(self.dev)
                if ev is not None:
                    waits.append(ev)
                self.batches += 1
            with span("sync"):
                _sync(self.dev)
        window_s = time.perf_counter() - t0
        steps = self.batches - start
        return {"window_s": window_s, "steps": steps,
                "points": steps * self.tb, "attempted": steps, "failed": 0,
                "rows_per_step": self.tb}

    def answer(self, method: str, rows, vecs) -> dict:
        """The program's result, then the program freed."""
        res = self.sess.finalize()
        del self.sess
        gc.collect()
        if method == "knn_shapley":
            got = {"values": res.point_values.to(self.dev, torch.float64)}
        else:
            got = _phi_readings(res.phi, rows, vecs.to(self.dev))
        got["t"] = int(res.meta["t"])
        got["fold_gap"] = abs(got["t"] - self.batches * self.tb)
        del res
        return got

    def inputs(self):
        """The folded test batches again, drawn from the seed."""
        for i in range(self.batches):
            yield self.blobs.test_batch(i, self.tb)


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
    cfg, mix, limits = cell["config"], cell["mix"], cell["limits"]
    method, n = cfg["method"], int(cfg["n"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        # "auto" resolves as on a fresh install: an empty tuning cache
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            work, "autotune.json")
        t0 = time.perf_counter()
        blobs = Blobs(cfg, seed, dev)
        x, y = blobs.train(n)
        _sync(dev)
        phases["data"] = time.perf_counter() - t0
        loop = SessionLoop(cfg, mix, blobs, x, y, dev)
        phases.update(loop.phases)
        del x, y
        span = tracing.Spans(trace)
        with tracing.profiled(trace, dev) as traced:
            setup_s = time.perf_counter() - t_start
            rec = loop.window(seconds, span)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        sti = method != "knn_shapley"
        rows = sample_rows(n, int(limits["sample_rows"]), seed) if sti \
            else None
        vecs = projection_vecs(n, int(limits["projections"]), seed) if sti \
            else None
        t_check = time.perf_counter()
        got = loop.answer(method, rows, vecs)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # the reference draws the train set again: nothing the program
        # holds or made reaches it
        xr, yr = blobs.train(n)
        refs = {"f64": None, "tf32": None} if control else {"f64": None}
        for prec in refs:
            kw = {"rows": rows, "vecs": vecs} if sti else {}
            refs[prec] = REFERENCES[method](xr, yr, int(cfg["k"]),
                                            precision=prec, **kw)
        for xb, yb in loop.inputs():
            for r in refs.values():
                r.add(xb, yb)
        ref = refs["f64"].result()
        numbers = compare(method, got, ref, rows)
        numbers["fold_gap"] = float(got["fold_gap"] + abs(got["t"]
                                                          - ref["t"]))
        ctl = (compare(method, refs["tf32"].result(), ref, rows)
               if control else None)
        del refs, got, ref, xr, yr
        check_s = time.perf_counter() - t_check
    checks = {name: {"value": numbers[name], "limit": float(lim)}
              for name, lim in limits["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    records = dict(rec, setup_s=setup_s, setup_phases=phases,
                   check_s=check_s, peak_bytes=peak, n=n, d=int(cfg["d"]),
                   config=cfg, mix=mix, **traced)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = reader(m["name"], cell.get("root", ROOT))(records)
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
