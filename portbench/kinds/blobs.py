"""The blob kind: Gaussian blobs of features folded through
`ValuationSession.update` and checked against the plain reference.

Inputs. Features are Gaussian blobs drawn on the device by a
`torch.Generator`: one centre a class, a share `label_noise` of the
train labels moved to another class, as the port's own card checks draw
them. The train set and each test batch draw from their own stream
(`traffic.generator`), so test batch i is the same whichever order the
batches are drawn in, and the check draws it again. Every seed draws the
same sizes, so seeds differ in the points' values only.

Driver. `SessionLoop`: one client folds `test_batch`-point batches
(the mix's) through `ValuationSession.update`, at most `in_flight` steps
queued on the card.

Check. The program's result (knn_shapley: the (n,) values; sti: sampled
rows of phi, every row sum and projections of its off-diagonal part)
against the configuration's method in `portbench/reference`, computed
from the train set and test batches drawn again from the seed, as
||got - ref|| / ||ref|| (`compare`); `fold_gap`, the test points the
program folded less those the window folded and the reference folded,
is exact.

A configuration without a `"kind"` key is of this kind.
"""

from __future__ import annotations

import collections
import gc
import statistics
import time

import torch

from portbench.reference import KnnShapleyReference, StiReference
from portbench.traffic import generator, stream_seed

TRAIN_STREAM = 1
TEST_STREAM0 = 1 << 20    # test batch i draws from stream TEST_STREAM0 + i
SAMPLE_STREAM = 3
PROJ_STREAM = 4
REFERENCES = {"sti": StiReference, "knn_shapley": KnnShapleyReference}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _event(dev: torch.device):
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


class Blobs:
    """The cell's feature distribution: `classes` centres of scale
    `center_scale` in `d` dimensions, points at `cluster_std` around
    them, drawn on `device` from `seed`."""

    def __init__(self, cfg: dict, seed: int, device):
        self.d = int(cfg["d"])
        self.classes = int(cfg["classes"])
        self.std = float(cfg["cluster_std"])
        self.label_noise = float(cfg["label_noise"])
        self.seed = int(seed)
        self.device = torch.device(device)
        gen = generator(seed, 0, self.device)
        self.centers = float(cfg["center_scale"]) * torch.randn(
            (self.classes, self.d), generator=gen, device=self.device)

    def _points(self, rows: int, gen: torch.Generator):
        y = torch.randint(0, self.classes, (rows,), generator=gen,
                          device=self.device, dtype=torch.int32)
        x = torch.randn((rows, self.d), generator=gen, device=self.device)
        x.mul_(self.std)
        for r0 in range(0, rows, 1 << 18):  # no (rows, d) temporary
            x[r0:r0 + (1 << 18)].add_(self.centers[y[r0:r0 + (1 << 18)]
                                                   .long()])
        return x, y

    def train(self, n: int):
        """(n, d) f32 train features and (n,) int32 labels, a share
        `label_noise` of them moved to another class."""
        gen = generator(self.seed, TRAIN_STREAM, self.device)
        x, y = self._points(n, gen)
        if self.label_noise > 0.0 and self.classes > 1:
            flip = torch.rand((n,), generator=gen,
                              device=self.device) < self.label_noise
            shift = torch.randint(1, self.classes, (n,), generator=gen,
                                  device=self.device, dtype=torch.int32)
            y = torch.where(flip, (y + shift) % self.classes, y)
        return x, y

    def test_batch(self, i: int, rows: int):
        """Test batch `i` of `rows` points (clean labels)."""
        return self._points(rows, generator(self.seed, TEST_STREAM0 + i,
                                            self.device))


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
    """The numbers the check compares, each ||got - ref|| / ||ref||:
    sti, every row sum, the off-diagonal part's projections and, of the
    sampled rows, the median row's off-diagonal entries (`rows_median`;
    over all the sampled rows together, one distance near a tie at a top
    rank can make one row's gap the whole number); knn_shapley, the
    whole vector."""
    if method == "knn_shapley":
        return {"values": rel_l2(got["values"], ref["values"])}
    off = torch.ones_like(ref["rows"], dtype=torch.bool)
    off[torch.arange(len(rows), device=off.device),
        rows.to(off.device)] = False
    per_row = [rel_l2(g[o], r[o])
               for g, r, o in zip(got["rows"], ref["rows"], off)]
    return {"rows_median": statistics.median(per_row),
            "rowsums": rel_l2(got["rowsums"], ref["rowsums"]),
            "proj": rel_l2(got["proj"], ref["proj"])}


class SessionLoop:
    """Closed loop: one client folds `test_batch`-point batches back to
    back through `ValuationSession.update`; before it queues step i it
    waits for step i - `in_flight`, and the window ends on a card sync.
    Set-up folds batch 0, so the window's own call has run every shape
    before the window opens."""

    def __init__(self, cfg: dict, mix: dict, blobs: Blobs, x, y, dev):
        from repro_torch import ValuationSession

        self.blobs, self.dev = blobs, dev
        self.records = {"n": int(cfg["n"]), "d": int(cfg["d"]),
                        "config": cfg, "mix": mix}
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


# ------------------------------------------------------------- kind contract
def build(cfg: dict, mix: dict, seed: int, dev: torch.device) -> SessionLoop:
    """The train set drawn on `dev` from the seed, the session set up and
    batch 0 folded; the driver's `phases` are set-up seconds by phase."""
    t0 = time.perf_counter()
    blobs = Blobs(cfg, seed, dev)
    x, y = blobs.train(int(cfg["n"]))
    _sync(dev)
    data_s = time.perf_counter() - t0
    loop = SessionLoop(cfg, mix, blobs, x, y, dev)
    loop.phases = {"data": data_s, **loop.phases}
    return loop


def check(cfg: dict, limits: dict, seed: int, driver: SessionLoop,
          control: bool = False) -> tuple:
    """(numbers, control numbers or None): the program's result, then the
    program freed, then the reference from the train set and the folded
    batches drawn again; `control` adds the reference computed in TF32 in
    the program's place, by the same comparison."""
    method, n = cfg["method"], int(cfg["n"])
    sti = method != "knn_shapley"
    rows = sample_rows(n, int(limits["sample_rows"]), seed) if sti \
        else None
    vecs = projection_vecs(n, int(limits["projections"]), seed) if sti \
        else None
    got = driver.answer(method, rows, vecs)
    if driver.dev.type == "cuda":
        torch.cuda.empty_cache()
    # the reference draws the train set again: nothing the program
    # holds or made reaches it
    xr, yr = driver.blobs.train(n)
    refs = {"f64": None, "tf32": None} if control else {"f64": None}
    for prec in refs:
        kw = {"rows": rows, "vecs": vecs} if sti else {}
        refs[prec] = REFERENCES[method](xr, yr, int(cfg["k"]),
                                        precision=prec, **kw)
    for xb, yb in driver.inputs():
        for r in refs.values():
            r.add(xb, yb)
    ref = refs["f64"].result()
    numbers = compare(method, got, ref, rows)
    numbers["fold_gap"] = float(got["fold_gap"] + abs(got["t"] - ref["t"]))
    ctl = (compare(method, refs["tf32"].result(), ref, rows)
           if control else None)
    return numbers, ctl
