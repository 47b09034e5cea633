"""Dry run of the production grid: counterpart of `repro.launch.dryrun`.

The reference lowers and compiles every (arch x input shape x mesh) cell
on 512 placeholder host devices and reads XLA's memory and cost
analysis. The port runs each cell's step once on the meta device, over a
grid of placeholder cells (`make_production_mesh()`: every cell
`torch.device("meta")`), and counts what the step does:

  * FLOPs: `torch.utils.flop_counter.FlopCounterMode` (matmuls,
    convolutions, attention) plus the hand-written kernels' operations,
    which their wrappers add on meta tensors inside
    `hlo_analysis.KERNELS.counting()`;
  * bytes: every dispatched op's input and output bytes (views and
    uninitialized allocations excluded), XLA's "bytes accessed", plus
    the kernels' own;
  * collective bytes: what the grid code moves between cells
    (`distributed.sharding.COLLECTIVES`), for the fullest cell;
  * memory: `argument_bytes` / `output_bytes` the bytes the fullest cell
    holds of the placed inputs / of the outputs, `alias_bytes` what the
    step updates in place (the inputs that come back as outputs: params
    and both moments in training, the KV caches in decode), `temp_bytes`
    the peak of live intermediates over the whole run (storages the run
    allocates, freed when their last tensor dies) divided by the cells
    that share the compute.

Per device is the fullest cell's share: an LM step computes each data
row whole on the row's cell (`distributed/grid_step.py`), so the counts
are divided by the rows the batch runs on (`cells_busy`); every cell of
the sti cell does the same work. `compile_s` is the seconds of building,
placing and running the cell on meta.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch sti-knn-paper \\
      --shape valuation_step
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.contracts import _tensors
from repro_torch.configs.base import tree_leaves
from repro_torch.configs.registry import ARCHS, PAPER_WORKLOAD, get_config
from repro_torch.configs.shapes import SHAPES, shapes_for
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.grid_step import n_rows
from repro_torch.launch import specs as SPEC
from repro_torch.launch.hlo_analysis import (
    KERNELS, collective_bytes, model_flops, roofline, sti_model_flops)
from repro_torch.launch.mesh import make_production_mesh

__all__ = ["run_cell", "all_cells", "main", "cell_memory"]

# ops that move no data: an uninitialized allocation
_NO_ACCESS = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Accesses(TorchDispatchMode):
    """Sums each op's input and output bytes, and tracks the live bytes
    of the storages the run allocates (their peak)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: set = set()

    def _freed(self, key: int, nbytes: int) -> None:
        self._seen.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_ACCESS:
            pass
        else:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._seen:
                self._seen.add(key)
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._freed, key, st.nbytes())
        return out


# --------------------------------------------------------------- memory
def _cell_bytes(tree, cells) -> dict:
    """{cell: bytes it holds of `tree`}: a `Sharded` leaf's range on each
    cell, a whole tensor on cell (0, 0) (where the step leaves an
    unconstrained output)."""
    from repro_torch.distributed.grid_step import _held

    out = dict.fromkeys(cells, 0)
    for x in tree_leaves(tree, is_leaf=lambda v: isinstance(v, SH.Sharded)):
        if isinstance(x, SH.Sharded):
            elt = x.dtype.itemsize
            for c in cells:
                out[c] += _held(x.placement, x.shape, c) * elt
        elif isinstance(x, torch.Tensor):
            out[cells[0]] += _nbytes(x)
    return out


def cell_memory(grid, args, outs) -> tuple[tuple, dict]:
    """(the fullest cell, {argument_bytes, output_bytes, alias_bytes}) of
    one step: the cell holding the most bytes of the placed `args`, the
    bytes it holds of `args` and of `outs`, and of the `Sharded` inputs
    that come back as outputs (updated in place)."""
    cells = [(i, j) for i in range(grid.shape[0])
             for j in range(grid.shape[1])]
    arg = _cell_bytes(args, cells)
    cell = max(cells, key=lambda c: arg[c])
    is_sharded = lambda v: isinstance(v, SH.Sharded)  # noqa: E731
    returned = {id(x) for x in tree_leaves(outs, is_leaf=is_sharded)}
    aliased = [x for x in tree_leaves(args, is_leaf=is_sharded)
               if isinstance(x, SH.Sharded) and id(x) in returned]
    return cell, {
        "argument_bytes": arg[cell],
        "output_bytes": _cell_bytes(outs, cells)[cell],
        "alias_bytes": _cell_bytes(aliased, cells)[cell],
    }


# ---------------------------------------------------------------- cells
def _lm_cell(cfg, shape, grid, strategy, grad_accum):
    """(step, placed args, cells_busy, held) of one LM cell on `grid`;
    `held(args, outs)` is what the cells hold of the inputs and outputs:
    the placed trees themselves."""
    step, args, in_specs, _ = SPEC.lm_cell(cfg, shape, grid,
                                           strategy=strategy,
                                           grad_accum=grad_accum)
    placed = SH.place_tree(grid, in_specs, args)
    if shape.kind == "decode":
        # decode reads int(index): a meta tensor has no value, so the dry
        # run passes a concrete one, the last cache slot
        placed[-1]["index"] = torch.tensor(shape.seq_len - 1)
    return step, placed, n_rows(grid, shape.global_batch), \
        lambda args, outs: (args, outs)


def _sti_cell(scfg, grid):
    """(step, meta args, cells_busy, held) of the paper's valuation cell.
    The step takes whole tensors and lays them out itself; `held` lays
    the inputs and outputs over the grid by the cell's specs (the
    reference's), which is what each cell holds."""
    step, args, in_specs, out_specs = SPEC.sti_cell(scfg, grid)
    meta = [torch.empty(s, dtype=dt, device="meta") for s, dt in args]
    n = int(scfg.n_train)

    def held(args_, outs):
        outs = (torch.empty((n, n), device="meta"),
                torch.empty((n,), device="meta"))
        return (SH.place_tree(grid, in_specs, meta),
                SH.place_tree(grid, out_specs, outs))

    return step, meta[:4], grid.shape[0] * grid.shape[1], held


def _mesh_name(grid) -> str:
    return "x".join(str(v) for v in grid.axis_sizes.values())


def run_cell(arch: str, shape_name, multi_pod: bool = False,
             strategy: str | None = None, out_dir: str | None = None,
             verbose: bool = True, grad_accum: int = 1,
             remat: str | None = None, tag: str = "",
             cfg_overrides: dict | None = None, grid=None) -> dict:
    """Run one cell's step on meta and record its memory, collectives and
    roofline under the reference's keys. `shape_name` names a shape of
    `configs.shapes` (or is a `ShapeSpec`); `grid` replaces the
    production grid (a smaller meta grid, say); `cfg_overrides` (e.g.
    {"num_layers": 2}) cut the config as the reference's do."""
    grid = grid if grid is not None else make_production_mesh(
        multi_pod=multi_pod)
    n_chips = grid.shape[0] * grid.shape[1]
    t0 = time.time()
    SH.COLLECTIVES.reset()
    if arch == PAPER_WORKLOAD.name:
        scfg = PAPER_WORKLOAD
        if cfg_overrides:
            scfg = scfg.__class__(**{**scfg.__dict__, **cfg_overrides})
        mflops = sti_model_flops(scfg)
        step, args, busy, held = _sti_cell(scfg, grid)
    else:
        cfg = get_config(arch)
        if remat:
            cfg = cfg.replace(remat=remat)
        if cfg_overrides:
            cfg = cfg.replace(**cfg_overrides)
        shape = SHAPES[shape_name] if isinstance(shape_name, str) \
            else shape_name
        shape_name = shape.name
        mflops = model_flops(cfg, shape)
        step, args, busy, held = _lm_cell(cfg, shape, grid, strategy,
                                          grad_accum)
    acc = _Accesses()
    with KERNELS.counting(), acc, FlopCounterMode(display=False) as fc:
        outs = step(*args)
    t_run = time.time() - t0
    flops = (fc.get_total_flops() + KERNELS.ops) / busy
    nbytes = (acc.bytes + KERNELS.bytes) / busy
    coll = collective_bytes()
    cell, mem = cell_memory(grid, *held(args, outs))
    mem["temp_bytes"] = acc.peak // busy
    terms = roofline(flops, nbytes, coll["total"], n_chips, mflops,
                     peak_memory=float(mem["temp_bytes"]
                                       + mem["argument_bytes"]
                                       + mem["output_bytes"]
                                       - mem["alias_bytes"]))
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": _mesh_name(grid),
        "chips": n_chips,
        "strategy": strategy or "auto",
        "grad_accum": grad_accum,
        "remat": remat or "default",
        "tag": tag,
        "compile_s": round(t_run, 1),
        "cells_busy": busy,
        "fullest_cell": list(cell),
        "memory_analysis": {k: mem[k] for k in (
            "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes")},
        "collectives": coll,
        "kernel_calls": dict(KERNELS.calls),
        "roofline": terms.asdict(),
    }
    if verbose:
        print(f"== {arch} x {shape_name} x {rec['mesh']} "
              f"(meta run {t_run:.1f}s)")
        print(f"  memory_analysis: {rec['memory_analysis']}")
        print(f"  per device: flops={flops:.3e} bytes={nbytes:.3e} "
              f"(kernels {rec['kernel_calls']})")
        print(f"  collectives: {coll}")
        r = rec["roofline"]
        print(f"  roofline: compute={r['t_compute']:.4f}s "
              f"memory={r['t_memory']:.4f}s "
              f"collective={r['t_collective']:.4f}s -> {r['bottleneck']} | "
              f"useful={r['useful_ratio']:.3f}")
    if out_dir:
        p = Path(out_dir)
        p.mkdir(parents=True, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn = p / (f"{arch}__{shape_name}__"
                  f"{rec['mesh'].replace('x', '-')}{suffix}.json")
        fn.write_text(json.dumps(rec, indent=2))
    return rec


def all_cells():
    """Every (arch, shape) of the grid, then the paper's valuation step."""
    for arch in ARCHS:
        for shape in shapes_for(arch):
            yield arch, shape.name
    yield PAPER_WORKLOAD.name, "valuation_step"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--strategy", default=None,
                    choices=[None, "fsdp", "tp_dp"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--keep-going", action="store_true")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient accumulation for train cells")
    ap.add_argument("--remat", default=None,
                    choices=[None, "block", "dots", "none"])
    ap.add_argument("--tag", default="",
                    help="suffix for output JSONs (perf-iteration variants)")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                run_cell(arch, shape, mp, strategy=args.strategy,
                         out_dir=args.out, grad_accum=args.accum,
                         remat=args.remat, tag=args.tag)
            except Exception as e:
                failures.append((arch, shape, mp, repr(e)))
                print(f"FAILED {arch} x {shape} multi_pod={mp}: {e}")
                if not args.keep_going:
                    traceback.print_exc()
                    raise SystemExit(1)
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL CELLS PASSED")


if __name__ == "__main__":
    main()
