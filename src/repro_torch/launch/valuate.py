"""Data-valuation launcher of the PyTorch port: the paper's pipeline
end-to-end on a CUDA card (or, when asked, the CPU).

  PYTHONPATH=src python -m repro_torch.launch.valuate --n 512 --t 128 --k 5
  PYTHONPATH=src python -m repro_torch.launch.valuate --device cpu --n 64 --t 16
  PYTHONPATH=src python -m repro_torch.launch.valuate --method knn_shapley \
      --fill megakernel
  PYTHONPATH=src python -m repro_torch.launch.valuate --engine sharded \
      --shards 4 --devices cuda     # four shards on one card
  PYTHONPATH=src python -m repro_torch.launch.valuate --device cpu \
      --engine sharded --shards 8 --devices cpu --n 64 --t 16
  PYTHONPATH=src python -m repro_torch.launch.valuate --device cpu \
      --engine distributed --mesh-shape 4,2 --devices cpu --n 64 --t 16
  PYTHONPATH=src python -m repro_torch.launch.valuate --engine approx \
      --method knn_shapley --top-m 64 --recall-target 0.9 --autotune
  PYTHONPATH=src python -m repro_torch.launch.valuate --device cpu \
      --resilient --ckpt-dir /tmp/ck --ckpt-every 2 --n 64 --t 32 \
      --test-batch 8

Pipeline: synthetic circles (10% of train labels flipped) -> a method from
the registry ("sti"/"sii" on the `fused` or `scan` engine, or a per-point
method "knn_shapley"/"wknn"/"loo" on its `streamed` session; any method
on the `sharded` engine) -> efficiency check and mislabel detection.
`--fill megakernel` runs every streaming step as one launch of the fused
kernel (for the point methods through a session). `--engine sharded`
splits the state into `--shards` row blocks over `--devices`, a comma-
separated list with one device per shard (a single name is repeated
`--shards` times); without `--devices` the shards go one per local card,
so a one-card host runs several shards only through `--devices`.
`--engine distributed` (alias `--distributed`, sti/sii) runs the
production cell over a `--mesh-shape D,M` ("data", "model") device grid:
`--devices` names one device per cell, row-major (a single name is
repeated D x M times); without `--devices` the cells go one per local
card (all on the CPU with `--device cpu`), and without `--mesh-shape`
the grid is every local card as (n, 1) (`launch.mesh.make_local_mesh`).
It takes none of the fused pipeline's knobs (`--fill`, `--distance`,
`--test-batch`, `--autotune`).
`--engine approx` runs the LSH top-m engine (`--top-m`, default n/4
clamped to [k+1, n]; `--top-m` >= n is bit for bit the exact engine;
`--recall-target` records whether the measured recall met it) and prints
its certified error bound. `--autotune` tunes what "auto" finds missing
from the tuning cache first. `--resilient` drives a
`ResilientValuationSession` (any method; sharded with --engine sharded):
guarded retries, a checkpoint every `--ckpt-every` batches into
`--ckpt-dir` (a fresh temporary directory by default), NaN rollback; a
directory that already holds a checkpoint of either package RESUMES it,
the replayed batches skipped exactly once. `--save` writes the result in
the format both packages read (npz + JSON).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.methods import ENGINES, get_method
from repro_torch.core.session import (
    ShardedValuationSession, ValuationSession)
from repro_torch.core.sti_baseline import sorted_orders
from repro_torch.data import flip_labels, make_circles


def _shard_options(args) -> dict:
    """--shards / --devices as the sharded engine's keyword options."""
    if args.engine != "sharded":
        return {}
    devices = args.devices.split(",") if args.devices else None
    if devices is not None and len(devices) == 1 and args.shards:
        devices = devices * args.shards
    return {"shards": args.shards if devices is None else None,
            "devices": devices}


def _grid_options(args) -> dict:
    """--mesh-shape / --devices as the distributed engine's `mesh=`."""
    if args.mesh_shape is None and not args.devices:
        return {}
    from repro_torch.distributed.sharding import DeviceGrid
    from repro_torch.launch.mesh import make_local_mesh

    if args.mesh_shape is None:
        shape = make_local_mesh(args.device).shape
    else:
        shape = tuple(int(v) for v in args.mesh_shape.split(","))
        if len(shape) != 2:
            raise SystemExit(f"--mesh-shape takes D,M, got "
                             f"{args.mesh_shape!r}")
    cells = shape[0] * shape[1]
    if args.devices:
        devices = args.devices.split(",")
        if len(devices) == 1:
            devices = devices * cells
    elif args.device == "cpu":
        devices = ["cpu"] * cells
    else:
        import torch

        devices = [torch.device("cuda", i) for i in range(cells)]
    return {"mesh": DeviceGrid(tuple(devices), shape)}


def _approx_options(args) -> dict:
    """--top-m / --recall-target as the approx engine's keyword options."""
    if args.engine != "approx":
        return {}
    opts = {"top_m": args.top_m}
    if args.recall_target is not None:
        opts["recall_target"] = args.recall_target
    return opts


def _tune_option(args) -> dict:
    """--autotune as a keyword option, passed only when set (the eager
    point engine takes no autotune option)."""
    return {"autotune": True} if args.autotune else {}


def _point_values(args, x, y, xt, yt):
    """A point method's result: through the registry, or -- for
    `--fill megakernel`, which the registry's point engines do not take --
    through a session (sharded with --engine sharded), as in the JAX
    launcher."""
    shard_kw = _shard_options(args)
    if args.fill != "megakernel":
        engine = args.engine if args.engine in ENGINES[args.method] else None
        return get_method(args.method)(
            x, y, xt, yt, k=args.k, engine=engine, distance=args.distance,
            test_batch=args.test_batch, device=args.device,
            **_approx_options(args), **_tune_option(args),
            **{nm: v for nm, v in shard_kw.items() if v is not None})
    kw = dict(k=args.k, mode=args.method, test_batch=args.test_batch,
              fill="megakernel", distance=args.distance, device=args.device,
              autotune=args.autotune)
    sess = (ShardedValuationSession(x, y, **shard_kw, **kw) if shard_kw
            else ValuationSession(x, y, **kw))
    return sess.update(xt, yt).finalize()


def _resilient_values(args, x, y, xt, yt):
    """The result of a `ResilientValuationSession` over the test stream in
    batches of --test-batch (one sequence number each), resumed from
    --ckpt-dir when it holds a checkpoint; prints the resilience
    summary."""
    import tempfile

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.resilient import ResilientValuationSession

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
        prefix="repro-torch-valuate-ckpt-")
    shard_kw = {nm: v for nm, v in _shard_options(args).items()
                if v is not None}
    if Checkpointer(ckpt_dir).latest_step() is not None:
        sess = ResilientValuationSession.restore(
            ckpt_dir, x, y, device=args.device, **shard_kw)
        print(f"resuming from {ckpt_dir} at batch {sess.batches_folded}")
    else:
        kw = dict(k=args.k, mode=args.method, test_batch=args.test_batch,
                  fill=args.fill, distance=args.distance,
                  autotune=args.autotune, device=args.device)
        if args.method == "wknn":
            kw["method_opts"] = {"weights": "rbf"}
        sess = ResilientValuationSession(
            x, y, ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
            sharded=args.engine == "sharded", **shard_kw, **kw)
    for start in range(0, int(xt.shape[0]), args.test_batch):
        sess.update(xt[start:start + args.test_batch],
                    yt[start:start + args.test_batch])
    result = sess.finalize()
    res = result.meta["resilience"]
    print(f"resilience: checkpoints={res['checkpoint_steps']} "
          f"retries={res['retries']} rollbacks={res['rollbacks']} "
          f"replayed_skipped={res['replayed_skipped']} "
          f"stragglers={res['health']['stragglers']} (ckpt_dir={ckpt_dir})")
    return result


def main():
    """Parse CLI args, run the requested method/engine, print analytics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--t", type=int, default=128)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--noise-frac", type=float, default=0.1)
    ap.add_argument("--method", default="sti", choices=sorted(ENGINES))
    ap.add_argument("--engine", default="fused",
                    choices=sorted({e for es in ENGINES.values() for e in es}),
                    help="an engine of --method; a point method given an "
                         "interaction engine takes its default")
    ap.add_argument("--fill", default="auto",
                    help="fill registry entry: auto|cuda|chunked|onehot|xla, "
                         "or megakernel (the fused one-launch step)")
    ap.add_argument("--distance", default="auto", help="auto|cuda|plain")
    ap.add_argument("--test-batch", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shards", type=int, default=None,
                    help="shard count for --engine sharded (default: one "
                         "per local card, clamped to a divisor of n)")
    ap.add_argument("--devices", default=None,
                    help="--engine sharded: comma-separated devices, one "
                         "per shard (e.g. cuda,cuda,cuda,cuda); a single "
                         "name is repeated --shards times. --engine "
                         "distributed: one per grid cell, row-major; a "
                         "single name fills the grid")
    ap.add_argument("--mesh-shape", default=None, metavar="D,M",
                    help="--engine distributed: the (data, model) grid "
                         "shape (default: every local card as (n, 1))")
    ap.add_argument("--distributed", action="store_true",
                    help="alias for --engine distributed")
    ap.add_argument("--top-m", type=int, default=None,
                    help="candidate-set size for --engine approx (default "
                         "n/4 clamped to [k+1, n]; >= n runs the exact "
                         "engine bit for bit)")
    ap.add_argument("--recall-target", type=float, default=None,
                    help="--engine approx: record whether the measured "
                         "candidate recall met this target")
    ap.add_argument("--autotune", action="store_true",
                    help="tune what 'auto' finds missing from the tuning "
                         "cache first ($REPRO_TORCH_AUTOTUNE_CACHE)")
    ap.add_argument("--resilient", action="store_true",
                    help="run through the fault-tolerant session (guarded "
                         "retries, periodic atomic checkpoints, NaN "
                         "rollback)")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="checkpoint directory for --resilient (default: a "
                         "fresh temporary directory); a directory holding "
                         "a previous run's checkpoint RESUMES it")
    ap.add_argument("--ckpt-every", type=int, default=4,
                    help="checkpoint cadence in batches for --resilient "
                         "(0 disables checkpointing and rollback)")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="persist the ValuationResult to PATH.npz + PATH.json")
    args = ap.parse_args()
    if args.distributed:
        args.engine = "distributed"

    x, y_clean = make_circles(args.n // 2, noise=0.08, seed=0)
    y, flipped = flip_labels(y_clean, args.noise_frac, 2, seed=1)
    xt, yt = make_circles(args.t // 2, noise=0.08, seed=2)
    n, t = int(x.shape[0]), int(xt.shape[0])
    if args.engine == "approx" and args.top_m is None:
        args.top_m = max(args.k + 1, n // 4)
    if args.engine != "approx" and (args.top_m is not None
                                    or args.recall_target is not None):
        ap.error("--top-m and --recall-target need --engine approx")

    t0 = time.time()
    if args.shards is not None and args.engine != "sharded":
        ap.error("--shards needs --engine sharded")
    if args.devices and args.engine not in ("sharded", "distributed"):
        ap.error("--devices needs --engine sharded or distributed")
    if args.mesh_shape is not None and args.engine != "distributed":
        ap.error("--mesh-shape needs --engine distributed")
    grid = args.engine == "distributed" and args.method in ("sti", "sii")
    if grid and (args.fill != "auto" or args.distance != "auto"
                 or args.test_batch != 256 or args.autotune):
        ap.error("--engine distributed takes none of --fill, --distance, "
                 "--test-batch and --autotune: its cells always run the "
                 "distance and rect fill kernels")
    if args.resilient and args.engine not in ("fused", "sharded",
                                              "streamed"):
        ap.error("--resilient runs the streaming session: --engine fused, "
                 "streamed or sharded")
    if args.resilient:
        result = _resilient_values(args, x, y, xt, yt)
    elif grid:
        result = get_method(args.method)(
            x, y, xt, yt, k=args.k, engine="distributed", device=args.device,
            **_grid_options(args))
    elif args.method in ("sti", "sii"):
        shard_kw = {nm: v for nm, v in _shard_options(args).items()
                    if v is not None}
        result = get_method(args.method)(
            x, y, xt, yt, k=args.k, engine=args.engine, fill=args.fill,
            distance=args.distance, test_batch=args.test_batch,
            device=args.device, **_approx_options(args),
            **_tune_option(args), **shard_kw,
        )
    else:
        result = _point_values(args, x, y, xt, yt)
    dt = time.time() - t0
    meta = result.meta
    shards = (f", shards={meta.get('shards', 1)}"
              if meta["engine"] == "sharded" else "")
    if meta["engine"] == "distributed":
        shards = f", mesh={meta['mesh']}"
    print(f"{args.method} ({meta['engine']}, fill={meta.get('fill')}, "
          f"device={meta['device_kind']}{shards}) n={n} t={t} k={args.k}: "
          f"{dt:.3f}s")
    if meta["engine"] == "approx":
        print(f"approx: top_m={meta['top_m']} exact={meta['approx_exact']} "
              f"recall={meta['recall_estimate']} matched prefix "
              f"{meta['matched_prefix']} certified error bound "
              f"{meta['error_bound']:.3e}"
              + (f" recall target met: {meta['recall_target_met']}"
                 if "recall_target_met" in meta else ""))

    # efficiency axiom (v(N) is the likelihood valuation, paper's v)
    orders = sorted_orders(x.numpy(), xt.numpy())
    kk = min(args.k, n)
    y_np = y.numpy()
    v_n = np.mean([np.sum(y_np[orders[p, :kk]] == int(yt[p])) / args.k
                   for p in range(t)])
    if result.phi is not None:
        print(f"efficiency gap |sum(phi)-v(N)| = "
              f"{float(result.efficiency_gap(v_n)):.2e}")
    elif args.method == "knn_shapley":
        # Shapley efficiency: the values sum to v(N) - v(empty) = v(N)
        gap = abs(float(result.point_values.double().sum()) - v_n)
        print(f"efficiency gap |sum(values)-v(N)| = {gap:.2e}")

    scores = result.mislabel_scores(y, 2).cpu().numpy()
    order = np.argsort(-scores)
    n_flip = int(flipped.sum())
    hits = int(flipped.numpy()[order[:n_flip]].sum())
    print(f"mislabel detection: {hits}/{n_flip} flipped points in "
          f"top-{n_flip} (precision {hits / n_flip:.2f})")

    if args.save:
        p = result.save(args.save)
        print(f"saved {p} (+ .json metadata)")


if __name__ == "__main__":
    main()
