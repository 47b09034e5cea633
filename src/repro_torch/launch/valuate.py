"""Data-valuation launcher of the PyTorch port: the paper's pipeline
end-to-end on a CUDA card (or, when asked, the CPU).

  PYTHONPATH=src python -m repro_torch.launch.valuate --n 512 --t 128 --k 5
  PYTHONPATH=src python -m repro_torch.launch.valuate --device cpu --n 64 --t 16

Pipeline: synthetic circles (10% of train labels flipped) -> "sti" or
"sii" from the registry on the `fused` or `scan` engine -> efficiency
check and mislabel detection. `--save` writes the result in the format
both packages read (npz + JSON).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.methods import ENGINES, get_method
from repro_torch.core.sti_baseline import sorted_orders
from repro_torch.data import flip_labels, make_circles


def main():
    """Parse CLI args, run the requested method/engine, print analytics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--t", type=int, default=128)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--noise-frac", type=float, default=0.1)
    ap.add_argument("--method", default="sti", choices=sorted(ENGINES))
    ap.add_argument("--engine", default="fused", choices=("fused", "scan"))
    ap.add_argument("--fill", default="auto",
                    help="fill registry entry: auto|cuda|chunked|onehot|xla")
    ap.add_argument("--distance", default="auto", help="auto|cuda|plain")
    ap.add_argument("--test-batch", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="persist the ValuationResult to PATH.npz + PATH.json")
    args = ap.parse_args()

    x, y_clean = make_circles(args.n // 2, noise=0.08, seed=0)
    y, flipped = flip_labels(y_clean, args.noise_frac, 2, seed=1)
    xt, yt = make_circles(args.t // 2, noise=0.08, seed=2)
    n, t = int(x.shape[0]), int(xt.shape[0])

    t0 = time.time()
    result = get_method(args.method)(
        x, y, xt, yt, k=args.k, engine=args.engine, fill=args.fill,
        distance=args.distance, test_batch=args.test_batch,
        device=args.device,
    )
    dt = time.time() - t0
    meta = result.meta
    print(f"{args.method} ({meta['engine']}, fill={meta['fill']}, "
          f"device={meta['device_kind']}) n={n} t={t} k={args.k}: {dt:.3f}s")

    # efficiency axiom (v(N) is the likelihood valuation, paper's v)
    orders = sorted_orders(x.numpy(), xt.numpy())
    kk = min(args.k, n)
    y_np = y.numpy()
    v_n = np.mean([np.sum(y_np[orders[p, :kk]] == int(yt[p])) / args.k
                   for p in range(t)])
    print(f"efficiency gap |sum(phi)-v(N)| = "
          f"{float(result.efficiency_gap(v_n)):.2e}")

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
