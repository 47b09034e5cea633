"""Online valuation service launcher of the PyTorch port: a scripted client
workload against `repro_torch.serving.valuation_service.ValuationService`.

  PYTHONPATH=src python -m repro_torch.launch.valuation_serve \\
      --n 64 --t 32 --requests 4 --mutate --check
  PYTHONPATH=src python -m repro_torch.launch.valuation_serve --device cpu \\
      --mutate --chaos --check
  PYTHONPATH=src python -m repro_torch.launch.valuation_serve --device cpu \\
      --devices cpu,cpu,cpu,cpu --chaos --check    # sharded, four shards

Drives the full request surface: coalesced ``value_query`` batches through
admission control, an ``add_points``/``remove_points`` mutation pair
halfway through the stream (incremental refold + rebase), ``get_values``
with the results cache, and the immediate ``health`` probe. ``--chaos``
arms a deterministic `FaultInjector` (device loss past the retry budget,
NaN poisoning, checkpoint corruption) to show that the service answers
every admitted request and reports ``degraded`` instead of failing;
``--check`` recomputes the FINAL train set offline on the fused engine
and prints the drift (the service bound is <= 1e-5). The session runs on
`--device` (default cuda), or sharded over `--devices`, a comma-separated
list with one device per shard.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.data import make_circles
from repro_torch.serving.valuation_service import ValuationService


def main():
    """Parse CLI args, run the scripted service workload, print health."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--t", type=int, default=32)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--method", default="sti")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--devices", default=None,
                    help="host the session sharded over these devices, "
                         "comma-separated, one per shard (e.g. "
                         "cuda,cuda,cuda,cuda); default: one device")
    ap.add_argument("--test-batch", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=None,
                    help="train slot capacity (default: n + 8 free slots)")
    ap.add_argument("--queue-limit", type=int, default=16)
    ap.add_argument("--deadline-s", type=float, default=float("inf"),
                    help="per-request deadline (requests expiring in the "
                         "queue answer with status 'expired')")
    ap.add_argument("--requests", type=int, default=4,
                    help="number of client value_query requests the test "
                         "stream is split into")
    ap.add_argument("--mutate", action="store_true",
                    help="issue an add_points + remove_points pair halfway "
                         "through the query stream")
    ap.add_argument("--chaos", action="store_true",
                    help="arm deterministic faults (device loss, NaN, "
                         "checkpoint corruption) against the stream")
    ap.add_argument("--cache", default="lazy",
                    choices=("lazy", "eager", "off"),
                    help="rank-cache policy for incremental mutations")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="recompute the final train set offline (fused "
                         "engine) and print the value drift")
    args = ap.parse_args()

    x, y = make_circles(args.n // 2, noise=0.08, seed=args.seed)
    xt, yt = make_circles(args.t // 2, noise=0.08, seed=args.seed + 1)
    x, y = x.numpy(), y.numpy()
    xt, yt = xt.numpy(), yt.numpy()
    n, t = len(x), len(xt)
    devices = args.devices.split(",") if args.devices else None

    injector = None
    if args.chaos:
        from repro_torch.distributed.fault_injection import (
            Fault, FaultInjector)

        injector = FaultInjector([
            Fault(kind="device", at_seq=1, times=99),   # past every budget
            Fault(kind="nan", at_seq=2, seed=args.seed),
            Fault(kind="ckpt_corrupt", at_seq=2, seed=args.seed),
        ])

    svc = ValuationService(
        x, y, method=args.method, k=args.k,
        capacity=args.capacity or n + 8, test_batch=args.test_batch,
        devices=devices, device=args.device,
        ckpt_dir=args.ckpt_dir, queue_limit=args.queue_limit,
        default_deadline_s=args.deadline_s, cache_policy=args.cache,
        seed=args.seed, max_retries=1, injector=injector,
    )

    # client-side mirror of the train set, keyed by service id (--check)
    mirror = {i: (x[i], int(y[i])) for i in range(n)}

    t0 = time.time()
    splits = np.array_split(np.arange(t), max(1, args.requests))
    statuses: list[str] = []
    for i, idx in enumerate(splits):
        if args.mutate and i == len(splits) // 2:
            add_x, add_y = xt[:4], yt[:4]
            r = svc.add_points(add_x, add_y)
            statuses.append(r.status)
            if r.ok:
                for j, new_id in enumerate(r.payload["ids"]):
                    mirror[new_id] = (add_x[j], int(add_y[j]))
            r = svc.remove_points([0, 1, 2, 3])
            statuses.append(r.status)
            if r.ok:
                for gone in (0, 1, 2, 3):
                    mirror.pop(gone)
        # two submits per drain exercises query coalescing
        half = len(idx) // 2
        rids = [svc.submit("value_query", x=xt[idx[:half]], y=yt[idx[:half]]),
                svc.submit("value_query", x=xt[idx[half:]], y=yt[idx[half:]])]
        svc.drain()
        statuses.extend(svc.poll(rid).status for rid in rids)
    gv = svc.get_values()
    statuses.append(gv.status)
    dt = time.time() - t0

    h = svc.health()
    unanswered = sum(s not in ("ok", "shed", "expired", "rejected")
                     for s in statuses)
    print(f"{args.method} service n={n} t={t} k={args.k} "
          f"device={svc.device} shards={h['shards']}: {len(statuses)} "
          f"requests in {dt:.3f}s (p50 {h['latency_p50_s'] * 1e3:.1f}ms / "
          f"p99 {h['latency_p99_s'] * 1e3:.1f}ms)")
    print(f"health: {h['status']} | version {h['version']} | "
          f"n_live {h['n_live']}/{h['capacity']} | t_seen {h['t_seen']} | "
          f"admission {h['admission']} | "
          f"recoveries {h['requests']['full_recoveries']} | "
          f"degradations {len(h['resilience']['degradations'])}")
    if unanswered:
        raise SystemExit(f"{unanswered} requests left unanswered")

    if args.check and gv.ok:
        from repro_torch.core.methods import get_method

        ids = gv.payload["ids"]
        xf = np.stack([mirror[i][0] for i in ids])
        yf = np.asarray([mirror[i][1] for i in ids])
        offline = get_method(args.method)(xf, yf, xt, yt, k=args.k,
                                          device=svc.device)
        drift = float(np.max(np.abs(
            offline.values().cpu().numpy() - gv.payload["values"])))
        print(f"offline fused drift: {drift:.2e} "
              f"({'OK' if drift <= 1e-5 else 'TOO LARGE'})")
        if drift > 1e-5:
            raise SystemExit("drift above the 1e-5 service bound")
    svc.close()


if __name__ == "__main__":
    main()
