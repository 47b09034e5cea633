"""Distributed STI-KNN in the PyTorch port: the production cell on a
device grid.

    PYTHONPATH=src python examples/distributed_valuation_torch.py
    PYTHONPATH=src python examples/distributed_valuation_torch.py \
        --devices cuda:0,cuda:1,cuda:2,cuda:3,cuda:4,cuda:5,cuda:6,cuda:7
    PYTHONPATH=src python examples/distributed_valuation_torch.py \
        --device cpu --n 64 --t 16

The port's counterpart of `examples/distributed_valuation.py`. The grid
is a `DeviceGrid` built from `--devices`, where the JAX example takes
`jax.make_mesh` over its devices: with several names, (D / 2, 2) when D is
even, else (D, 1); a single name fills a (2, 2) grid of that one device
(the default: `--device`, so one card runs four cells). Test points shard
over "data", the phi matrix over "model" column blocks; one sum over the
data shards combines the partial sums (`launch/specs.py::sti_cell`: one
distance and one rect fill launch a cell). The result is verified against
the single-host algorithm, as is the streaming form, a
`ShardedValuationSession` with one row block a grid device.
"""

import argparse

import torch

from repro_torch.configs.sti_knn_paper import STIConfig
from repro_torch.core import sti_knn_interactions
from repro_torch.data import make_moons
from repro_torch.distributed.sharding import DeviceGrid
from repro_torch.launch.specs import sti_cell

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
ap.add_argument("--devices", default=None,
                help="comma-separated grid devices, row-major; a single "
                     "name fills a (2, 2) grid (default: --device)")
ap.add_argument("--n", type=int, default=512, help="train points")
ap.add_argument("--t", type=int, default=128, help="test points")
args = ap.parse_args()

n, t, k = args.n, args.t, 5
x, y = make_moons(n // 2, noise=0.08, seed=0)
xt, yt = make_moons(t // 2, noise=0.08, seed=1)

names = (args.devices or args.device).split(",")
if len(names) == 1:
    names, shape = names * 4, (2, 2)
else:
    dmodel = 2 if len(names) % 2 == 0 else 1
    shape = (len(names) // dmodel, dmodel)
grid = DeviceGrid(tuple(torch.device(nm) for nm in names), shape)
print(f"devices: {len(set(grid.devices))} distinct, grid: {grid.axis_sizes}")

dev0 = grid.devices[0]
x, y, xt, yt = (a.to(dev0) for a in (x, y, xt, yt))
scfg = STIConfig(n_train=n, feat_dim=2, k=k, test_chunk=t)
step, _, _, _ = sti_cell(scfg, grid)
acc, diag = step(x, y, xt, yt, torch.arange(n, dtype=torch.int32))
# phi is symmetric: the gathered column blocks are its row blocks
phi = torch.cat([a.T.to(dev0) for a in acc]) / t
phi.diagonal().copy_(diag / t)

ref = sti_knn_interactions(x, y, xt, yt, k, device=dev0)
err = float((phi - ref).abs().max())
print(f"max |distributed - reference| = {err:.2e}")
assert err < 1e-5
print("[ok] distributed result matches the single-host algorithm")

# --- the streaming form: the sharded fused pipeline -----------------------
# Row-sharded accumulators ((n/D, n) per device, n^2/D memory) fed by a
# row-sharded test stream; same contract as ValuationSession, so test
# points can arrive incrementally and the stream survives preemption via
# checkpoint()/restore().
from repro_torch.core.session import ShardedValuationSession  # noqa: E402

sess = ShardedValuationSession(x, y, k=k, test_batch=32,
                               devices=list(grid.devices))
print(f"sharded session: {sess.shards} row shards, "
      f"test_batch={sess.test_batch}")
for start in range(0, t, 32):
    sess.update(xt[start:start + 32], yt[start:start + 32])
res = sess.finalize()
err = float((res.phi - ref).abs().max())
print(f"max |sharded stream - reference| = {err:.2e}")
assert err < 1e-5
print("[ok] sharded streaming engine matches the single-host algorithm")
