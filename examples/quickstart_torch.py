"""Quickstart of the PyTorch port: exact pair-interaction Shapley values
for a KNN model, on an NVIDIA card (or, when asked, the CPU).

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \
        --n 64 --t 16

The port's counterpart of `examples/quickstart.py`: resolves the paper's
STI-KNN algorithm from the valuation method registry, computes the
interaction matrix on the Circle dataset as a `ValuationResult` artifact
(the distance and fill kernels on the card), checks the efficiency axiom,
and prints the in-class / out-of-class interaction structure (paper
Fig. 3).
"""

import argparse

import numpy as np
import torch

from repro_torch import get_method, list_methods
from repro_torch.core.analysis import knn_test_accuracy
from repro_torch.data import make_circles

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
ap.add_argument("--n", type=int, default=300, help="train points")
ap.add_argument("--t", type=int, default=100, help="test points")
args = ap.parse_args()
dev = args.device

# 1. data: two concentric circles, 300 train / 100 test points by default
x_train, y_train = make_circles(args.n // 2, noise=0.08, seed=0)
x_test, y_test = make_circles(args.t // 2, noise=0.08, seed=1)

# 2. the paper's algorithm, via the registry: exact O(t n^2) pair
#    interactions, returned as a ValuationResult with provenance metadata
print(f"registered methods: {list_methods()}")
result = get_method("sti")(x_train, y_train, x_test, y_test, k=5, device=dev)
phi = result.interaction_matrix()
print(f"interaction matrix: {tuple(phi.shape)}, symmetric: "
      f"{bool(torch.allclose(phi, phi.T))}")
print(f"provenance: engine={result.meta['engine']} k={result.meta['k']} "
      f"fill={result.meta['fill']} device={result.meta['device_kind']} "
      f"elapsed={result.meta['elapsed_s']}s")

# 3. efficiency axiom: diag + upper triangle sums to the KNN test score
v_n = knn_test_accuracy(x_train, y_train, x_test, y_test, 5, device=dev)
print(f"sum(phi) = {float(torch.triu(phi).sum()):.6f}  "
      f"v(N) = {v_n:.6f}  (efficiency gap "
      f"{float(result.efficiency_gap(v_n)):.2e})")

# 4. structure: in-class pairs interact negatively (redundancy), across-class
#    pairs barely interact (paper Fig. 3)
s = result.class_block_summary(y_train, 2)
print(f"mean in-class interaction:  {float(s.in_class_mean.mean()):+.3e}")
print(f"mean out-class interaction: {float(s.out_class_mean):+.3e}")

# 5. the order-2 Shapley-Taylor decomposition recovers exact Shapley values:
#    result.values() aggregates phi_ii + 1/2 sum_j phi_ij
sv = get_method("knn_shapley")(x_train, y_train, x_test, y_test, k=5,
                               device=dev)
print(f"max |phi-aggregate - KNN-Shapley| = "
      f"{float((result.values() - sv.values()).abs().max()):.2e}")

# 6. weighted-KNN Shapley (distance-weighted utility) ranks similarly
wv = get_method("wknn")(x_train, y_train, x_test, y_test, k=5,
                        weights="rbf", device=dev)
corr = np.corrcoef(sv.values().cpu().numpy(),
                   wv.values().cpu().numpy())[0, 1]
print(f"wknn vs knn_shapley rank agreement (Pearson): {corr:.3f}")
