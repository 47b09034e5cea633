"""`repro_torch.kernels.ops` against `repro.kernels.ops`, and the kernel
package's exports.

On CPU tensors `ops.sti_fill` and `ops.pairwise_distance` take the plain
versions and agree with the JAX package's `ops` (its reference path off
a TPU) within 1e-6 of max |ref| on the same numpy inputs. On the card
(`-m cuda`) they launch the hand-written kernels, bit-equal to
`sti_fill_cuda` / `distance_cuda`, one launch each.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.distance import distance_cuda
from repro_torch.kernels.sti_fill import sti_fill_acc_cuda, sti_fill_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


def _fill_inputs(t, n, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(t, n)).astype(np.float32)
    ranks = np.argsort(rng.random((t, n)), axis=1).astype(np.int32)
    return g, ranks


def _close(got, want, tol=1e-6):
    want = np.asarray(want, dtype=np.float64)
    err = np.abs(np.asarray(got, dtype=np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), err


def test_ops_exports_the_references_kernels():
    assert set(ops.__all__) == {"sti_fill", "pairwise_distance",
                                "flash_attention"}


@pytest.mark.parametrize("t,n", [(1, 1), (5, 17), (16, 130)])
def test_sti_fill_matches_the_reference(t, n):
    jops = pytest.importorskip("repro.kernels.ops")
    g, ranks = _fill_inputs(t, n, seed=t * 1000 + n)
    got = ops.sti_fill(torch.from_numpy(g), torch.from_numpy(ranks))
    assert got.shape == (n, n) and got.dtype == torch.float32
    _close(got.numpy(), jops.sti_fill(g, ranks))


@pytest.mark.parametrize("t,n,d", [(1, 1, 1), (7, 33, 5), (16, 130, 24)])
def test_pairwise_distance_matches_the_reference(t, n, d):
    jops = pytest.importorskip("repro.kernels.ops")
    rng = np.random.default_rng(t + n + d)
    xt = rng.normal(size=(t, d)).astype(np.float32)
    xn = rng.normal(size=(n, d)).astype(np.float32)
    got = ops.pairwise_distance(torch.from_numpy(xt), torch.from_numpy(xn))
    assert got.shape == (t, n) and got.dtype == torch.float32
    assert bool((got >= 0).all())
    _close(got.numpy(), jops.pairwise_distance(xt, xn))


def test_cpu_tensors_launch_no_kernel():
    g, ranks = _fill_inputs(4, 9, seed=0)
    before = (sti_fill_acc_cuda.launches, distance_cuda.launches)
    ops.sti_fill(torch.from_numpy(g), torch.from_numpy(ranks))
    ops.pairwise_distance(torch.ones(3, 2), torch.zeros(5, 2))
    assert (sti_fill_acc_cuda.launches, distance_cuda.launches) == before


def test_kernels_reexport_the_streaming_merge():
    from repro_torch.kernels import (
        __all__ as names, merge_sorted_tile, streaming_merge_reference)
    from repro_torch.kernels import sti_megakernel

    assert {"merge_sorted_tile", "streaming_merge_reference"} <= set(names)
    assert merge_sorted_tile is sti_megakernel.merge_sorted_tile
    assert streaming_merge_reference is \
        sti_megakernel.streaming_merge_reference
    d2 = torch.tensor([[3.0, 1.0, 2.0, 1.0]])
    d2s, idx, match = streaming_merge_reference(
        d2, torch.tensor([[1.0, 0.0, 1.0, 1.0]]), block_n=2)
    assert idx.tolist() == [[1, 3, 2, 0]]
    assert d2s.tolist() == [[1.0, 1.0, 2.0, 3.0]]
    assert match.tolist() == [[0.0, 1.0, 1.0, 1.0]]


@pytest.mark.cuda
def test_ops_launch_the_kernels_on_the_card(cuda):
    g, ranks = _fill_inputs(16, 300, seed=1)
    g, ranks = torch.from_numpy(g).to(cuda), torch.from_numpy(ranks).to(cuda)
    xt = torch.randint(-8, 9, (33, 20), device=cuda).float()
    xn = torch.randint(-8, 9, (300, 20), device=cuda).float()
    fills, dists = sti_fill_acc_cuda.launches, distance_cuda.launches
    got_fill = ops.sti_fill(g, ranks)
    got_dist = ops.pairwise_distance(xt, xn)
    torch.cuda.synchronize()
    assert sti_fill_acc_cuda.launches == fills + 1
    assert distance_cuda.launches == dists + 1
    assert torch.equal(got_fill, sti_fill_cuda(g, ranks))
    assert torch.equal(got_dist, distance_cuda(xt, xn))
