"""Squared-L2 distance kernel: the CUDA counterpart of
`repro.kernels.distance.distance_pallas`.

`distance_cuda(x_test, x_train)` -> (t, n) f32 squared distances
||a||^2 - 2 a.b + ||b||^2, clamped at 0, with f32 accumulation for f32 or
bf16 inputs. On CUDA tensors it launches the kernel of
`csrc/distance.cu` (a Hopper kernel: TMA-fed tiles, the cross term on the
tensor cores as three TF32 products for f32 and one bf16 product for bf16,
the norm epilogue fused into the store); on CPU tensors it takes
`distance_plain`, the same expansion in plain PyTorch.

The kernel's input contract is TMA's: rows of a multiple of 16 bytes,
16-byte aligned. `tma_operands` pads d with zero columns to a multiple of
4 (f32) or 8 (bf16) -- zero columns change neither the products nor the
norms -- and copies a misaligned view; the main path (d = 768, fresh
tensors) copies nothing. The megakernel's distance phase stages its f32
tiles with 16-byte loads under the same contract, and its wrapper passes
its features through `tma_operands` too, so this function alone decides
how a ragged or misaligned d reaches either kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sti_knn import pairwise_sq_dists
from repro_torch.kernels.build import library
from repro_torch.launch.hlo_analysis import KERNELS, distance_cost

__all__ = ["distance_plain", "distance_cuda", "tma_operands",
           "candidate_sq_dists"]

_DTYPES = {torch.float32: "sq_dist_f32", torch.bfloat16: "sq_dist_bf16"}


# The plain version is the core expansion, the same one the fused step's
# "plain" distance runs: ||a||^2 - 2 a.b + ||b||^2 in f32, clamped at 0.
distance_plain = pairwise_sq_dists


def candidate_sq_dists(x_test: torch.Tensor, x_train: torch.Tensor,
                       cand: torch.Tensor, *,
                       train_norms: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """(tb, d) test rows, (n, d) train set, (tb, P) candidate ids -> (tb, P)
    exact squared L2 distances to the candidates only (the counterpart of
    `repro.kernels.distance.candidate_sq_dists`, which is no Pallas
    kernel either: a gather and a batched contraction). Same expansion as
    the dense row, ||a||^2 - 2 a.b + ||b||^2 clamped at 0, at O(tb P d)
    instead of O(tb n d). `train_norms` (n,) may be precomputed once per
    train set (the LSH index keeps it); otherwise the norms are taken
    over the gathered rows."""
    xt = x_test.to(torch.float32)
    rows = x_train.to(torch.float32)[cand]              # (tb, P, d)
    cross = torch.einsum("td,tpd->tp", xt, rows)
    nt = torch.sum(xt * xt, dim=-1, keepdim=True)       # (tb, 1)
    if train_norms is not None:
        nn = train_norms.to(torch.float32)[cand]        # (tb, P)
    else:
        nn = torch.sum(rows * rows, dim=-1)
    return torch.clamp_min(nt - 2.0 * cross + nn, 0.0)


def _check(x_test: torch.Tensor, x_train: torch.Tensor) -> None:
    if x_test.device != x_train.device:
        raise ValueError(
            f"x_test on {x_test.device} but x_train on {x_train.device}"
        )
    if x_test.ndim != 2 or x_train.ndim != 2:
        raise ValueError("features must be (num_points, dim)")
    if x_test.shape[1] != x_train.shape[1]:
        raise ValueError(
            f"feature dims differ: {x_test.shape[1]} vs {x_train.shape[1]}"
        )
    if x_test.dtype != x_train.dtype or x_test.dtype not in _DTYPES:
        raise TypeError(
            f"distance_cuda takes two float32 or two bfloat16 tensors, got "
            f"{x_test.dtype} and {x_train.dtype}"
        )
    if not (x_test.is_contiguous() and x_train.is_contiguous()):
        raise ValueError("distance_cuda needs contiguous row-major inputs")


def tma_operands(x_test: torch.Tensor, x_train: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two (rows, d) operands as the kernel takes them: d padded with
    zero columns to a multiple of 16 bytes, each 16-byte aligned. Returns
    the inputs themselves where nothing needs to change."""
    per16 = 16 // x_test.element_size()
    pad = -x_test.shape[1] % per16

    def fit(x):
        if pad:
            return torch.nn.functional.pad(x, (0, pad))
        return x if x.data_ptr() % 16 == 0 else x.clone()

    return fit(x_test), fit(x_train)


def distance_cuda(x_test: torch.Tensor, x_train: torch.Tensor
                  ) -> torch.Tensor:
    """(t, d), (n, d) -> (t, n) f32 squared distances.

    CPU tensors take `distance_plain`; CUDA tensors launch the kernel
    (or raise). Meta tensors in the dry run (`KERNELS.counting()`) give
    a meta result and add the kernel's cost to `hlo_analysis.KERNELS`.
    `distance_cuda.launches` counts kernel launches."""
    if x_test.device.type == "cpu" and x_train.device.type == "cpu":
        return distance_plain(x_test, x_train)
    _check(x_test, x_train)
    t, n = x_test.shape[0], x_train.shape[0]
    dev = x_test.device
    out = torch.empty((t, n), dtype=torch.float32, device=dev)
    if dev.type == "meta" and KERNELS.active:
        KERNELS.add("distance", distance_cost(t, n, x_test.shape[1],
                                              x_test.element_size()))
        return out
    if t == 0 or n == 0:
        return out
    if x_test.shape[1] == 0:  # no features: every distance is 0
        return out.zero_()
    x_test, x_train = tma_operands(x_test, x_train)
    d = x_test.shape[1]
    nt = torch.empty((t,), dtype=torch.float32, device=dev)
    nn = torch.empty((n,), dtype=torch.float32, device=dev)
    fn = getattr(library("distance"), _DTYPES[x_test.dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(x_test.data_ptr(), x_train.data_ptr(), nt.data_ptr(),
                nn.data_ptr(), out.data_ptr(), t, n, d,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"distance kernel launch failed: CUDA error {rc}")
    distance_cuda.launches += 1
    return out


distance_cuda.launches = 0
