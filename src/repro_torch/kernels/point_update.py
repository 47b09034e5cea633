"""The knn point update's own kernel: `csrc/point_update.cu`, the port's
own (it replaces no TPU kernel; the JAX package leaves the recurrence and
the gather through `ranks` to XLA).

`point_update_cuda(vec, u, ranks, k)` adds

    sum over rows of gather(knn_shapley_from_sorted(u, k), 1, ranks)

into the (n,) f32 `vec` in place and returns it, for a (tb, n) f32 `u` in
sorted coordinates (knn_shapley's masked label match, or wknn's weighted
one) and its (tb, n) int64 `ranks`: the update of the streaming step for
both methods (`stream_kernels._point_factory`). `vec=None` returns the
sum as a new (n,) tensor instead, the partial a shard hands to the
reduce-scatter. On CUDA tensors it launches the kernel (a memset and two
kernels a call: the suffix recurrence over sorted positions, then the
sum over test rows through `ranks`) or raises; on CPU tensors it takes
`point_update_plain`, the update as the step ran it before the kernel.

The kernel forms every term with the plain version's roundings in f32;
only the order of the suffix sums and of the sum over rows differs, and
it is fixed, so two runs give the same bits. Its scratch -- the per-row
values `s`, one (tb, n) f32 plane, and the control words, 8 bytes per
tile of 4096 positions and per row -- is allocated by each call and freed
when it returns.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import library
from repro_torch.launch.hlo_analysis import KERNELS, point_update_cost

__all__ = ["point_update_plain", "point_update_cuda", "workspace_bytes"]

TILE = 4096                 # positions a tile of the recurrence takes
_MAX_N = 2**31 - 1 - TILE


def workspace_bytes(tb: int, n: int) -> int:
    """The kernel's control words for (tb, n) (`point_update_ws_bytes` in
    the source), 8 bytes each: a ticket counter, one look-back word per
    tile of a row, one counter per row."""
    return 8 * (1 + tb * -(-n // TILE) + tb)


def point_update_plain(vec, u: torch.Tensor, ranks: torch.Tensor, k: int):
    """`vec += _shapley_point_values(u, ranks, k, {}).sum(0)` in place, or
    the sum itself for `vec=None`: the update as the step ran it before
    the kernel."""
    from repro_torch.kernels.stream_kernels import _shapley_point_values

    part = _shapley_point_values(u, ranks, k, {}).sum(0)
    return part if vec is None else vec.add_(part)


def _check(vec, u: torch.Tensor, ranks: torch.Tensor, k: int) -> None:
    if u.ndim != 2 or ranks.shape != u.shape:
        raise ValueError(f"point_update_cuda takes (tb, n) u and ranks of "
                         f"one shape, got {tuple(u.shape)} and "
                         f"{tuple(ranks.shape)}")
    if u.dtype != torch.float32 or ranks.dtype != torch.int64:
        raise TypeError(f"point_update_cuda takes float32 u and int64 "
                        f"ranks, got {u.dtype} and {ranks.dtype}")
    if vec is not None and (vec.dtype != torch.float32
                            or tuple(vec.shape) != (u.shape[1],)):
        raise ValueError(f"vec must be ({u.shape[1]},) float32, got "
                         f"{tuple(vec.shape)} {vec.dtype}")
    tensors = (u, ranks) if vec is None else (u, ranks, vec)
    if any(t.device != u.device for t in tensors):
        raise ValueError("u, ranks and vec must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("point_update_cuda needs contiguous tensors")
    if u.shape[1] > _MAX_N:
        raise ValueError(f"rows of at most {_MAX_N} positions, got "
                         f"{u.shape[1]}")
    if int(k) < 1:
        raise ValueError(f"k must be at least 1, got {k}")


def point_update_cuda(vec, u: torch.Tensor, ranks: torch.Tensor, k: int):
    """vec += the Shapley values of (tb, n) `u` gathered through `ranks`
    and summed over rows, in place; returns vec (a new (n,) sum for
    `vec=None`).

    CPU tensors take `point_update_plain`; CUDA tensors launch the kernel
    (or raise). Meta tensors in the dry run (`KERNELS.counting()`)
    allocate the scratch on meta and add `point_update_cost` to
    `hlo_analysis.KERNELS`. `point_update_cuda.launches` counts the calls
    that launched the kernel."""
    if u.device.type == "cpu":
        return point_update_plain(vec, u, ranks, k)
    _check(vec, u, ranks, k)
    tb, n = u.shape
    dev = u.device
    if vec is None:
        vec = torch.zeros((n,), dtype=torch.float32, device=dev)
    s = torch.empty((tb, n), dtype=torch.float32, device=dev)
    ws = torch.empty((workspace_bytes(tb, n),), dtype=torch.uint8,
                     device=dev)
    if dev.type == "meta" and KERNELS.active:
        KERNELS.add("point_update", point_update_cost(tb, n))
        return vec
    if tb == 0 or n == 0:
        return vec
    lib = library("point_update")
    lib.point_update_ws_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.point_update_ws_bytes.restype = ctypes.c_longlong
    if lib.point_update_ws_bytes(tb, n) != ws.numel():
        raise RuntimeError("kernels/point_update.py's workspace_bytes "
                           "disagrees with csrc/point_update.cu's")
    fn = lib.point_update
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(u.data_ptr(), ranks.data_ptr(), vec.data_ptr(),
                s.data_ptr(), ws.data_ptr(), tb, n, int(k),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"point update launch failed: CUDA error {rc}")
    point_update_cuda.launches += 1
    return vec


point_update_cuda.launches = 0
