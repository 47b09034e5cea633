"""The rank stage's stable sort: `csrc/rank_sort.cu`, the port's own
kernel (it replaces no TPU kernel; the JAX package ranks with
`jnp.argsort`).

`rank_order_cuda(d2)` -> (order, ranks), both (tb, n) int64: `order` the
stable argsort of each row of the f32 distances (the order of
`torch.sort(stable=True)` on the card: -0 sorted as +0, a NaN by its
bits, so a negative NaN before -inf and a positive one after +inf; the
CPU's sort puts every NaN last) and `ranks` its inverse permutation, as
the streaming step's rank stage takes them. On CUDA tensors it launches
the kernel (a segmented LSD radix sort of every row at once, eight
launches a call); on CPU tensors it takes `rank_order_plain`,
`torch.sort` followed by `ranks_from_order`.

The kernel's workspace -- one (tb, n) plane of (key, index) int32 pairs,
8 bytes a key, and the zeroed control words (`ctl_words`: per-row digit
histograms, the passes' look-back words, 4 KiB per 4096 keys, and the
rank inversion's bucket cursors) -- is allocated by each call and freed
when it returns, so it never outlives the rank stage; between passes the
pairs also live in `order`'s own memory, and the last pass's (index,
position) pairs in `ranks`'s.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sti_knn import ranks_from_order
from repro_torch.kernels.build import library
from repro_torch.launch.hlo_analysis import KERNELS, rank_sort_cost

__all__ = ["rank_order_plain", "rank_order_cuda", "sort_passes", "ctl_words"]

# the kernel's constants (csrc/rank_sort.cu)
RADIX_BITS = 8
DIGITS = 32 // RADIX_BITS
TILE = 4096                 # keys a pass's tile takes
BUCKET = 8192               # indices a bucket of the rank inversion holds
_ROW_WORDS = 4
_MAX_N = (1 << 30) - 1      # a look-back word's count field


def ctl_words(tb: int, n: int) -> int:
    """The kernel's int32 control words for (tb, n) keys
    (`rank_sort_ctl_words` in the source): two per digit, per row its
    words, its place in each digit's row list and two (DIGITS, 256)
    tables, and DIGITS x 256 look-back words per tile of a row."""
    tiles = -(-n // TILE)
    return (2 * DIGITS + tb * (_ROW_WORDS + DIGITS + 2 * DIGITS * 256)
            + DIGITS * 256 * tb * tiles + tb * -(-n // BUCKET))


def rank_order_plain(d2: torch.Tensor):
    """(tb, n) -> (order, ranks): `torch.sort(stable=True)` and
    `ranks_from_order`, the rank stage as the step ran it before the
    kernel."""
    order = torch.sort(d2, dim=-1, stable=True).indices
    return order, ranks_from_order(order)


def sort_passes(d2: torch.Tensor) -> torch.Tensor:
    """(tb,) int32: the passes the kernel takes on each row of (tb, n) f32
    keys, one for each RADIX_BITS-bit digit of key - min(key) that differs
    between two keys of the row (a pass by a digit that every key shares
    is the identity, so the kernel skips it), and at least one."""
    bits = d2.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, torch.zeros_like(bits), bits)
    keys = bits ^ torch.where(bits >> 31 == 1,
                              torch.full_like(bits, 0xFFFFFFFF),
                              torch.full_like(bits, 0x80000000))
    x = keys - keys.min(-1, keepdim=True).values
    passes = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    for shift in range(0, 32, RADIX_BITS):
        digit = (x >> shift) & ((1 << RADIX_BITS) - 1)
        passes += (digit != digit[..., :1]).any(-1).to(torch.int32)
    return passes.clamp_min(1)


def _check(d2: torch.Tensor, passes) -> None:
    if d2.ndim != 2:
        raise ValueError(f"rank_order_cuda takes (tb, n) keys, got shape "
                         f"{tuple(d2.shape)}")
    if d2.dtype != torch.float32:
        raise TypeError(f"rank_order_cuda takes float32 keys, got "
                        f"{d2.dtype}")
    if not d2.is_contiguous():
        raise ValueError("rank_order_cuda needs contiguous row-major keys")
    if d2.shape[1] > _MAX_N:
        raise ValueError(f"rows of at most {_MAX_N} keys, got {d2.shape[1]}")
    if passes is not None and (
            passes.device != d2.device or passes.dtype != torch.int32
            or tuple(passes.shape) != (d2.shape[0],)
            or not passes.is_contiguous()):
        raise ValueError("passes must be a contiguous (tb,) int32 tensor "
                         "on the keys' device")


def _workspace(tb: int, n: int, dev) -> tuple:
    """The pairs plane (uninitialised) and the control words (zeroed)."""
    return (torch.empty((tb, n, 2), dtype=torch.int32, device=dev),
            torch.zeros((ctl_words(tb, n),), dtype=torch.int32, device=dev))


def rank_order_cuda(d2: torch.Tensor, passes: torch.Tensor | None = None):
    """(tb, n) f32 keys -> (order, ranks), (tb, n) int64 each.

    CPU tensors take `rank_order_plain` (and `passes`, if given, gets
    `sort_passes`); CUDA tensors launch the kernel (or raise). `passes`,
    a (tb,) int32 tensor on the keys' device, receives the radix passes
    each row took (1-4), for tests and reports; the step passes none and
    never waits on the card. Meta tensors in the dry run
    (`KERNELS.counting()`) give meta outputs, allocate the workspace on
    meta and add `rank_sort_cost` to `hlo_analysis.KERNELS`.
    `rank_order_cuda.launches` counts the calls that launched the kernel
    (eight launches each)."""
    if d2.device.type == "cpu":
        if passes is not None:
            passes.copy_(sort_passes(d2))
        return rank_order_plain(d2)
    _check(d2, passes)
    tb, n = d2.shape
    dev = d2.device
    order = torch.empty((tb, n), dtype=torch.int64, device=dev)
    ranks = torch.empty((tb, n), dtype=torch.int64, device=dev)
    if dev.type == "meta" and KERNELS.active:
        _workspace(tb, n, dev)
        KERNELS.add("rank_sort", rank_sort_cost(tb, n))
        return order, ranks
    if tb == 0 or n == 0:
        return order, ranks
    lib = library("rank_sort")
    lib.rank_sort_ctl_words.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.rank_sort_ctl_words.restype = ctypes.c_longlong
    if lib.rank_sort_ctl_words(tb, n) != ctl_words(tb, n):
        raise RuntimeError("kernels/rank_sort.py's ctl_words disagrees with "
                           "csrc/rank_sort.cu's")
    work, ctl = _workspace(tb, n, dev)
    fn = lib.rank_sort
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(d2.data_ptr(), order.data_ptr(), ranks.data_ptr(),
                work.data_ptr(), ctl.data_ptr(),
                None if passes is None else passes.data_ptr(), tb, n,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rank sort launch failed: CUDA error {rc}")
    rank_order_cuda.launches += 1
    return order, ranks


rank_order_cuda.launches = 0
