"""The STI-KNN fill kernel: the CUDA counterpart of
`repro.kernels.sti_fill.sti_fill_acc_pallas` and `sti_fill_pallas`.

    acc[a, b] += sum_p g[p, max(ranks[p, a], ranks[p, b])]

`sti_fill_acc_cuda` updates a live (n, n) f32 accumulator in place (the
update that replaces the Pallas kernel's `input_output_aliases`);
`sti_fill_cuda` is the same kernel on a zeroed accumulator. On CUDA
tensors they launch the kernel of `csrc/sti_fill.cu`; on CPU tensors they
take the plain versions below. The design notes (why the TPU kernel's
VMEM-resident g block does not carry over, and the compare-select identity
used instead) are at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import library

__all__ = [
    "sti_fill_plain",
    "sti_fill_acc_plain",
    "sti_fill_cuda",
    "sti_fill_acc_cuda",
]


def sti_fill_acc_plain(acc: torch.Tensor, g: torch.Tensor,
                       ranks: torch.Tensor) -> torch.Tensor:
    """acc[a, b] += sum_p g[p, max(ranks[p, a], ranks[p, b])], in place,
    one test point at a time through the compare-select identity
    g[p, max(r_a, r_b)] = (r_a >= r_b) ? g[p, r_a] : g[p, r_b].
    Peak memory is one (n, n) temporary."""
    r = ranks.long()
    gt = torch.gather(g.to(torch.float32), 1, r)
    for p in range(g.shape[0]):
        acc.add_(torch.where(r[p, :, None] >= r[p, None, :],
                             gt[p, :, None], gt[p, None, :]))
    return acc


def sti_fill_plain(g: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Zero-init form of `sti_fill_acc_plain` -> (n, n) f32."""
    n = g.shape[1]
    acc = torch.zeros((n, n), dtype=torch.float32, device=g.device)
    return sti_fill_acc_plain(acc, g, ranks)


def _check(acc: torch.Tensor, g: torch.Tensor, ranks: torch.Tensor) -> None:
    dev = acc.device
    if g.device != dev or ranks.device != dev:
        raise ValueError(
            f"acc, g and ranks must share a device: {acc.device}, "
            f"{g.device}, {ranks.device}"
        )
    if g.ndim != 2 or ranks.shape != g.shape:
        raise ValueError(
            f"g and ranks must both be (t, n): {tuple(g.shape)} vs "
            f"{tuple(ranks.shape)}"
        )
    n = g.shape[1]
    if acc.shape != (n, n):
        raise ValueError(f"acc must be ({n}, {n}), got {tuple(acc.shape)}")
    if acc.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(
            f"acc and g must be float32, got {acc.dtype} and {g.dtype}"
        )
    if ranks.dtype.is_floating_point or ranks.dtype == torch.bool:
        raise TypeError(f"ranks must be integer, got {ranks.dtype}")
    if not (acc.is_contiguous() and g.is_contiguous()):
        raise ValueError("acc and g must be contiguous")


def sti_fill_acc_cuda(acc: torch.Tensor, g: torch.Tensor,
                      ranks: torch.Tensor) -> torch.Tensor:
    """acc[a, b] += sum_p g[p, max(ranks[p, a], ranks[p, b])] in place;
    returns `acc`. CPU tensors take `sti_fill_acc_plain`; CUDA tensors
    launch the kernel (or raise). Ranks are cast to int32 for the kernel
    (torch's gather/scatter produce int64). `sti_fill_acc_cuda.launches`
    counts kernel launches."""
    if all(x.device.type == "cpu" for x in (acc, g, ranks)):
        return sti_fill_acc_plain(acc, g, ranks)
    _check(acc, g, ranks)
    t, n = g.shape
    if t == 0 or n == 0:
        return acc
    r32 = ranks.to(torch.int32).contiguous()
    gt = torch.empty_like(g)  # g gathered at each train point's rank
    fn = library("sti_fill").sti_fill_acc_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(acc.device):
        rc = fn(acc.data_ptr(), g.data_ptr(), r32.data_ptr(), gt.data_ptr(),
                t, n, torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sti_fill kernel launch failed: CUDA error {rc}")
    sti_fill_acc_cuda.launches += 1
    return acc


sti_fill_acc_cuda.launches = 0


def sti_fill_cuda(g: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """out[a, b] = sum_p g[p, max(ranks[p, a], ranks[p, b])] -> (n, n) f32:
    the accumulate kernel launched on a zeroed accumulator (its launches
    count on `sti_fill_acc_cuda.launches`)."""
    n = g.shape[1]
    acc = torch.zeros((n, n), dtype=torch.float32, device=g.device)
    return sti_fill_acc_cuda(acc, g, ranks)
