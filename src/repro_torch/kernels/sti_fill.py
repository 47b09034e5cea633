"""The STI-KNN fill kernels: the CUDA counterparts of
`repro.kernels.sti_fill.sti_fill_acc_pallas` / `sti_fill_pallas` (square)
and `sti_fill_acc_rect_pallas` / `sti_fill_rect_pallas` (rectangular).

    acc[a, b] += sum_p g[p, max(ranks[p, a], ranks[p, b])]             square
    acc[a, b] += sum_p g[p, max(ranks_rows[p, a], ranks_cols[p, b])]   rect

`sti_fill_acc_cuda` updates a live (n, n) f32 accumulator in place (the
update that replaces the Pallas kernel's `input_output_aliases`);
`sti_fill_acc_rect_cuda` does the same on an (n_rows, n_cols) block with
independent row and column rank tables over one rank space -- the sharded
engine's (n/D, n) row block, whose row table is `rect_row_view` of the
column table. `sti_fill_cuda` / `sti_fill_rect_cuda` are the same kernels
on a zeroed accumulator. On CUDA tensors they launch the kernel of
`csrc/sti_fill.cu`; on CPU tensors they take the plain versions below.
The design notes (why the TPU kernel's VMEM-resident g block does not
carry over, and the compare-select identity used instead) are at the top
of the CUDA source.
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
    "sti_fill_rect_plain",
    "sti_fill_acc_rect_plain",
    "sti_fill_rect_cuda",
    "sti_fill_acc_rect_cuda",
    "rect_row_view",
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


# ------------------------------------------------------------ rectangular
def rect_row_view(ranks: torch.Tensor, row_offset: int,
                  row_count: int) -> torch.Tensor:
    """(t, n) global rank table -> its (t, row_count) window starting at
    global row `row_offset`: the row index base of a rectangular fill. A
    view, not a copy."""
    off, count = int(row_offset), int(row_count)
    if off < 0 or count < 0 or off + count > ranks.shape[1]:
        raise ValueError(
            f"row window [{off}, {off + count}) is outside the "
            f"{ranks.shape[1]} columns of the rank table"
        )
    return ranks[:, off:off + count]


def sti_fill_acc_rect_plain(acc: torch.Tensor, g: torch.Tensor,
                            ranks_rows: torch.Tensor,
                            ranks_cols: torch.Tensor) -> torch.Tensor:
    """acc[a, b] += sum_p g[p, max(ranks_rows[p, a], ranks_cols[p, b])],
    in place, one test point at a time through the compare-select
    identity, as `sti_fill_acc_plain` does for the square. Peak memory is
    one (n_rows, n_cols) temporary."""
    g = g.to(torch.float32)
    rr, rc = ranks_rows.long(), ranks_cols.long()
    gr, gc = torch.gather(g, 1, rr), torch.gather(g, 1, rc)
    for p in range(g.shape[0]):
        acc.add_(torch.where(rr[p, :, None] >= rc[p, None, :],
                             gr[p, :, None], gc[p, None, :]))
    return acc


def sti_fill_rect_plain(g: torch.Tensor, ranks_rows: torch.Tensor,
                        ranks_cols: torch.Tensor) -> torch.Tensor:
    """Zero-init form of `sti_fill_acc_rect_plain` -> (n_rows, n_cols)
    f32."""
    acc = torch.zeros((ranks_rows.shape[1], ranks_cols.shape[1]),
                      dtype=torch.float32, device=g.device)
    return sti_fill_acc_rect_plain(acc, g, ranks_rows, ranks_cols)


def _check_rect(acc, g, ranks_rows, ranks_cols) -> None:
    dev = acc.device
    if any(x.device != dev for x in (g, ranks_rows, ranks_cols)):
        raise ValueError(
            f"acc, g and both rank tables must share a device: {acc.device}, "
            f"{g.device}, {ranks_rows.device}, {ranks_cols.device}"
        )
    if g.ndim != 2 or ranks_rows.ndim != 2 or ranks_cols.ndim != 2:
        raise ValueError("g and the rank tables must be 2-D (t, .)")
    t = g.shape[0]
    if ranks_rows.shape[0] != t or ranks_cols.shape[0] != t:
        raise ValueError(
            f"g and both rank tables must have the same t: {t}, "
            f"{ranks_rows.shape[0]}, {ranks_cols.shape[0]}"
        )
    shape = (ranks_rows.shape[1], ranks_cols.shape[1])
    if acc.shape != shape:
        raise ValueError(f"acc must be {shape}, got {tuple(acc.shape)}")
    if acc.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(
            f"acc and g must be float32, got {acc.dtype} and {g.dtype}"
        )
    for r in (ranks_rows, ranks_cols):
        if r.dtype.is_floating_point or r.dtype == torch.bool:
            raise TypeError(f"rank tables must be integer, got {r.dtype}")
    if not (acc.is_contiguous() and g.is_contiguous()):
        raise ValueError("acc and g must be contiguous")


def sti_fill_acc_rect_cuda(acc: torch.Tensor, g: torch.Tensor,
                           ranks_rows: torch.Tensor,
                           ranks_cols: torch.Tensor) -> torch.Tensor:
    """acc[a, b] += sum_p g[p, max(ranks_rows[p, a], ranks_cols[p, b])] in
    place on the (n_rows, n_cols) block; returns `acc`. g is (t, n) and
    every rank is < n. CPU tensors take `sti_fill_acc_rect_plain`; CUDA
    tensors launch the kernel (or raise). Each rank table is cast to a
    contiguous int32 copy and g is gathered for each side on its own.
    `sti_fill_acc_rect_cuda.launches` counts kernel launches."""
    if all(x.device.type == "cpu" for x in (acc, g, ranks_rows, ranks_cols)):
        return sti_fill_acc_rect_plain(acc, g, ranks_rows, ranks_cols)
    _check_rect(acc, g, ranks_rows, ranks_cols)
    (t, n), nr, nc = g.shape, ranks_rows.shape[1], ranks_cols.shape[1]
    if t == 0 or nr == 0 or nc == 0:
        return acc
    rr32 = ranks_rows.to(torch.int32).contiguous()
    rc32 = ranks_cols.to(torch.int32).contiguous()
    gt_rows = torch.empty((t, nr), dtype=torch.float32, device=acc.device)
    gt_cols = torch.empty((t, nc), dtype=torch.float32, device=acc.device)
    fn = library("sti_fill").sti_fill_acc_rect_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(acc.device):
        rc = fn(acc.data_ptr(), g.data_ptr(), rr32.data_ptr(),
                rc32.data_ptr(), gt_rows.data_ptr(), gt_cols.data_ptr(), t,
                n, nr, nc, rr32.stride(0),
                torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"sti_fill rect kernel launch failed: CUDA error {rc}")
    sti_fill_acc_rect_cuda.launches += 1
    return acc


sti_fill_acc_rect_cuda.launches = 0


def sti_fill_rect_cuda(g: torch.Tensor, ranks_rows: torch.Tensor,
                       ranks_cols: torch.Tensor) -> torch.Tensor:
    """out[a, b] = sum_p g[p, max(ranks_rows[p, a], ranks_cols[p, b])] ->
    (n_rows, n_cols) f32: the accumulate kernel launched on a zeroed
    accumulator (its launches count on `sti_fill_acc_rect_cuda.launches`)."""
    acc = torch.zeros((ranks_rows.shape[1], ranks_cols.shape[1]),
                      dtype=torch.float32, device=g.device)
    return sti_fill_acc_rect_cuda(acc, g, ranks_rows, ranks_cols)
