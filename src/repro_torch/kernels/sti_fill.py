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

Every form sums the increment from zero over the test points in order
and adds that sum to the accumulator once (`add_tile_sum`), the order of
the JAX acc kernel, in the kernel and the plain versions alike. The sum
is symmetric, so where the row table is a window of the column table the
kernel computes only the upper tiles of the window's diagonal square and
mirrors them (`fill_tile_walk` is a copy of its tile walk). The design
notes (why the TPU kernel's VMEM-resident g block does not carry over,
the compare-select identity used instead, the mirror and the staging)
are at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import library
from repro_torch.launch.hlo_analysis import (
    KERNELS, fill_cost, rect_fill_cost)

__all__ = [
    "TILE",
    "add_tile_sum",
    "fill_tile_walk",
    "row_window",
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


# the kernel's output tile edge (`fill_tile::TILE`)
TILE = 128

# elements of a row block's temporaries in the plain sum (its sum, one
# test point's term and their compare): 2^28, 1 GiB of f32 each
_PLAIN_BLOCK_ELEMENTS = 1 << 28


def add_tile_sum(acc: torch.Tensor, r_rows: torch.Tensor,
                 g_rows: torch.Tensor, r_cols: torch.Tensor,
                 g_cols: torch.Tensor) -> torch.Tensor:
    """acc += S in place, S[a, b] = sum_p (r_rows[p, a] >= r_cols[p, b]
    ? g_rows[p, a] : g_cols[p, b]) summed from zero over p = 0, 1, ... in
    order: the order of the JAX acc kernel (`_tile_sum` added to the
    seeded output) and of the CUDA fill, whatever acc held. `g_*` are g
    gathered at each side's ranks. Row blocks bound the temporaries."""
    nr, nc = acc.shape
    step = max(1, _PLAIN_BLOCK_ELEMENTS // max(nc, 1))
    for r0 in range(0, nr, step):
        rr, gr = r_rows[:, r0:r0 + step], g_rows[:, r0:r0 + step]
        s = torch.zeros_like(acc[r0:r0 + step])
        for p in range(r_rows.shape[0]):
            s.add_(torch.where(rr[p, :, None] >= r_cols[p, None, :],
                               gr[p, :, None], g_cols[p, None, :]))
        acc[r0:r0 + step].add_(s)
    return acc


def sti_fill_acc_plain(acc: torch.Tensor, g: torch.Tensor,
                       ranks: torch.Tensor) -> torch.Tensor:
    """acc[a, b] += sum_p g[p, max(ranks[p, a], ranks[p, b])], in place,
    through the compare-select identity
    g[p, max(r_a, r_b)] = (r_a >= r_b) ? g[p, r_a] : g[p, r_b],
    the sum over p taken from zero and then added (`add_tile_sum`)."""
    r = ranks.long()
    gt = torch.gather(g.to(torch.float32), 1, r)
    return add_tile_sum(acc, r, gt, r, gt)


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
    launch the kernel (or raise). The kernel reads int64 ranks, as torch's
    gather and scatter make them, in place (other types are cast). Meta
    tensors in the dry run (`KERNELS.counting()`) add the kernel's cost
    to `hlo_analysis.KERNELS` and return `acc`.
    `sti_fill_acc_cuda.launches` counts kernel launches."""
    if all(x.device.type == "cpu" for x in (acc, g, ranks)):
        return sti_fill_acc_plain(acc, g, ranks)
    _check(acc, g, ranks)
    t, n = g.shape
    if acc.device.type == "meta" and KERNELS.active:
        KERNELS.add("sti_fill_acc", fill_cost(t, n))
        return acc
    if t == 0 or n == 0:
        return acc
    r64 = ranks.to(torch.int64).contiguous()
    pk = _pairs(t, n, acc.device)
    _launch("sti_fill_acc_f32", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2,
            acc.data_ptr(), g.data_ptr(), r64.data_ptr(), pk.data_ptr(), t,
            n, dev=acc.device)
    sti_fill_acc_cuda.launches += 1
    return acc


sti_fill_acc_cuda.launches = 0


def _pairs(t: int, w: int, dev) -> torch.Tensor:
    """Scratch for one side's packed (rank, gt bits) table: (t, w) pairs
    of int32, in place of a gathered (t, w) g."""
    return torch.empty((t, w, 2), dtype=torch.int32, device=dev)


def _launch(fn_name: str, argtypes: list, *args, dev) -> None:
    """Call `csrc/sti_fill.cu`'s C entry `fn_name` on the current stream
    of `dev`; raises on a refused or failed launch."""
    fn = getattr(library("sti_fill"), fn_name)
    fn.argtypes = argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {rc}")


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
    in place, through the compare-select identity, the sum over p taken
    from zero and then added, as `sti_fill_acc_plain` does for the
    square."""
    g = g.to(torch.float32)
    rr, rc = ranks_rows.long(), ranks_cols.long()
    return add_tile_sum(acc, rr, torch.gather(g, 1, rr), rc,
                        torch.gather(g, 1, rc))


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


def row_window(ranks_rows: torch.Tensor, ranks_cols: torch.Tensor) -> int:
    """The column of `ranks_cols` at which `ranks_rows` is a window of it
    (`rect_row_view`): both are views of one storage with the same dtype
    and strides, rows of unit stride at least n_cols apart, and the
    storage offsets differ by 0 <= off <= n_cols - n_rows. Else -1: the
    tables are taken as independent."""
    nr, nc = ranks_rows.shape[-1], ranks_cols.shape[-1]
    if (ranks_rows.ndim != 2 or ranks_cols.ndim != 2
            or ranks_rows.dtype != ranks_cols.dtype
            or ranks_rows.shape[0] != ranks_cols.shape[0]
            or ranks_rows.stride() != ranks_cols.stride()
            or ranks_cols.stride(1) != 1
            or (ranks_cols.shape[0] > 1 and ranks_cols.stride(0) < nc)):
        return -1
    if (ranks_rows.untyped_storage()._cdata
            != ranks_cols.untyped_storage()._cdata):
        return -1
    off = ranks_rows.storage_offset() - ranks_cols.storage_offset()
    return off if 0 <= off <= nc - nr else -1


def fill_tile_walk(n_rows: int, n_cols: int, row_offset: int):
    """The kernel's tile walk (`fill_tile::Schedule` in
    `csrc/fill_tile.cuh`), in its order: one (row tile, column tile,
    mirror tile or None) per tile the kernel computes on an (n_rows,
    n_cols) block whose rows are the window at column `row_offset` of the
    column table (-1: independent tables). With an offset that is a
    multiple of TILE the window's diagonal square walks its upper triangle
    and mirrors each tile above the diagonal into (k, j0 + i); every other
    tile is computed where it lies."""
    tr, tc = -(-n_rows // TILE), -(-n_cols // TILE)
    j0 = (row_offset // TILE if row_offset >= 0 and row_offset % TILE == 0
          and n_rows > 0 else -1)
    if j0 < 0:
        for L in range(tr * tc):
            yield L // tc, L % tc, None
        return
    tri = tr * (tr + 1) // 2

    def start(i):
        return i * tr - i * (i - 1) // 2

    b = 2.0 * tr + 1.0
    for L in range(tri):
        i = int((b - math.sqrt(b * b - 8.0 * L)) / 2.0)
        while i > 0 and start(i) > L:
            i -= 1
        while i + 1 < tr and start(i + 1) <= L:
            i += 1
        k = i + (L - start(i))
        yield i, j0 + k, ((k, j0 + i) if k > i else None)
    w = tc - tr
    for L in range(tr * w):
        i, c = divmod(L, w)
        yield i, (c if c < j0 else c + tr), None


def sti_fill_acc_rect_cuda(acc: torch.Tensor, g: torch.Tensor,
                           ranks_rows: torch.Tensor,
                           ranks_cols: torch.Tensor) -> torch.Tensor:
    """acc[a, b] += sum_p g[p, max(ranks_rows[p, a], ranks_cols[p, b])] in
    place on the (n_rows, n_cols) block; returns `acc`. g is (t, n) and
    every rank is < n. CPU tensors take `sti_fill_acc_rect_plain`; CUDA
    tensors launch the kernel (or raise). A row table that is a window of
    the column table (`row_window`, decided before a cast, which would
    copy) is read from the column table at its offset, and the kernel
    mirrors the window's diagonal square; otherwise g is gathered for
    each side on its own. The kernel reads int64 tables, as torch's
    gather and scatter make them, in place (other types are cast). Meta
    tensors in the dry run (`KERNELS.counting()`) add the kernel's cost
    to `hlo_analysis.KERNELS` and return `acc`.
    `sti_fill_acc_rect_cuda.launches` counts kernel launches."""
    if all(x.device.type == "cpu" for x in (acc, g, ranks_rows, ranks_cols)):
        return sti_fill_acc_rect_plain(acc, g, ranks_rows, ranks_cols)
    _check_rect(acc, g, ranks_rows, ranks_cols)
    (t, n), nr, nc = g.shape, ranks_rows.shape[1], ranks_cols.shape[1]
    if acc.device.type == "meta" and KERNELS.active:
        KERNELS.add("sti_fill_acc_rect", rect_fill_cost(t, nr, nc))
        return acc
    if t == 0 or nr == 0 or nc == 0:
        return acc
    off = row_window(ranks_rows, ranks_cols)
    rc64 = ranks_cols.to(torch.int64).contiguous()
    pk_cols = _pairs(t, nc, acc.device)
    rr64 = pk_rows = None
    if off < 0:
        rr64 = ranks_rows.to(torch.int64)
        if rr64.stride(1) != 1:
            rr64 = rr64.contiguous()
        pk_rows = _pairs(t, nr, acc.device)
    _launch("sti_fill_acc_rect_f32",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6,
            acc.data_ptr(), g.data_ptr(),
            None if rr64 is None else rr64.data_ptr(), rc64.data_ptr(),
            None if pk_rows is None else pk_rows.data_ptr(),
            pk_cols.data_ptr(), t, n, nr, nc,
            nr if rr64 is None else rr64.stride(0), off, dev=acc.device)
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
