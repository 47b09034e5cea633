"""A numpy copy of what the CUDA fill does on each tile of its walk
(`repro_torch.kernels.sti_fill.fill_tile_walk`), for the CPU tests of the
port's fills: the writes it makes, and the values it writes."""

import numpy as np

from repro_torch.kernels.sti_fill import TILE, fill_tile_walk


def _spans(i, j, nr, nc):
    """The valid rows and columns of tile (i, j) of an (nr, nc) block."""
    return (slice(i * TILE, min((i + 1) * TILE, nr)),
            slice(j * TILE, min((j + 1) * TILE, nc)))


def write_counts(nr, nc, row_offset):
    """(number of tiles walked, (nr, nc) count of the writes each element
    takes): a tile writes its valid elements, and its mirror tile's."""
    counts = np.zeros((nr, nc), np.int32)
    tiles = 0
    for i, j, mirror in fill_tile_walk(nr, nc, row_offset):
        tiles += 1
        counts[_spans(i, j, nr, nc)] += 1
        if mirror is not None:
            counts[_spans(*mirror, nr, nc)] += 1
    return tiles, counts


def emulate_fill(acc, g, r_rows, r_cols, row_offset):
    """acc (nr, nc) f32 after the kernel's walk, in place: each tile sums
    its increment from zero over p in order, adds the sum to its own tile
    and its transpose to its mirror tile. `row_offset` is what the wrapper
    passes (-1 for independent tables)."""
    nr, nc = acc.shape
    gr = np.take_along_axis(g, r_rows, axis=1)
    gc = np.take_along_axis(g, r_cols, axis=1)
    for i, j, mirror in fill_tile_walk(nr, nc, row_offset):
        rows, cols = _spans(i, j, nr, nc)
        s = np.zeros((rows.stop - rows.start, cols.stop - cols.start),
                     np.float32)
        for p in range(g.shape[0]):
            s += np.where(r_rows[p, rows, None] >= r_cols[p, None, cols],
                          gr[p, rows, None], gc[p, None, cols])
        acc[rows, cols] = acc[rows, cols] + s
        if mirror is not None:
            mrows, mcols = _spans(*mirror, nr, nc)
            st = s.T[:mrows.stop - mrows.start, :mcols.stop - mcols.start]
            acc[mrows, mcols] = acc[mrows, mcols] + st
    return acc
