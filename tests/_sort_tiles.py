"""A numpy copy of the pass structure of the megakernel's radix sort
(`radix_sort_row` and `radix_pass` in `csrc/sti_megakernel.cu`), for the
CPU tests of the port: the key minimum and the digit histograms read
first, the passes skipped where one bin holds the row, and in each pass
the tile walk, the ranking within a tile (round by round in each warp,
earlier warps by a prefix over their counts), the in-tile reorder and the
write-out at the row's running digit offsets. Constants come from
`repro_torch.kernels.sti_megakernel`, which a test holds to the CUDA
source's."""

import numpy as np

from repro_torch.kernels.sti_megakernel import (
    RADIX_BITS, SORT_KEYS_PER_THREAD, SORT_THREADS, SORT_TILE)

RADIX = 1 << RADIX_BITS
DIGITS = 32 // RADIX_BITS
WARPS = SORT_THREADS // 32
WARP_KEYS = 32 * SORT_KEYS_PER_THREAD


def keys_of(d2):
    """(n,) f32 distances -> int64 sort keys: the f32 bits, -0 made +0."""
    bits = np.ascontiguousarray(d2, np.float32).view(np.uint32).astype(
        np.int64)
    bits[bits == 0x80000000] = 0
    return bits


def _rank_tile(digits):
    """Tile slot -> slot in the tile's digit order, and the per-digit
    counts, as the kernel ranks a tile: `digits` has one entry per slot
    (SORT_TILE of them, -1 past the row's end); slot w WARP_KEYS + 32 i +
    l belongs to warp w, round i, lane l."""
    d = digits.reshape(WARPS, SORT_KEYS_PER_THREAD, 32)
    cnt = np.zeros((WARPS, RADIX), np.int64)
    off = np.zeros_like(d)
    before = np.tril(np.ones((32, 32), bool), -1)  # lane l' < l
    for w in range(WARPS):
        for i in range(SORT_KEYS_PER_THREAD):
            row = d[w, i]
            same = (row[:, None] == row[None, :]) & before
            valid = row >= 0
            off[w, i] = np.where(valid, cnt[w, np.maximum(row, 0)]
                                 + same.sum(1), -1)
            np.add.at(cnt[w], row[valid], 1)
    tot = cnt.sum(0)
    by_warp = np.cumsum(cnt, 0) - cnt  # earlier warps, by digit
    start = np.cumsum(tot) - tot
    slot = np.full(d.shape, -1, np.int64)
    for w in range(WARPS):
        ok = d[w] >= 0
        dw = np.maximum(d[w], 0)
        slot[w] = np.where(ok, start[dw] + by_warp[w, dw] + off[w], -1)
    return slot.reshape(-1), start, tot


def radix_sort_model(d2):
    """The kernel's sort of one row of (n,) f32 distances: (sorted keys
    as int64, the sorted int64 indices, the passes taken)."""
    keys = keys_of(d2)
    n = keys.shape[0]
    lo, hi = int(keys.min()), int(keys.max())
    span = hi - lo
    nd = 0 if span == 0 else -(-span.bit_length() // RADIX_BITS)
    x = keys - lo
    hist = [np.bincount((x >> (RADIX_BITS * q)) & (RADIX - 1),
                        minlength=RADIX) for q in range(nd)]
    todo = [q for q in range(nd) if hist[q].max() != n]
    while len(todo) < 2:  # the first and the last pass: add identities
        todo = sorted(todo + [min(set(range(DIGITS)) - set(todo))])
    k, idx = x.copy(), np.arange(n, dtype=np.int64)
    for q in todo:
        shift = RADIX_BITS * q
        # a digit past the span has no histogram: every key is in bin 0
        run = (np.cumsum(hist[q]) - hist[q] if q < nd
               else np.zeros(RADIX, np.int64))
        out_k, out_i = np.empty_like(k), np.empty_like(idx)
        for t0 in range(0, n, SORT_TILE):
            m = min(SORT_TILE, n - t0)
            digits = np.full(SORT_TILE, -1, np.int64)
            digits[:m] = (k[t0:t0 + m] >> shift) & (RADIX - 1)
            slot, start, tot = _rank_tile(digits)
            assert sorted(slot[:m]) == list(range(m)), "not a permutation"
            tile_k, tile_i = np.empty(m, np.int64), np.empty(m, np.int64)
            tile_k[slot[:m]] = k[t0:t0 + m]
            tile_i[slot[:m]] = idx[t0:t0 + m]
            dig = (tile_k >> shift) & (RADIX - 1)
            g = run[dig] - start[dig] + np.arange(m)
            out_k[g], out_i[g] = tile_k, tile_i
            run = run + tot
        k, idx = out_k, out_i
    return k + lo, idx, len(todo)
