// Device code of the STI-KNN fill, shared by `sti_fill.cu` (the standalone
// square and rectangular kernels) and `sti_megakernel.cu` (its update
// phase):
//     acc[a, b] += sum_p g[p, max(r_rows[p, a], r_cols[p, b])]
// on an (nr, nc) block of the accumulator, through the compare-select
// identity g[p, max(r_a, r_b)] = (r_a >= r_b) ? gt_rows[p, a] : gt_cols[p, b]
// with gt[p, i] = g[p, r[p, i]] gathered beforehand for each side. The
// square fill is the case where both sides read the same (t, n) table; a
// row block of the sharded engine reads its rows as a window of that
// table. Each element adds the test points in order p = 0, 1, ..., so
// every caller gets the same bits. See `sti_fill.cu` for the design and
// what bounds it.
#pragma once

#include <cuda_runtime.h>

namespace fill_tile {

constexpr int TILE = 128, MICRO = 8, STRIDE = TILE / MICRO, PCHUNK = 16;
constexpr int THREADS = STRIDE * STRIDE;  // 256

// (rank, gt bits) pairs of PCHUNK test points for a tile's rows and cols
struct Smem {
  int2 rows_s[PCHUNK][TILE];
  int2 cols_s[PCHUNK][TILE];
};

// One side of the fill: entry i of test point p is r[p * ld + i] (its
// rank) and gt[p * ld + i] (g gathered at that rank), for i < count.
struct Side {
  const int* r;
  const float* gt;
  int ld, count;
};

// Adds the t test points into the TILE x TILE tile at (row0, col0) of the
// (rows.count, cols.count) row-major block `acc`. Rows past rows.count and
// columns past cols.count are masked. Calls __syncthreads(): every thread
// of the block must call it.
__device__ __forceinline__ void acc_tile(float* __restrict__ acc,
                                         const Side rows, const Side cols,
                                         int t, int row0, int col0,
                                         Smem& s) {
  const int tid = threadIdx.x;
  const int tx = tid % STRIDE, ty = tid / STRIDE;
  const int nr = rows.count, nc = cols.count;

  float a[MICRO][MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int rr = row0 + ty + STRIDE * i;
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int cc = col0 + tx + STRIDE * j;
      a[i][j] = (rr < nr && cc < nc) ? acc[(size_t)rr * nc + cc] : 0.f;
    }
  }

  for (int p0 = 0; p0 < t; p0 += PCHUNK) {
    const int np = min(PCHUNK, t - p0);
    for (int e = tid; e < PCHUNK * TILE; e += THREADS) {
      const int pp = e / TILE, c = e % TILE;
      int2 rv = make_int2(-1, 0), cv = make_int2(-1, 0);
      if (pp < np) {
        if (row0 + c < nr) {
          const size_t ia = (size_t)(p0 + pp) * rows.ld + row0 + c;
          rv = make_int2(rows.r[ia], __float_as_int(rows.gt[ia]));
        }
        if (col0 + c < nc) {
          const size_t ib = (size_t)(p0 + pp) * cols.ld + col0 + c;
          cv = make_int2(cols.r[ib], __float_as_int(cols.gt[ib]));
        }
      }
      s.rows_s[pp][c] = rv;
      s.cols_s[pp][c] = cv;
    }
    __syncthreads();
    for (int pp = 0; pp < np; ++pp) {
      int2 rv[MICRO], cv[MICRO];
#pragma unroll
      for (int i = 0; i < MICRO; ++i) rv[i] = s.rows_s[pp][ty + STRIDE * i];
#pragma unroll
      for (int j = 0; j < MICRO; ++j) cv[j] = s.cols_s[pp][tx + STRIDE * j];
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MICRO; ++j)
          a[i][j] += (rv[i].x >= cv[j].x) ? __int_as_float(rv[i].y)
                                          : __int_as_float(cv[j].y);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int rr = row0 + ty + STRIDE * i;
    if (rr >= nr) continue;
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int cc = col0 + tx + STRIDE * j;
      if (cc < nc) acc[(size_t)rr * nc + cc] = a[i][j];
    }
  }
}

}  // namespace fill_tile
