// Device code of the STI-KNN fill, shared by `sti_fill.cu` (the standalone
// kernel) and `sti_megakernel.cu` (its update phase):
//     acc[a, b] += sum_p g[p, max(r[p, row_offset + a], r[p, b])]
// on a (nr, n) row block of the accumulator, through the compare-select
// identity g[p, max(r_a, r_b)] = (r_a >= r_b) ? gt[p, a] : gt[p, b] with
// gt[p, i] = g[p, r[p, i]]. Each element adds the test points in order
// p = 0, 1, ..., so every caller gets the same bits. See `sti_fill.cu` for
// the design and what bounds it.
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

// Adds the t test points into the TILE x TILE tile at local (row0, col0)
// of the (nr, n) row-major block `acc`, whose row a is train point
// row_offset + a. gt and r are (t, n). Rows past nr and columns past n are
// masked. Calls __syncthreads(): every thread of the block must call it.
__device__ __forceinline__ void acc_tile(float* __restrict__ acc,
                                         const float* __restrict__ gt,
                                         const int* __restrict__ r, int t,
                                         int n, int nr, int row_offset,
                                         int row0, int col0, Smem& s) {
  const int tid = threadIdx.x;
  const int tx = tid % STRIDE, ty = tid / STRIDE;

  float a[MICRO][MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int rr = row0 + ty + STRIDE * i;
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int cc = col0 + tx + STRIDE * j;
      a[i][j] = (rr < nr && cc < n) ? acc[(size_t)rr * n + cc] : 0.f;
    }
  }

  for (int p0 = 0; p0 < t; p0 += PCHUNK) {
    const int np = min(PCHUNK, t - p0);
    for (int e = tid; e < PCHUNK * TILE; e += THREADS) {
      const int pp = e / TILE, c = e % TILE;
      int2 rv = make_int2(-1, 0), cv = make_int2(-1, 0);
      if (pp < np) {
        const size_t base = (size_t)(p0 + pp) * n;
        if (row0 + c < nr) {
          const size_t ia = base + row_offset + row0 + c;
          rv = make_int2(r[ia], __float_as_int(gt[ia]));
        }
        if (col0 + c < n)
          cv = make_int2(r[base + col0 + c],
                         __float_as_int(gt[base + col0 + c]));
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
      if (cc < n) acc[(size_t)rr * n + cc] = a[i][j];
    }
  }
}

}  // namespace fill_tile
