// Device code of the STI-KNN fill, shared by `sti_fill.cu` (the standalone
// square and rectangular kernels) and `sti_megakernel.cu` (its update
// phase):
//     acc[a, b] += sum_p g[p, max(r_rows[p, a], r_cols[p, b])]
// on an (nr, nc) block of the accumulator, through the compare-select
// identity g[p, max(r_a, r_b)] = (r_a >= r_b) ? gt_rows[p, a] : gt_cols[p, b]
// with gt[p, i] = g[p, r[p, i]] gathered beforehand for each side and
// packed beside the rank: one 8-byte (rank, gt bits) pair per entry.
//
// Each 128 x 128 tile sums its increment from zero over p = 0, 1, ... in
// order and adds that sum to the accumulator once (the order of the JAX
// acc kernel: the tile's `_tile_sum` added to the seeded output), so every
// caller gets the same bits. Where the rows are a window of the column
// table at a column offset that is a multiple of 128 -- the square fill,
// a row block of the sharded engine -- the (nr, nr) square on the window's
// diagonal is symmetric: for each p the (a, b) and (b, a) terms are the
// same number (equal ranks mean the same train point, so the same gt). So
// only its tiles on and above the diagonal are computed; each adds its sum
// into its own tile and, through shared memory, its transpose into the
// mirror tile below the diagonal. Every accumulator element is read and
// written once. The (rank, gt) pairs of the next test points are copied
// into a three-stage shared-memory ring with cp.async while the current
// ones are computed. Each (pair, point) update is one compare and two
// predicated adds (`add_by_rank`). See `sti_fill.cu` for the design and
// what bounds it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace fill_tile {

constexpr int TILE = 128, MICRO = 8, STRIDE = TILE / MICRO;
constexpr int THREADS = STRIDE * STRIDE;  // 256
// test points per stage, and stages in flight: a stage of 16 points
// computes for ~3500 instructions a thread, longer than its copy takes
// to land, so two stages ahead keep the copies off the critical path and
// let one barrier per stage guard both the copy and the buffer's reuse
constexpr int PCHUNK = 16, STAGES = 3;

// One side of the fill: entry i of test point p is pk[p * ld + i] = (its
// rank, the bits of g gathered at that rank), for i < count.
struct Side {
  const int2* pk;
  int ld, count;
};

// the staging ring during the test-point loop; after it, the transpose of
// a tile's sum on its way to the mirror tile (129 columns, so a warp's
// transposed writes spread over the banks instead of 16 to one bank)
struct Smem {
  union {
    struct {
      int2 rows[PCHUNK][TILE];
      int2 cols[PCHUNK][TILE];
    } stage[STAGES];
    float tr[TILE][TILE + 1];
  };
};

// The tiles a fill walks on an (nr, nc) block, in order. `row_offset` is
// the column of the column table at which the row table starts when the
// rows are a window of it, and -1 when the tables are independent. With
// an offset that is a multiple of TILE, the window's diagonal square
// walks its upper triangle (tile k of row tile i for k = i .. tr - 1, row
// after row) and then every tile outside it; otherwise all tr x tc tiles
// are walked, row after row. `kernels/sti_fill.py::fill_tile_walk` is its
// Python copy, which the tests hold to write each element exactly once.
struct Schedule {
  int tr, tc;     // row and column tiles of the block
  int j0;         // column tile of the window's diagonal; -1: no mirror
  long long tri;  // tiles of the diagonal square's upper triangle

  __host__ __device__ Schedule(int nr, int nc, int row_offset) {
    tr = (nr + TILE - 1) / TILE;
    tc = (nc + TILE - 1) / TILE;
    j0 = row_offset >= 0 && row_offset % TILE == 0 && nr > 0
             ? row_offset / TILE
             : -1;
    tri = j0 >= 0 ? (long long)tr * (tr + 1) / 2 : 0;
  }

  __host__ __device__ long long count() const {
    return j0 >= 0 ? tri + (long long)tr * (tc - tr) : (long long)tr * tc;
  }

  // first tile of row i of the upper triangle
  __host__ __device__ long long row_start(long long i) const {
    return i * tr - i * (i - 1) / 2;
  }

  // Tile L computes row tile i, column tile j; when `mirror`, its
  // transpose also goes to row tile j - j0, column tile j0 + i.
  __host__ __device__ void at(long long L, int& i, int& j,
                              bool& mirror) const {
    mirror = false;
    if (j0 < 0) {
      i = (int)(L / tc);
      j = (int)(L % tc);
      return;
    }
    if (L < tri) {
      const double b = 2.0 * tr + 1.0;
      long long r = (long long)((b - sqrt(b * b - 8.0 * (double)L)) / 2.0);
      while (r > 0 && row_start(r) > L) --r;
      while (r + 1 < tr && row_start(r + 1) <= L) ++r;
      const int k = (int)(r + (L - row_start(r)));
      i = (int)r;
      j = j0 + k;
      mirror = k > i;
      return;
    }
    L -= tri;
    const int w = tc - tr;
    i = (int)(L / w);
    const int c = (int)(L % w);
    j = c < j0 ? c : c + tr;
  }
};

// Starts the copies of test points [p0, p0 + np) of a tile's rows and
// columns into ring stage `st`: thread (pp0, c) = (tid / TILE, tid % TILE)
// copies entry c of test points pp0, pp0 + 2, ... of each side (a warp
// copies 32 neighbouring entries); entries past a side's count are
// zero-filled.
__device__ __forceinline__ void stage_copy(Smem& s, int st, const Side& rows,
                                           const Side& cols, int p0, int np,
                                           int row0, int col0) {
  static_assert(THREADS == 2 * TILE, "two test points per pass");
  const int c = threadIdx.x % TILE, pp0 = threadIdx.x / TILE;
  const bool rok = row0 + c < rows.count, cok = col0 + c < cols.count;
  const int2* r =
      rows.pk + (rok ? (size_t)(p0 + pp0) * rows.ld + row0 + c : 0);
  const int2* q =
      cols.pk + (cok ? (size_t)(p0 + pp0) * cols.ld + col0 + c : 0);
  const size_t rstep = rok ? 2 * (size_t)rows.ld : 0;
  const size_t cstep = cok ? 2 * (size_t)cols.ld : 0;
  uint32_t dr = sm90::smem_u32(&s.stage[st].rows[pp0][c]);
  uint32_t dc = sm90::smem_u32(&s.stage[st].cols[pp0][c]);
#pragma unroll
  for (int k = 0; k < PCHUNK / 2; ++k) {
    if (pp0 + 2 * k < np) {
      sm90::cp_async8(dr, r, rok ? 8u : 0u);
      sm90::cp_async8(dc, q, cok ? 8u : 0u);
    }
    r += rstep;
    q += cstep;
    dr += 2 * TILE * sizeof(int2);
    dc += 2 * TILE * sizeof(int2);
  }
}

// a + (ra >= rb ? ga : gb), rounded once: the compare is the one
// instruction on the ALU pipe, and two predicated adds go to the FMA pipe
// (a select would put a second instruction on the ALU pipe, which issues
// at half the FMA pipe's rate)
__device__ __forceinline__ void add_by_rank(float& a, int ra, int rb,
                                            float ga, float gb) {
  asm("{\n"
      " .reg .pred p;\n"
      " setp.ge.s32 p, %1, %2;\n"
      " @p add.rn.f32 %0, %0, %3;\n"
      " @!p add.rn.f32 %0, %0, %4;\n"
      "}\n"
      : "+f"(a)
      : "r"(ra), "r"(rb), "f"(ga), "f"(gb));
}

// Test point pp of ring stage st into this thread's 8 x 8 micro-tile.
__device__ __forceinline__ void add_point(float (&a)[MICRO][MICRO],
                                          const Smem& s, int st, int pp,
                                          int tx, int ty) {
  int2 cv[MICRO];
#pragma unroll
  for (int j = 0; j < MICRO; ++j)
    cv[j] = s.stage[st].cols[pp][tx + STRIDE * j];
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int2 rv = s.stage[st].rows[pp][ty + STRIDE * i];
#pragma unroll
    for (int j = 0; j < MICRO; ++j)
      add_by_rank(a[i][j], rv.x, cv[j].x, __int_as_float(rv.y),
                  __int_as_float(cv[j].y));
  }
}

// Tile L of `sched` on the (rows.count, cols.count) row-major block `acc`:
// the sum over the t test points of its 128 x 128 increment, from zero,
// added to acc at the tile (and its transpose to the mirror tile). Rows
// past rows.count and columns past cols.count are masked. Calls
// __syncthreads(): every thread of the block must call it.
__device__ __forceinline__ void acc_tile(float* __restrict__ acc,
                                         const Side rows, const Side cols,
                                         int t, const Schedule& sched,
                                         long long L, Smem& s) {
  const int tid = threadIdx.x;
  const int tx = tid % STRIDE, ty = tid / STRIDE;
  const int nr = rows.count, nc = cols.count;
  int ti, tj;
  bool mirror;
  sched.at(L, ti, tj, mirror);
  const int row0 = ti * TILE, col0 = tj * TILE;

  float a[MICRO][MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) a[i][j] = 0.f;

  const int chunks = (t + PCHUNK - 1) / PCHUNK;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks)
      stage_copy(s, c, rows, cols, c * PCHUNK, min(PCHUNK, t - c * PCHUNK),
                 row0, col0);
    sm90::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    // this thread's copies of chunk c have landed; after the barrier
    // everyone's have, and everyone is done with chunk c - 1, whose stage
    // the copy of chunk c + STAGES - 1 now reuses
    sm90::cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = c + STAGES - 1;
    if (nxt < chunks)
      stage_copy(s, nxt % STAGES, rows, cols, nxt * PCHUNK,
                 min(PCHUNK, t - nxt * PCHUNK), row0, col0);
    sm90::cp_async_commit();
    const int st = c % STAGES, np = min(PCHUNK, t - c * PCHUNK);
    if (np == PCHUNK) {  // a full stage, unrolled: loads run ahead of use
#pragma unroll
      for (int pp = 0; pp < PCHUNK; ++pp) add_point(a, s, st, pp, tx, ty);
    } else {
      for (int pp = 0; pp < np; ++pp) add_point(a, s, st, pp, tx, ty);
    }
  }
  __syncthreads();  // the ring is free: the transpose may take it

#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int rr = row0 + ty + STRIDE * i;
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int cc = col0 + tx + STRIDE * j;
      if (rr < nr && cc < nc) {
        float* p = acc + (size_t)rr * nc + cc;
        *p = *p + a[i][j];
      }
    }
  }
  if (!mirror) return;
  // the mirror tile: element (r, c) of it is element (c, r) of this sum
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j)
      s.tr[tx + STRIDE * j][ty + STRIDE * i] = a[i][j];
  __syncthreads();
  const int mrow0 = (tj - sched.j0) * TILE, mcol0 = (sched.j0 + ti) * TILE;
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int rr = mrow0 + ty + STRIDE * i;
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int cc = mcol0 + tx + STRIDE * j;
      if (rr < nr && cc < nc) {
        float* p = acc + (size_t)rr * nc + cc;
        *p = *p + s.tr[ty + STRIDE * i][tx + STRIDE * j];
      }
    }
  }
  __syncthreads();  // the transpose is read: the next tile's copies may go
}

// Tiles first, first + step, ... of `sched`: a block's share of the fill.
__device__ __forceinline__ void fill(float* __restrict__ acc, const Side rows,
                                     const Side cols, int t,
                                     const Schedule& sched, long long first,
                                     long long step, Smem& s) {
  const long long tiles = sched.count();
  for (long long L = first; L < tiles; L += step)
    acc_tile(acc, rows, cols, t, sched, L, s);
}

}  // namespace fill_tile
