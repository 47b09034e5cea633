// The STI-KNN O(t n^2) accumulation (the hot loop), for sm_90a.
//
// Replaces the Pallas TPU kernels `sti_fill_acc_pallas`, `sti_fill_pallas`,
// `sti_fill_acc_rect_pallas` and `sti_fill_rect_pallas`
// (src/repro/kernels/sti_fill.py, bodies `_acc_kernel`, `_kernel`,
// `_tile_sum`, wrapper `_rect_call`):
//     acc[a, b] += sum_p g[p, max(r_rows[p, a], r_cols[p, b])]
// in place on a live (nr, nc) f32 accumulator (or a zeroed one, for the
// zero-init forms). The square fill is r_rows = r_cols = r, (n, n); the
// sharded engine's row block is r_cols = r and r_rows its window of the
// block's n/D rows, (n/D, n).
//
// The TPU design keeps a (TB, n) block of g in VMEM and gathers from it.
// At n = 65536 one g row is 256 KB, more than a block's 227 KB of shared
// memory, so that design does not carry over. This kernel uses the
// identity behind the JAX `_chunked_one` fill instead:
//     g[p, max(r_a, r_b)] = (r_a >= r_b) ? g[p, r_a] : g[p, r_b]
// so an output tile needs, per test point, only the ranks of its rows and
// columns and g gathered at those ranks: gt[p, a] = g[p, r[p, a]]. A
// pre-pass writes gt (t, n) once; the main kernel then reads contiguous
// (rank, gt) pairs.
//
// What bounds it here: instruction issue. The increment is symmetric, so
// the function needs one compare, one select and one add per test point
// for each of the n(n+1)/2 pairs on and above the diagonal (1.65e12
// simple operations at t = 256, n = 65536, 49 ms at ~3.35e13/s on an
// H100 SXM); the acc read and write (2 n^2 x 4 bytes, 34 GB) take 10 ms
// at 3.35 TB/s. This kernel computes all n^2 pairs, twice that work. It
// spends nothing per element beyond the three operations: each 256-thread
// block owns a 128 x 128 tile of acc in registers (an 8 x 8 micro-tile per
// thread, strided by 16 so a warp's shared-memory reads are
// conflict-free), reads and writes that tile once per call -- the
// in-place update that replaces
// `input_output_aliases` -- and stages the (rank, gt) pairs of 16 test
// points at a time for its 128 rows and 128 columns in shared memory.
// Each acc element adds the test points in order p = 0, 1, ..., so the
// result equals a sequential f32 sum. Ragged edges (nr, nc not multiples
// of 128) are masked on load and store. Computing only the tiles on and
// above the diagonal would halve the square fill's work; it is not done
// yet. A row block (n/D, n) of the sharded engine is symmetric only in
// its (n/D, n/D) block on the diagonal: its bound is 3 t operations for
// each element outside that block and for each pair on and above its
// diagonal (21.5 ms for the (16384, 65536) block of D = 4 at t = 256),
// and its acc read and write 2 nr nc x 4 bytes. The
// tile code lives in `fill_tile.cuh`, which the megakernel's update phase
// shares; the square and rectangular entry points launch the same kernel,
// so a row block of the sharded engine gets the bits of the same rows of
// the square fill.
#include <cuda_runtime.h>

#include "fill_tile.cuh"

namespace {

using fill_tile::Side;
using fill_tile::THREADS;
using fill_tile::TILE;

// gt[p * ld + i] = g[p * n + min(max(r[p * ld + i], 0), n - 1)] for
// i < w: out-of-range ranks are clamped as XLA's gather clamps them, so a
// bad rank cannot read out of bounds.
__global__ void gather_g_kernel(const float* __restrict__ g,
                                const int* __restrict__ r,
                                float* __restrict__ gt, int t, int n, int w,
                                int ld) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)t * w) return;
  const size_t p = i / w, j = p * ld + i % w;
  const int rk = min(max(r[j], 0), n - 1);
  gt[j] = g[p * n + rk];
}

__global__ void __launch_bounds__(THREADS)
fill_acc_kernel(float* __restrict__ acc, const Side rows, const Side cols,
                int t) {
  __shared__ fill_tile::Smem s;
  fill_tile::acc_tile(acc, rows, cols, t, blockIdx.y * TILE,
                      blockIdx.x * TILE, s);
}

void gather(const float* g, const int* r, float* gt, int t, int n, int w,
            int ld, cudaStream_t s) {
  const size_t total = (size_t)t * w;
  const int block = 256;
  gather_g_kernel<<<(unsigned)((total + block - 1) / block), block, 0, s>>>(
      g, r, gt, t, n, w, ld);
}

void fill(float* acc, const Side& rows, const Side& cols, int t,
          cudaStream_t s) {
  dim3 grid((cols.count + TILE - 1) / TILE, (rows.count + TILE - 1) / TILE);
  fill_acc_kernel<<<grid, THREADS, 0, s>>>(acc, rows, cols, t);
}

}  // namespace

// C interface, loaded with ctypes. All pointers are device pointers;
// `stream` is a cudaStream_t. Each returns cudaGetLastError().

// Square form: acc (n, n) f32, g (t, n) f32, r (t, n) int32 and gt (t, n)
// f32 scratch. acc is updated in place.
extern "C" int sti_fill_acc_f32(float* acc, const float* g, const int* r,
                                float* gt, int t, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather(g, r, gt, t, n, n, n, s);
  const Side side{r, gt, n, n};
  fill(acc, side, side, t, s);
  return static_cast<int>(cudaGetLastError());
}

// Rectangular form: acc (nr, nc) f32 updated in place, g (t, n) f32,
// r_cols (t, nc) int32 and gt_cols (t, nc) f32 scratch, both contiguous;
// row a of test point p reads r_rows[p * ld_rows + a], and gt_rows is a
// scratch of the same layout. g is gathered for each side on its own.
// Every rank must be < n.
extern "C" int sti_fill_acc_rect_f32(float* acc, const float* g,
                                     const int* r_rows, const int* r_cols,
                                     float* gt_rows, float* gt_cols, int t,
                                     int n, int nr, int nc, int ld_rows,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather(g, r_rows, gt_rows, t, n, nr, ld_rows, s);
  gather(g, r_cols, gt_cols, t, n, nc, nc, s);
  fill(acc, Side{r_rows, gt_rows, ld_rows, nr}, Side{r_cols, gt_cols, nc, nc},
       t, s);
  return static_cast<int>(cudaGetLastError());
}
