// The STI-KNN O(t n^2) accumulation (the hot loop), for sm_90a.
//
// Replaces the Pallas TPU kernels `sti_fill_acc_pallas` and
// `sti_fill_pallas` (src/repro/kernels/sti_fill.py, bodies `_acc_kernel`,
// `_kernel`, `_tile_sum`):
//     acc[a, b] += sum_p g[p, max(r[p, a], r[p, b])]
// in place on a live (n, n) f32 accumulator (or a zeroed one, for the
// zero-init form).
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
// result equals a sequential f32 sum. Ragged edges (n not a multiple of
// 128) are masked on load and store. Computing only the tiles on and
// above the diagonal would halve the work; it is not done yet. The tile
// code lives in `fill_tile.cuh`, which the megakernel's update phase
// shares.
#include <cuda_runtime.h>

#include "fill_tile.cuh"

namespace {

using fill_tile::THREADS;
using fill_tile::TILE;

// gt[p, a] = g[p, min(r[p, a], n - 1)]; out-of-range ranks are clamped as
// XLA's gather clamps them, so a bad rank cannot read out of bounds.
__global__ void gather_g_kernel(const float* __restrict__ g,
                                const int* __restrict__ r,
                                float* __restrict__ gt, int t, int n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)t * n) return;
  const size_t p = i / n;
  const int rk = min(max(r[i], 0), n - 1);
  gt[i] = g[p * n + rk];
}

__global__ void __launch_bounds__(THREADS)
fill_acc_kernel(float* __restrict__ acc, const float* __restrict__ gt,
                const int* __restrict__ r, int t, int n) {
  __shared__ fill_tile::Smem s;
  fill_tile::acc_tile(acc, gt, r, t, n, n, 0, blockIdx.y * TILE,
                      blockIdx.x * TILE, s);
}

}  // namespace

// C interface, loaded with ctypes. acc (n, n) f32, g (t, n) f32, r (t, n)
// int32 and gt (t, n) f32 scratch are device pointers; `stream` is a
// cudaStream_t. acc is updated in place. Returns cudaGetLastError().
extern "C" int sti_fill_acc_f32(float* acc, const float* g, const int* r,
                                float* gt, int t, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)t * n;
  const int block = 256;
  gather_g_kernel<<<(unsigned)((total + block - 1) / block), block, 0, s>>>(
      g, r, gt, t, n);
  dim3 grid((n + TILE - 1) / TILE, (n + TILE - 1) / TILE);
  fill_acc_kernel<<<grid, THREADS, 0, s>>>(acc, gt, r, t, n);
  return static_cast<int>(cudaGetLastError());
}
