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
// pre-pass packs each side once into (t, width) 8-byte (rank, gt bits)
// pairs; the main kernel then copies contiguous runs of them.
//
// What bounds it: instruction issue on the CUDA cores (the compare-select
// identity has no tensor-core form). The increment is symmetric, so the
// function needs one compare, one select and one add per test point for
// each of the n(n+1)/2 pairs on and above the diagonal, and one add per
// element to mirror them (1.65e12 simple operations at t = 256, n = 65536:
// 49 ms at the data-sheet rate of one instruction per lane per clock on an
// H100 SXM); the acc read and write (2 n^2 x 4 bytes, 34 GB) take 10 ms at
// 3.35 TB/s. A row block (n/D, n) of the sharded engine is symmetric only
// in its (n/D, n/D) square on the diagonal: 3 t operations for each
// element outside it and for each pair on and above its diagonal (21.5 ms
// for the (16384, 65536) block of D = 4 at t = 256). The kernel's own
// instruction stream is ~3.6 per (pair, point) update -- a compare on the
// ALU pipe, two predicated adds on the FMA pipe, a quarter of a
// shared-memory load, and the staging -- so issue caps it near 36 updates
// per SM per clock; on an H100 SXM (700 W, 1980 MHz) it runs at ~30: the
// square at t = 256, n = 65536 in 69.5 ms, 71 % of the bound above.
//
// The design (`fill_tile.cuh`, which the megakernel's update phase runs
// too): each 256-thread block owns a 128 x 128 tile of acc in registers
// (an 8 x 8 micro-tile per thread, strided by 16 so a warp's shared-memory
// reads are conflict-free) and sums the tile's increment from zero over
// p = 0, 1, ... in order, then adds the sum to acc once: the JAX acc
// kernel's order, so the result is bit-equal to the plain version, and
// the tile at (a, b) and its transpose at (b, a) are the same numbers.
// Where the rows are a window of the column table at a multiple of 128
// (the square: offset 0), only the tiles on and above the window's
// diagonal are computed -- T(T+1)/2 of the square's T^2, T = ceil(n/128)
// -- and each also adds its transpose, through shared memory, into the
// mirror tile; each acc element is still read once and written once (the
// in-place update that replaces `input_output_aliases`). The rect entry
// learns from its wrapper whether the row table is such a window (and at
// which offset) or an independent table, which computes every tile. The
// (rank, gt) pairs of 16 test points at a time stream through a
// three-stage shared-memory ring by cp.async, two stages ahead of the
// compute, so no barrier waits on device memory in the steady loop; a
// full stage is unrolled, so each point's shared-memory loads run ahead
// of its adds, and two blocks share an SM. Ragged edges (nr, nc, t not
// multiples of the tile or stage) are masked. The square and rectangular
// entry points launch the same kernel, so a row block of the sharded
// engine gets the bits of the same rows of the square fill.
#include <cuda_runtime.h>

#include "fill_tile.cuh"

namespace {

using fill_tile::Side;
using fill_tile::THREADS;

// pk[p * w + i] = (r[p * ld + i], bits of g[p * n + min(max(r, 0), n - 1)])
// for i < w, from int64 ranks as torch makes them (no int32 copy of the
// table): out-of-range ranks are clamped for the gather as XLA's gather
// clamps them, so a bad rank cannot read out of bounds.
__global__ void pack_kernel(const float* __restrict__ g,
                            const long long* __restrict__ r,
                            int2* __restrict__ pk, int t, int n, int w,
                            int ld) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)t * w) return;
  const size_t p = i / w;
  const long long rk = r[p * ld + i % w];
  const long long at = rk < 0 ? 0 : (rk < n ? rk : n - 1);
  pk[i] = make_int2((int)rk, __float_as_int(g[p * n + at]));
}

// two blocks per SM: 16 warps hide the loop's latencies (~120 registers
// a thread, 96 KB of shared memory a block)
__global__ void __launch_bounds__(THREADS, 2)
fill_acc_kernel(float* __restrict__ acc, const Side rows, const Side cols,
                int t, const fill_tile::Schedule sched) {
  extern __shared__ unsigned char smem_raw[];
  fill_tile::fill(acc, rows, cols, t, sched, blockIdx.x, gridDim.x,
                  *reinterpret_cast<fill_tile::Smem*>(smem_raw));
}

void pack(const float* g, const long long* r, int2* pk, int t, int n, int w,
          int ld, cudaStream_t s) {
  const size_t total = (size_t)t * w;
  const int block = 256;
  pack_kernel<<<(unsigned)((total + block - 1) / block), block, 0, s>>>(
      g, r, pk, t, n, w, ld);
}

// one block per tile of the schedule (a grid-stride walk past 2^31 - 1)
int fill(float* acc, const Side& rows, const Side& cols, int t,
         int row_offset, cudaStream_t s) {
  const fill_tile::Schedule sched(rows.count, cols.count, row_offset);
  const long long tiles = sched.count();
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  const int bytes = (int)sizeof(fill_tile::Smem);
  const cudaError_t e = cudaFuncSetAttribute(
      fill_acc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = (unsigned)(tiles < 0x7fffffffll ? tiles : 0x7fffffff);
  fill_acc_kernel<<<grid, THREADS, bytes, s>>>(acc, rows, cols, t, sched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. All pointers are device pointers;
// `stream` is a cudaStream_t. Each returns a cudaError_t (0 = launched).

// Square form: acc (n, n) f32, g (t, n) f32, r (t, n) int64 and pk (t, n)
// int32 pairs of scratch. acc is updated in place.
extern "C" int sti_fill_acc_f32(float* acc, const float* g,
                                const long long* r,
                                int2* pk, int t, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pack(g, r, pk, t, n, n, n, s);
  const Side side{pk, n, n};
  return fill(acc, side, side, t, 0, s);
}

// Rectangular form: acc (nr, nc) f32 updated in place, g (t, n) f32,
// r_cols (t, nc) int64 contiguous and pk_cols (t, nc) int32 pairs of
// scratch. With row_offset >= 0 the row table is the window of r_cols at
// that column (row_offset + nr <= nc), and r_rows and pk_rows are not
// read. With row_offset = -1 the tables are independent: row a of test
// point p reads r_rows[p * ld_rows + a], and pk_rows is a (t, nr) scratch
// of int32 pairs; g is then gathered for each side on its own. Every rank
// must be < n.
extern "C" int sti_fill_acc_rect_f32(float* acc, const float* g,
                                     const long long* r_rows,
                                     const long long* r_cols,
                                     int2* pk_rows, int2* pk_cols, int t,
                                     int n, int nr, int nc, int ld_rows,
                                     int row_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_offset >= 0 && row_offset + nr > nc)
    return static_cast<int>(cudaErrorInvalidValue);
  pack(g, r_cols, pk_cols, t, n, nc, nc, s);
  Side rows{pk_cols + (row_offset >= 0 ? row_offset : 0), nc, nr};
  if (row_offset < 0) {
    pack(g, r_rows, pk_rows, t, n, nr, ld_rows, s);
    rows = Side{pk_rows, nr, nr};
  }
  return fill(acc, rows, Side{pk_cols, nc, nc}, t, row_offset, s);
}

// The number of tiles the fill computes on an (nr, nc) block whose rows
// are the window at `row_offset` of the column table (-1: independent
// tables), out of ceil(nr/128) * ceil(nc/128). Host code, for reports.
extern "C" long long sti_fill_tiles(int nr, int nc, int row_offset) {
  return fill_tile::Schedule(nr, nc, row_offset).count();
}
