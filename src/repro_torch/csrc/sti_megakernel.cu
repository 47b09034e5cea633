// The fused valuation step: distance -> full-width stable sort -> method
// tables -> accumulator update, in ONE launch per step, for sm_90a.
//
// Replaces the Pallas TPU kernels `sti_megakernel` and `point_megakernel`
// (src/repro/kernels/sti_megakernel.py, bodies `_interaction_kernel`,
// `_point_kernel`, `_stream_sorted`, `merge_sorted_tile`, `_ranks_of`,
// `_pack_tables`, `_gather_sum`). For one batch of tb test points against
// n train points, with r[p, i] the stable rank of train point i under test
// point p (ties by index) and the method's tables in sorted coordinates:
//   sti / sii:  acc[a, b] += sum_p g[p, max(r[p, off + a], r[p, b])],
//               diag[a]   += sum_p u[p, r[p, off + a]]
//   points:     vec[a]    += sum_p vals[p, r[p, off + a]]
// on the (nr, n) / (nr,) row block whose row a is train point off + a
// (off = row_offset; the whole square when off = 0 and nr = n).
//
// The TPU kernel merges one train tile at a time into a running sorted
// (d2, index) stream held in VMEM. At n = 65536 one such row is 512 KB of
// keys, more than a block's 227 KB of shared memory, so that design does
// not carry over. Here one persistent cooperative kernel (one 256-thread
// block per SM: the distance phase takes 160 KB of dynamic shared memory;
// started with cudaLaunchCooperativeKernel) runs the phases with
// grid-wide barriers between them, its (tb, n) tables in global scratch
// that the wrapper allocates:
//   0. row squared norms of the batch and of x_train (a warp per row);
//   1. distance tiles of 128 train by 256 test points (`distance_tile.cuh`:
//      `block_tile`, the k-step function and epilogue of `distance.cu`
//      on the tensor cores, 3xTF32 `wgmma` for f32, so f32 distances are
//      bit-equal to `distance_cuda`; the block's two warpgroups stage each
//      k-step themselves, double-buffered, with no producer), written as
//      sort keys: the f32 bits of the clamped, non-negative d2, -0 made +0;
//   2. per test row (a block each): a stable LSD radix sort by (key,
//      index), the order of torch.sort(stable=True), i.e. of
//      `merge_sorted_tile`. Two reads of the row give the keys' minimum
//      and maximum, then the 256-bin histogram of each 8-bit digit of
//      key - min; a digit that one bin holds whole (every digit above the
//      span's top bit) is skipped, since a stable pass by it is the
//      identity (down to two passes: the first reads phase 1's keys, the
//      last writes the sorted keys and indices as rows; the passes between
//      move (key, index) pairs, one 8-byte store an element). Each pass
//      walks the row in tiles of 4096 keys, 16 a thread: cp.async stages
//      the next tile while this one is ranked in shared memory (a warp
//      matches the digits of 8 rounds at once by atomicOr into per-round
//      match words, counts rounds in order in its own counters, a block
//      scan orders the warps), reordered there by digit and written out as
//      contiguous runs at the row's running digit offsets: 5 barriers a
//      tile, where one key a thread took 4 barriers per 256 keys;
//   3. per test row, same block: the method's table along the sorted
//      stream (sti/sii: u = match*mask/k and the superdiagonal_g suffix
//      recurrence; knn_shapley/wknn: the knn_shapley_from_sorted suffix
//      recurrence, wknn's distance weights on the sorted d2 with a block
//      reduction for the rbf row mean over d2 < 1e20; loo: the window
//      delta), scattered to train coordinates with the ranks -- for
//      sti/sii g as (rank, g) pairs packed for the fill. A tile of 4096
//      positions stages ord by cp.async, gathers ytr[ord] once a position
//      into shared memory and scans its 16 chunks of 256 positions, each
//      chunk's warp sums and carry formed once for the tile, in the
//      summation order of one chunk at a time;
//   4. the update: one thread per accumulator row for diag / vec (test
//      points added in order, no atomics), and for sti/sii the fill
//      (`fill_tile.cuh`, the code of `sti_fill.cu`) over the row block,
//      its tiles shared out over the blocks. The rows are the window of
//      the (rank, g) table at row_offset, so at a row_offset that is a
//      multiple of 128 (the whole square included) only the upper
//      triangle of the block's (nr, nr) square on the diagonal is
//      computed and mirrored into the lower one; elsewhere every tile.
// acc and diag / vec are updated in place, which replaces the Pallas
// kernel's input_output_aliases. With compute_dtype bf16 only the cross
// term's operands are rounded to bf16 (f32 accumulate, one bf16 `wgmma`
// pass); the norms come from the f32 inputs, as in the TPU kernel.
//
// What bounds it (t = 256, n = 65536, d = 768): for sti/sii the fill, as
// for `sti_fill.cu` (3 t n(n+1)/2 + n^2 simple operations, 49 ms at the
// data-sheet instruction rate; the kernel computes the n(n+1)/2 pairs of
// the upper tiles and mirrors them, as the function needs, but its tile
// runs at this grid's one block, 8 warps, per SM, where the standalone
// fill runs two); for the point methods the bytes of x_train and the
// batch (0.061 ms at 3.35 TB/s; the distance's three TF32 products take
// 0.156 ms at 495 TFLOP/s). The sort is O(t n) and moves, per row,
// 4 n bytes for each prologue read, 12 n for the first pass and 16 n for
// each later one: 0.26 ms over the card at three passes a row, 0.34 at
// four; it takes about twice that, bound by latency at 8 warps an SM. One
// block a row is kept: 256 rows on 132 SMs is two waves, and a row split
// over blocks would need a grid-wide digit scan between passes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "distance_tile.cuh"
#include "fill_tile.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(THREADS == 2 * dist_tile::WG && THREADS == fill_tile::THREADS,
              "the shared tiles run on the megakernel's block");

// what phase 3 computes (kept in step with kernels/sti_megakernel.py)
enum Kind : int {
  RANK_ONLY = 0,  // phases 0-2 only: the sorted stream, for diagnostics
  STI = 1,
  SII = 2,
  KNN_SHAPLEY = 3,
  WKNN_RBF = 4,
  WKNN_INVERSE = 5,
  WKNN_UNIFORM = 6,
  LOO = 7,
};

struct Params {
  float* acc;          // (nr, n) row block; sti/sii only
  float* vec;          // (nr,) diag (sti/sii) or values (point methods)
  const float* xb;     // (tb, d) test batch
  const int* yb;       // (tb,)
  const float* mask;   // (tb,) 1 for real test points, 0 for padding
  const float* xtr;    // (n, d)
  const int* ytr;      // (n,)
  float* norms;        // (tb + n,): batch norms, then train norms
  float* coef;         // (n,) step_coef at each sorted position, or null
  uint32_t* keys_a;    // (tb, n) sort keys from phase 1; sorted after phase 2
  int* idx_a;          // (tb, n) train indices; sorted after phase 2
  uint2* pairs_b;      // (tb, n) (key, index) pairs between radix passes
  uint2* pairs_c;      // (tb, n) the same, the other buffer
  int* passes;         // (tb,) radix passes each row took, or null
  int2* pk;            // (tb, n) over pairs_b: (rank, g bits), sti/sii
  float* tab;          // (tb, 2 n) over pairs_c, first n of a row: values
  float* ut;           // (tb, 2 n) over pairs_c, first n of a row: u
  int tb, n, d, nr, row_offset, k, kind, bf16;
};

// ------------------------------------------------------------- the sort
// A stable LSD radix sort of one row by one block. It walks the row in
// tiles of TILE keys (KPT a thread): each tile is staged by cp.async into
// shared memory while the one before it is ranked, ranked there by its
// digit, reordered in place so that each digit's run is contiguous, and
// written out coalesced at the row's running digit offsets. With one
// block of 8 warps an SM, latency is what costs: each step issues all of
// a thread's KPT loads, atomics or stores before it waits on any.
constexpr int RADIX_BITS = 8;             // 8-bit digits, 256 bins
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int DIGITS = 32 / RADIX_BITS;   // digit positions of a 32-bit key
constexpr int KPT = 16;                   // keys a thread ranks per tile
constexpr int TILE = THREADS * KPT;       // 4096 keys a tile
constexpr int WARP_KEYS = 32 * KPT;       // a warp's contiguous part of it
constexpr int BATCH = 8;                  // rounds a warp matches at once
constexpr int STAGED = TILE + 4;          // a staged tile and its 16-B head
constexpr int LOAD = 8;                   // 16-byte loads a thread in flight
constexpr unsigned int NO_DIGIT = 0xffffffffu;  // past the row's end
static_assert(THREADS == RADIX, "one thread per digit");
static_assert(KPT % BATCH == 0, "whole batches of rounds");

// a staged tile as cp.async lands it (the first pass's keys, or a later
// pass's (key, index) pairs, after a 16-byte head), then, from word 0,
// the tile's pairs reordered by digit
struct StageBuf {
  uint32_t w[2 * STAGED];
};
static_assert(sizeof(StageBuf) >= TILE * sizeof(uint2) + 16 &&
                  sizeof(StageBuf) % 16 == 0,
              "a staged tile holds its pairs and their head");

struct SortSmem {
  StageBuf stage[2];         // double buffered
  unsigned int match[BATCH][WARPS][RADIX];  // lanes by digit, by round
  unsigned int cnt[WARPS][RADIX];  // a tile's digit counts by warp, then
                                   // each (warp, digit)'s first slot
  unsigned int hist[DIGITS][RADIX];  // the row's digit histograms
  int delta[RADIX];                // row position - tile slot, by digit
  unsigned int wsum[WARPS];
  uint32_t red[2][WARPS];          // the row's key minimum and maximum
};

// the table phase's tile: the same positions as a sort tile, scanned as
// CHUNKS chunks of THREADS positions (the chunks of the recurrence's
// summation order), with one more position on each side
constexpr int CHUNKS = TILE / THREADS;
constexpr int HALO_STAGED = TILE + 8;
// rows of up to this many train points find their label matches in a
// bitmask in shared memory; longer rows gather ytr from global memory
constexpr int MATCH_BITS = 1 << 18;

struct TableSmem {
  int ord[2][HALO_STAGED];       // staged train indices of the positions
  float coef[2][HALO_STAGED];    // staged step coefficients
  uint32_t key[2][HALO_STAGED];  // staged sort keys (wknn's d2)
  float u[TILE + 2];             // u at the tile's positions, one each side
  float warp[CHUNKS][WARPS];     // each chunk's per-warp suffix sums
  float later[CHUNKS][WARPS];    // the sum of the warps after each warp
  float carry[CHUNKS];           // the sum of the positions past a chunk
  float red[WARPS];
  int redi[WARPS];
  unsigned int mbits[MATCH_BITS / 32 + 4];  // ytr[i] == y[p], a bit each
};

// the phases' shared memory, one after another in the same dynamic
// allocation: phase 1's two k-step stages, or one of these
union Smem {
  fill_tile::Smem fill;
  SortSmem sort;
  TableSmem table;
};
constexpr int DIST_BYTES = 2 * dist_tile::STAGE_BYTES;
// +1024 to align the base for the swizzled tiles
constexpr size_t SMEM_BYTES =
    (DIST_BYTES > sizeof(Smem) ? DIST_BYTES : sizeof(Smem)) + 1024;

// Exclusive prefix sum of one value a thread, in thread order. Holds one
// barrier; `wsum` must not be written again before the next barrier.
__device__ __forceinline__ unsigned int block_exclusive_scan(
    unsigned int v, unsigned int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  unsigned int before = 0;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  return before + x - v;
}

// the word offset of `p` within its 16-byte chunk
__device__ __forceinline__ int head_of(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3u);
}

// Stage words [j0, j0 + m) of `src` into `buf` by the block: the 16-byte
// chunks that hold them, so word j0 lands at buf[head_of(src + j0)]. A
// chunk that holds a word of an array lies inside that array's
// allocation (device allocations start 256-byte aligned and span whole
// 16-byte chunks), so reading up to 12 bytes past either end is safe; the
// words outside [j0, j0 + m) are never used.
__device__ __forceinline__ void stage_words(uint32_t* buf, const void* src,
                                            int j0, int m) {
  const uint32_t* p = static_cast<const uint32_t*>(src) + j0;
  const char* a = reinterpret_cast<const char*>(p) - 4 * head_of(p);
  const int chunks = (head_of(p) + m + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += THREADS)
    sm90::cp_async16(sm90::smem_u32(buf + 4 * c), a + 16 * c);
}

// f(valid, j, x) for every word x = a[j] of the n-word array a, read as
// aligned 16-byte chunks, LOAD of them a thread in flight. Every lane
// makes the same calls (f may hold warp collectives); `valid` is false
// for the words of the first and last chunks outside the array and for
// the lanes past the last chunk. Lane l's chunk is chunk l of its warp's
// 32, its words j = 4 c - head_of(a) .. + 3.
template <typename F>
__device__ __forceinline__ void for_each_word(const uint32_t* a, int n,
                                              F f) {
  const int head = head_of(a);
  const uint4* src = reinterpret_cast<const uint4*>(a - head);
  const int chunks = (head + n + 3) >> 2;
  for (int c0 = 0; c0 < chunks; c0 += THREADS * LOAD) {
    uint4 v[LOAD];
#pragma unroll
    for (int m = 0; m < LOAD; ++m) {
      const int c = c0 + m * THREADS + (int)threadIdx.x;
      v[m] = c < chunks ? src[c] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int m = 0; m < LOAD; ++m) {
      const int j = 4 * (c0 + m * THREADS + (int)threadIdx.x) - head;
      f(j >= 0 && j < n, j, v[m].x);
      f(j + 1 >= 0 && j + 1 < n, j + 1, v[m].y);
      f(j + 2 >= 0 && j + 2 < n, j + 2, v[m].z);
      f(j + 3 >= 0 && j + 3 < n, j + 3, v[m].w);
    }
  }
}

// One pass over the row by the digit at `shift`. The first (FIRST) reads
// the keys as phase 1 wrote them, subtracts `lo` and takes the positions
// as indices; the others read the (key, index) pairs that the pass before
// wrote to `src`. All but the last write pairs to `dst`, one 8-byte store
// an element; the last (LAST) adds lo back and writes the sorted row as
// keys `dk` and indices `di`. `rb` is this thread's digit's first row
// position.
//
// An element's row position is its digit's running offset plus the count
// of earlier elements of the tile with its digit. Thread (warp w, lane l)
// holds the tile's slots w WARP_KEYS + 32 i + l, i < KPT, so the tile's
// order is (warp, i, lane). A warp finds, for BATCH rounds i at once, the
// lanes of round i that share each lane's digit (each lane sets its bit
// in its digit's word of round i's match plane, then reads the word
// back); the lowest such lane then takes the round's count from the
// warp's running count of the digit, round after round, and earlier warps
// come in by the per-digit prefix over the warps' counts.
template <bool FIRST, bool LAST>
__device__ void radix_pass(const uint32_t* keys, const uint2* src,
                           uint2* dst, uint32_t* dk, int* di, int n,
                           int shift, uint32_t lo, unsigned int rb,
                           SortSmem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned int lt = (1u << lane) - 1u;
  const uint32_t add = LAST ? lo : 0u;
  const int seg = warp * WARP_KEYS + lane;  // this thread's first slot
  const int tiles = (n + TILE - 1) / TILE;
  auto stage = [&](int t) {
    const int j0 = t * TILE, m = min(TILE, n - j0);
    if (FIRST) stage_words(s.stage[t & 1].w, keys, j0, m);
    else stage_words(s.stage[t & 1].w, src, 2 * j0, 2 * m);
    sm90::cp_async_commit();
  };
  stage(0);
  for (int t = 0; t < tiles; ++t) {
    const int t0 = t * TILE;
    uint32_t* buf = s.stage[t & 1].w;
    sm90::cp_async_wait<0>();
    __syncthreads();  // tile t staged; tile t - 1 written out everywhere
    if (t + 1 < tiles) stage(t + 1);
    uint32_t key[KPT], val[KPT];
    unsigned int dig[KPT], peers[KPT], off[KPT];
    if (FIRST) {
      const uint32_t* kt = buf + head_of(keys + t0);
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        key[i] = kt[seg + 32 * i] - lo;
        val[i] = (uint32_t)(t0 + seg + 32 * i);
      }
    } else {  // pairs are 8-byte aligned: their head is 0 or 2 words
      const uint2* pt = reinterpret_cast<const uint2*>(buf + head_of(src + t0));
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const uint2 x = pt[seg + 32 * i];
        key[i] = x.x;
        val[i] = x.y;
      }
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      dig[i] = t0 + seg + 32 * i < n ? (key[i] >> shift) & (RADIX - 1)
                                     : NO_DIGIT;
#pragma unroll
    for (int i0 = 0; i0 < KPT; i0 += BATCH) {  // match BATCH rounds at once
#pragma unroll
      for (int r = 0; r < BATCH; ++r)
        if (dig[i0 + r] != NO_DIGIT)
          atomicOr(&s.match[r][warp][dig[i0 + r]], 1u << lane);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < BATCH; ++r)
        peers[i0 + r] =
            dig[i0 + r] != NO_DIGIT ? s.match[r][warp][dig[i0 + r]] : 0u;
      __syncwarp();
#pragma unroll
      for (int r = 0; r < BATCH; ++r)  // the lowest lane clears the word
        if (dig[i0 + r] != NO_DIGIT && lane == __ffs(peers[i0 + r]) - 1)
          s.match[r][warp][dig[i0 + r]] = 0u;
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i) {  // the round's leader bumps the count
      off[i] = 0u;
      if (dig[i] != NO_DIGIT && lane == __ffs(peers[i]) - 1) {
        off[i] = s.cnt[warp][dig[i]];
        s.cnt[warp][dig[i]] = off[i] + __popc(peers[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      off[i] = __shfl_sync(0xffffffffu, off[i], __ffs(peers[i]) - 1) +
               __popc(peers[i] & lt);
    __syncthreads();
    {  // thread b = digit b: its warps' first slots, its row offset
      unsigned int c[WARPS], tot = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) c[w] = s.cnt[w][tid];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const unsigned int x = c[w];
        c[w] = tot;
        tot += x;
      }
      const unsigned int st = block_exclusive_scan(tot, s.wsum);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s.cnt[w][tid] = st + c[w];
      s.delta[tid] = (int)(rb - st);
      rb += tot;
    }
    __syncthreads();
    {  // reorder the tile in place, by digit
      uint2* kv = reinterpret_cast<uint2*>(buf);
      unsigned int slot[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i)
        slot[i] = s.cnt[warp][dig[i] != NO_DIGIT ? dig[i] : 0u] + off[i];
#pragma unroll
      for (int i = 0; i < KPT; ++i)
        if (dig[i] != NO_DIGIT) kv[slot[i]] = make_uint2(key[i] + add, val[i]);
    }
    __syncthreads();
    {  // each digit's run in order, coalesced
      const uint2* kv = reinterpret_cast<const uint2*>(buf);
      const int m = min(TILE, n - t0);
      uint2 x[KPT];
      int g[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i)
        if (tid + THREADS * i < m) x[i] = kv[tid + THREADS * i];
#pragma unroll
      for (int i = 0; i < KPT; ++i)
        if (tid + THREADS * i < m)
          g[i] = s.delta[((x[i].x - add) >> shift) & (RADIX - 1)] + tid +
                 THREADS * i;
#pragma unroll
      for (int i = 0; i < KPT; ++i)
        if (tid + THREADS * i < m) {
          if (LAST) {
            dk[g[i]] = x[i].x;
            di[g[i]] = (int)x[i].y;
          } else {
            dst[g[i]] = x[i];
          }
        }
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s.cnt[w][tid] = 0u;
    }
  }
}

// Stable sort of one row of n keys (phase 1's, in ka; their indices are
// their positions) by (key, index), the order of torch.sort(stable=True),
// into (ka, ia); (pb, pc) are the row's two rows of n pairs for the
// passes between. Two reads of the keys come first: their minimum and
// maximum, then the histograms of every digit of key - min that the span
// max - min needs, in one read. A digit whose histogram holds the whole
// row in one bin leaves a stable pass the identity, so its pass is
// skipped (every digit above the span's top bit is such a digit), down to
// the two passes the first and last need. Returns the passes taken.
__device__ int radix_sort_row(uint32_t* ka, int* ia, uint2* pb, uint2* pc,
                              int n, SortSmem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t lo = 0xffffffffu, hi = 0u;
  for_each_word(ka, n, [&](bool valid, int, uint32_t key) {
    if (valid) {
      lo = min(lo, key);
      hi = max(hi, key);
    }
  });
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    s.red[0][warp] = lo;
    s.red[1][warp] = hi;
  }
  for (int i = tid; i < DIGITS * RADIX; i += THREADS)
    (&s.hist[0][0])[i] = 0u;
  for (int i = tid; i < WARPS * RADIX; i += THREADS) (&s.cnt[0][0])[i] = 0u;
  for (int i = tid; i < BATCH * WARPS * RADIX; i += THREADS)
    (&s.match[0][0][0])[i] = 0u;
  __syncthreads();
  for (int w = 0; w < WARPS; ++w) {
    lo = min(lo, s.red[0][w]);
    hi = max(hi, s.red[1][w]);
  }
  const uint32_t span = hi - lo;
  const int nd = span == 0u ? 0
                            : (32 - __clz((int)span) + RADIX_BITS - 1) /
                                  RADIX_BITS;
  for_each_word(ka, n, [&](bool valid, int, uint32_t key) {
    const uint32_t x = key - lo;
#pragma unroll
    for (int q = 0; q < DIGITS; ++q)
      if (valid && q < nd)
        atomicAdd(&s.hist[q][(x >> (RADIX_BITS * q)) & (RADIX - 1)], 1u);
  });
  __syncthreads();
  unsigned int todo = 0u;  // the digit positions that take a pass
#pragma unroll
  for (int q = 0; q < DIGITS; ++q)
    if (q < nd && !__syncthreads_or(s.hist[q][tid] == (unsigned int)n))
      todo |= 1u << q;
  while (__popc(todo) < 2) todo |= 1u << (__ffs(~todo) - 1);
  const int passes = __popc(todo);
  for (int q = 0, r = 0; q < DIGITS; ++q) {
    if (!((todo >> q) & 1u)) continue;
    const unsigned int rb = block_exclusive_scan(s.hist[q][tid], s.wsum);
    const int shift = RADIX_BITS * q;
    // pass r writes pairs to pb (r even) or pc (r odd); the next reads them
    if (r == 0)
      radix_pass<true, false>(ka, nullptr, pb, nullptr, nullptr, n, shift,
                              lo, rb, s);
    else if (r == passes - 1)
      radix_pass<false, true>(nullptr, r % 2 ? pb : pc, nullptr, ka, ia, n,
                              shift, lo, rb, s);
    else
      radix_pass<false, false>(nullptr, r % 2 ? pb : pc, r % 2 ? pc : pb,
                               nullptr, nullptr, n, shift, lo, rb, s);
    __syncthreads();  // the pass's writes, before the next reads them
    ++r;
  }
  return passes;
}

// ------------------------------------------------------------ the tables
// The recurrence's coefficient at sorted position j, the same for every
// row (phase 0 writes it once): sti's and sii's c_j of the g step, the
// point methods' min(k, j + 1) / (j + 1).
__device__ __forceinline__ float step_coef(int kind, int j, int k) {
  const float kf = (float)k, jf = (float)j;
  if (kind == STI) return __fdiv_rn(2.f * (jf - kf), (jf - 1.f) * jf);
  if (kind == SII) return __fdiv_rn(1.f, jf - 1.f);
  const float i1 = (float)(j + 1);
  return fminf(kf, i1) / i1;
}

// Phase 3 for test row p: the method's table along its sorted stream
// (keys, ord), scattered to train coordinates: for sti/sii pk[p, i] =
// (rank of train point i, bits of g at that rank) and ut[p, i], for the
// point methods tab[p, i] (the value of train point i). The suffix sums
// run from the end of the row over chunks of THREADS positions, a
// warp-shuffle scan in each, the chunks' sums carried in order. A tile of
// CHUNKS chunks has ord, the coefficients (and wknn's keys) staged by
// cp.async while the tile before it is scanned; u is formed once a
// position in shared memory (label matches from a bitmask of the row),
// every chunk is scanned, then each chunk's warp sums and carry are
// formed once for the tile, in the same order of additions as one chunk
// at a time.
__device__ void tables_row(const Params& P, int p, const uint32_t* keys,
                           const int* ord, TableSmem& s) {
  const int n = P.n, k = P.k, kind = P.kind;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t off = (size_t)p * n;
  const int yp = P.yb[p];
  const float maskp = P.mask[p];
  const float kf = (float)k;
  const float mk = maskp / kf;
  const bool inter = kind == STI || kind == SII;
  const bool weighted = kind == WKNN_RBF || kind == WKNN_INVERSE;

  float sigma2 = 1.f;
  if (kind == WKNN_RBF) {  // row mean of d2 over real (non-sentinel) columns
    float sum = 0.f;
    int cnt = 0;
    for (int j = tid; j < n; j += THREADS) {
      const float d2 = __uint_as_float(keys[j]);
      if (d2 < 1e20f) {
        sum += d2;
        ++cnt;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    }
    if (lane == 0) {
      s.red[warp] = sum;
      s.redi[warp] = cnt;
    }
    __syncthreads();
    sum = 0.f;
    cnt = 0;
    for (int w = 0; w < WARPS; ++w) {
      sum += s.red[w];
      cnt += s.redi[w];
    }
    __syncthreads();
    sigma2 = fmaxf(sum / (float)max(cnt, 1), 1e-12f);
  }

  // ytr[i] == yp for every train point, a bit each: bit c % 32 of word
  // 4 (c / 32) + e holds word e of ytr's 16-byte chunk c
  const bool bitmask = n <= MATCH_BITS && kind != LOO;
  const int yhead = head_of(P.ytr);
  if (bitmask) {
    for_each_word(reinterpret_cast<const uint32_t*>(P.ytr), n,
                  [&](bool valid, int j, uint32_t y) {
                    const unsigned int b =
                        __ballot_sync(0xffffffffu, valid && (int)y == yp);
                    const int e = j + yhead;  // lane 0's: a chunk 32 c'
                    if (lane == 0 && e - (e & 3) < yhead + n)  // c' in ytr
                      s.mbits[4 * (e >> 7) + (e & 3)] = b;
                  });
    __syncthreads();
  }
  auto matches = [&](int i) -> bool {
    if (!bitmask) return P.ytr[i] == yp;
    const int e = i + yhead;
    return (s.mbits[4 * (e >> 7) + (e & 3)] >> ((e >> 2) & 31)) & 1u;
  };

  // u of train point i at sorted distance bits kb: the contribution the
  // recurrence runs on
  auto u_of = [&](int i, uint32_t kb) -> float {
    const float m = matches(i) ? 1.f : 0.f;
    if (inter) return m * mk;
    if (!weighted && kind != WKNN_UNIFORM) return m * maskp;
    const float d2 = __uint_as_float(kb);
    float w = 1.f;
    if (kind == WKNN_RBF) w = expf(-d2 / (2.f * sigma2));
    else if (kind == WKNN_INVERSE) w = 1.f / (1.f + sqrtf(d2));
    return __fmul_rn(__fmul_rn(w, m), maskp);
  };
  auto u = [&](int j) -> float { return u_of(ord[j], keys[j]); };

  if (kind == LOO) {  // removing a point inside the window slides in #k
    float* tab = P.tab + 2 * off;
    const float nxt = n > k ? u(k) : 0.f;
    for (int j = tid; j < n; j += THREADS) {
      const float v = j < k ? (u(j) - nxt) / kf : 0.f;
      tab[ord[j]] = v;
    }
    return;
  }

  // the recurrence's last value
  float last;
  if (inter) {
    double lc = 0.0;  // _recurrence_coeffs: a double, then cast to f32
    if (n > k)
      lc = kind == STI ? -2.0 * (double)(n - k) / ((double)n * (n - 1.0))
                       : -1.0 / (n - 1.0);
    last = __fmul_rn((float)lc, u(n - 1));
  } else {
    last = __fdiv_rn(__fmul_rn(u(n - 1), (float)min(k, n)),
                     (float)((double)k * n));
  }

  // tile t holds chunks c_hi(t), c_hi(t) - THREADS, ...: positions
  // [lo, hi), staged with one more position each side, [j0, j1)
  const int top = ((n - 1) / THREADS) * THREADS;  // the last chunk's start
  auto span = [&](int c_hi, int& nq, int& lo, int& j0, int& j1) {
    nq = min(CHUNKS, c_hi / THREADS + 1);
    lo = c_hi - (nq - 1) * THREADS;
    j0 = max(lo - 1, 0);
    j1 = min(c_hi + THREADS + 1, n);
  };
  auto stage = [&](int c_hi, int b) {
    int nq, lo, j0, j1;
    span(c_hi, nq, lo, j0, j1);
    stage_words(reinterpret_cast<uint32_t*>(s.ord[b]), ord, j0, j1 - j0);
    stage_words(reinterpret_cast<uint32_t*>(s.coef[b]), P.coef, j0, j1 - j0);
    if (weighted) stage_words(s.key[b], keys, j0, j1 - j0);
    sm90::cp_async_commit();
  };
  constexpr int PER = (TILE + 2 + THREADS - 1) / THREADS;  // u a thread
  float carry = 0.f;  // sum of the terms at positions past this tile
  stage(top, 0);
  for (int c_hi = top, t = 0; c_hi >= 0; c_hi -= TILE, ++t) {
    const int b = t & 1;
    int nq, lo, j0, j1;
    span(c_hi, nq, lo, j0, j1);
    sm90::cp_async_wait<0>();
    __syncthreads();  // tile t staged; tile t - 1 done everywhere
    if (c_hi - TILE >= 0) stage(c_hi - TILE, b ^ 1);
    // staged word of position j: ord at ho + j, coef at hc + j, key hk + j
    const int ho = head_of(ord + j0) - j0, hc = head_of(P.coef + j0) - j0,
              hk = head_of(keys + j0) - j0;
    {  // u at positions j0 .. j1 - 1, into s.u[j - lo + 1]
      int ii[PER];
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        const int j = j0 + tid + THREADS * r;
        ii[r] = j < j1 ? s.ord[b][ho + j] : 0;
      }
      float uu[PER];
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        const int j = j0 + tid + THREADS * r;
        uu[r] = j < j1 ? u_of(ii[r], weighted ? s.key[b][hk + j] : 0u) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        const int j = j0 + tid + THREADS * r;
        if (j < j1) s.u[j - lo + 1] = uu[r];
      }
    }
    __syncthreads();
    // the step term at position j: su(j) is u at position j
    auto su = [&](int j) -> float { return s.u[j - lo + 1]; };
    auto term = [&](int j) -> float {
      const float c = s.coef[b][hc + j];
      if (inter) {
        if (n <= k || j <= k || j < 2) return 0.f;
        return __fmul_rn(c, su(j) - su(j - 1));
      }
      if (j >= n - 1) return 0.f;
      return __fdiv_rn(__fmul_rn(su(j) - su(j + 1), c), kf);
    };
    float v[CHUNKS];
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q) {
      if (q >= nq) break;
      const int j = c_hi - q * THREADS + tid;
      v[q] = j < n ? term(j) : 0.f;  // inclusive suffix sum in the warp
      for (int o = 1; o < 32; o <<= 1) {
        const float w = __shfl_down_sync(0xffffffffu, v[q], o);
        if (lane + o < 32) v[q] = __fadd_rn(v[q], w);
      }
      if (lane == 0) s.warp[q][warp] = v[q];
    }
    __syncthreads();
    if (warp == 0) {  // each chunk's later-warp sums and total, then carries
      float total = 0.f;
      if (lane < nq) {
        for (int w = WARPS - 1; w >= 0; --w) {
          s.later[lane][w] = total;
          total = __fadd_rn(total, s.warp[lane][w]);
        }
      }
      for (int q = 0; q < nq; ++q) {
        const float tq = __shfl_sync(0xffffffffu, total, q);
        if (lane == 0) s.carry[q] = carry;
        carry = __fadd_rn(carry, tq);
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q) {
      if (q >= nq) break;
      const int j = c_hi - q * THREADS + tid;
      const float cq = s.carry[q];
      const float incl = __fadd_rn(cq, __fadd_rn(v[q], s.later[q][warp]));
      const float next = __shfl_down_sync(0xffffffffu, incl, 1);
      if (j < n) {
        const int i = s.ord[b][ho + j];
        if (inter) {  // g[j] = last + sum over positions > j; g[0] = 0
          const float excl =
              lane < 31 ? next
              : warp + 1 < WARPS
                  ? __fadd_rn(cq, __fadd_rn(s.warp[q][warp + 1],
                                            s.later[q][warp + 1]))
                  : cq;
          const float val = j == 0 ? 0.f : __fadd_rn(last, excl);
          P.pk[off + i] = make_int2(j, __float_as_int(val));
          P.ut[2 * off + i] = su(j);
        } else {      // s[j] = last + sum over positions >= j
          P.tab[2 * off + i] = __fadd_rn(last, incl);
        }
      }
    }
    // the tile's carry-out: its last chunk's carry plus that chunk's total
    carry = __fadd_rn(s.carry[nq - 1],
                      __fadd_rn(s.warp[nq - 1][0], s.later[nq - 1][0]));
  }
}

__global__ void __launch_bounds__(THREADS, 1) megakernel(Params P) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  unsigned char* aligned = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  Smem& sm = *reinterpret_cast<Smem*>(aligned);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int tb = P.tb, n = P.n, d = P.d;

  // 0. row squared norms, a warp per row
  {
    const int lane = tid & 31;
    const int nw = gridDim.x * WARPS;
    for (int row = (blockIdx.x * THREADS + tid) >> 5; row < tb + n;
         row += nw) {
      const float* x =
          row < tb ? P.xb + (size_t)row * d : P.xtr + (size_t)(row - tb) * d;
      const float s = dist_tile::row_sq_norm(x, d, lane);
      if (lane == 0) P.norms[row] = s;
    }
    if (P.coef != nullptr)
      for (int j = blockIdx.x * THREADS + tid; j < n; j += gridDim.x * THREADS)
        P.coef[j] = step_coef(P.kind, j, P.k);
  }
  grid.sync();

  // 1. distance tiles -> sort keys in index order (the indices are the
  // positions: the sort's first pass makes them)
  {
    const int tiles_c = (n + dist_tile::BM - 1) / dist_tile::BM;
    const int tiles = (tb + dist_tile::BN - 1) / dist_tile::BN * tiles_c;
    const uint32_t stages = sm90::smem_u32(aligned);
    uint32_t* keys = P.keys_a;
    auto store = [keys, n](int r, int c, float v) {
      uint32_t bits = __float_as_uint(v);
      if (bits == 0x80000000u) bits = 0u;  // -0 sorts as +0
      keys[(size_t)r * n + c] = bits;
    };
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int test0 = tile / tiles_c * dist_tile::BN;
      const int train0 = tile % tiles_c * dist_tile::BM;
      if (P.bf16)
        dist_tile::block_tile<true, THREADS>(P.xb, P.xtr, P.norms,
                                             P.norms + tb, tb, n, d, test0,
                                             train0, stages, store);
      else
        dist_tile::block_tile<false, THREADS>(P.xb, P.xtr, P.norms,
                                              P.norms + tb, tb, n, d, test0,
                                              train0, stages, store);
    }
  }
  grid.sync();

  // 2-3. per test row: sort, then the method's table
  const bool rank_only = P.kind == RANK_ONLY;
  for (int p = blockIdx.x; p < tb; p += gridDim.x) {
    const size_t off = (size_t)p * n;
    const int passes =
        radix_sort_row(P.keys_a + off, P.idx_a + off, P.pairs_b + off,
                       P.pairs_c + off, n, sm.sort);
    if (P.passes != nullptr && tid == 0) P.passes[p] = passes;
    __syncthreads();
    if (!rank_only)
      tables_row(P, p, P.keys_a + off, P.idx_a + off, sm.table);
    __syncthreads();
  }
  if (rank_only) return;
  grid.sync();

  // 4. the update of the row block at row_offset
  const bool inter = P.kind == STI || P.kind == SII;
  {
    const float* src = inter ? P.ut : P.tab;
    for (int a = blockIdx.x * THREADS + tid; a < P.nr;
         a += gridDim.x * THREADS) {
      float s = 0.f;  // rows of 2 n: the tables lie over the pairs
      for (int p = 0; p < tb; ++p)
        s += src[(size_t)p * 2 * n + P.row_offset + a];
      P.vec[a] += s;
    }
  }
  if (inter) {
    // rows: the window of the block's train points; cols: all n
    const fill_tile::Side rows{P.pk + P.row_offset, n, P.nr};
    const fill_tile::Side cols{P.pk, n, n};
    fill_tile::fill(P.acc, rows, cols, tb,
                    fill_tile::Schedule(P.nr, n, P.row_offset), blockIdx.x,
                    gridDim.x, sm.fill);
  }
}

// set on every launch: the attribute belongs to the current device
cudaError_t set_smem_attribute() {
  return cudaFuncSetAttribute(megakernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_BYTES);
}

// Cooperative launch on the current device: one resident wave, as many
// blocks as fit on every SM. Refused launches are reported, never
// degraded: 801 (cudaErrorNotSupported) without cooperative launch.
int launch(const Params& P, void* stream) {
  // the distance phase's 16-byte loads (see dist_tile::load4)
  if (P.d % 4 != 0 || reinterpret_cast<uintptr_t>(P.xb) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(P.xtr) % 16 != 0)
    return cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = set_smem_attribute();
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, megakernel,
                                                    THREADS, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  Params prm = P;
  void* args[] = {&prm};
  e = cudaLaunchCooperativeKernel((const void*)megakernel,
                                  dim3(per_sm * sms), dim3(THREADS), args,
                                  SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes; all pointers are device pointers and
// `stream` is a cudaStream_t. `scratch` is int32 (6, tb, n): the sorted
// keys and indices in planes 0-1, and two buffers of (key, index) pairs
// for the radix passes between, planes 2-3 and 4-5 as (tb, 2 n); after
// the sort the (rank, g) pairs of sti/sii (kind 1, 2) lie over planes
// 2-3, and u or the point values over the first n words of each row of
// planes 4-5. `norms` is f32 (tb + 2 n,): the norms, then the
// recurrence's per-position coefficients. acc (nr, n; NULL for point
// methods) and vec (nr,) are updated in place. `kind` is a Kind above;
// `bf16` rounds the cross-term operands to bf16. d must be a multiple of
// 4 and xb and xtr 16-byte aligned (the wrapper pads d with zero columns
// and copies a misaligned view, as for `distance.cu`). Returns a
// cudaError_t (0 = launched).
extern "C" int valuation_megakernel(float* acc, float* vec, const float* xb,
                                    const int* yb, const float* mask,
                                    const float* xtr, const int* ytr,
                                    float* norms, int* scratch, int tb, int n,
                                    int d, int nr, int row_offset, int k,
                                    int kind, int bf16, void* stream) {
  const size_t plane = (size_t)tb * n;
  Params P = {};
  P.acc = acc;
  P.vec = vec;
  P.xb = xb;
  P.yb = yb;
  P.mask = mask;
  P.xtr = xtr;
  P.ytr = ytr;
  P.norms = norms;
  if (kind != LOO) P.coef = norms + tb + n;
  P.keys_a = reinterpret_cast<uint32_t*>(scratch);
  P.idx_a = scratch + plane;
  P.pairs_b = reinterpret_cast<uint2*>(scratch + 2 * plane);
  P.pairs_c = reinterpret_cast<uint2*>(scratch + 4 * plane);
  P.pk = reinterpret_cast<int2*>(P.pairs_b);
  P.tab = P.ut = reinterpret_cast<float*>(P.pairs_c);
  P.tb = tb;
  P.n = n;
  P.d = d;
  P.nr = nr;
  P.row_offset = row_offset;
  P.k = k;
  P.kind = kind;
  P.bf16 = bf16;
  return launch(P, stream);
}

// The rank phase alone (phases 0-2 of the same kernel): `scratch` is int32
// (6, tb, n) as above; on return plane 0 holds the sorted d2 (f32 bits)
// and plane 1 the sorted train indices of each test row, and `passes`
// (tb,) int32, if not NULL, the radix passes each row took. For tests and
// diagnostics.
extern "C" int megakernel_rank_phase(const float* xb, const float* xtr,
                                     float* norms, int* scratch, int* passes,
                                     int tb, int n, int d, int bf16,
                                     void* stream) {
  const size_t plane = (size_t)tb * n;
  Params P = {};
  P.xb = xb;
  P.xtr = xtr;
  P.norms = norms;
  P.keys_a = reinterpret_cast<uint32_t*>(scratch);
  P.idx_a = scratch + plane;
  P.pairs_b = reinterpret_cast<uint2*>(scratch + 2 * plane);
  P.pairs_c = reinterpret_cast<uint2*>(scratch + 4 * plane);
  P.passes = passes;
  P.tb = tb;
  P.n = n;
  P.d = d;
  P.nr = 0;
  P.kind = RANK_ONLY;
  P.bf16 = bf16;
  return launch(P, stream);
}

// Blocks per SM of the cooperative grid and the SM count of the current
// device, for reports.
extern "C" int megakernel_occupancy(int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = set_smem_attribute();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, megakernel,
                                                       THREADS, SMEM_BYTES);
}
