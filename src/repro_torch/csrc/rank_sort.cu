// The rank stage of the streaming step: a stable sort of every row of a
// (tb, n) f32 array that writes the row's argsort `order` and its inverse
// `ranks` (both int64), the order of torch.sort(stable=True) on the card
// by (key, index), -0 sorted as +0 and a NaN by its bits.
//
// Replaces no TPU kernel: the JAX package ranks with `jnp.argsort` (XLA's
// sort) and `ranks_from_order`'s scatter, and the port ran
// `torch.sort(stable=True)` (one cub radix sort per row: 3,078 runtime
// calls a step at 256 rows of n = 1,281,167) and the same scatter. This
// kernel does the rank stage's work in eight launches a call (the
// wrapper's zero fill of the control words, then the seven launches
// below), whatever tb and n, with no host sync.
//
// What bounds it: bytes. A stable LSD radix sort with int32 indices
// between passes moves, per key, 4 bytes for each of two prologue reads
// (the row's key minimum and maximum; the digit histograms of key - min),
// 12 for the first pass (keys read, (key, index) pairs written), 16 for
// each pass between and 24 for the last (pairs read, int64 order and
// int64 ranks written): 12 + 16 P bytes for P passes, 60 at the knn
// cell's three (19.7 GB over 256 x 1,281,167 keys, 5.9 ms at 3.35 TB/s).
// What the design does about that:
//   * a digit that one bin holds whole (every digit above the top bit of
//     max - min) is skipped, since a stable pass by it is the identity:
//     a row takes 1 to 4 passes, decided per row by the histograms;
//   * each pass is one launch over every row at once (onesweep, Adinets
//     and Merrill, arXiv:2206.01784): a row is split into tiles of 4096
//     keys, persistent blocks take the tiles by ticket, and a tile finds
//     where its digits start in its row by a decoupled look-back over the
//     row's earlier tiles, so no pass needs a grid-wide scan. Tickets go
//     round the pass's rows, so a tile's predecessor started about one
//     tile's time before it and the look-back is short. The grid follows
//     the SM count and the blocks that fit on each, the prologue's
//     blocks (tb, n);
//   * a block stages its next tile by cp.async while it ranks this one in
//     shared memory (a warp matches the digits of 4 rounds at once by
//     atomicOr into per-round match words, as the megakernel's sort
//     does), reorders it there by digit and writes it out as contiguous
//     runs, so the pairs and `order` are written coalesced;
//   * `ranks` is no scatter of 8 bytes a key (the card takes ~30 G such
//     stores a second: 11 ms at the knn cell): the last pass also writes
//     its (index, position) pairs grouped by bucket of 8192 indices, in
//     runs, into `ranks`'s own memory, and one more launch turns each
//     bucket into its ranks in shared memory, coalesced both ways (8 more
//     bytes a key written and 16 moved);
//   * the passes between move (key, index) pairs through two buffers, a
//     workspace of the same size and `order`'s own memory, chosen per row
//     so that the last pass reads the workspace.
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix.cuh"
#include "sm90.cuh"

namespace {

using radix::block_exclusive_scan;
using radix::head_of;
using radix::stage_words;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX_BITS = 8;             // 8-bit digits, 256 bins
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int DIGITS = 32 / RADIX_BITS;   // digit positions of a 32-bit key
constexpr int KPT = 16;                   // keys a thread ranks per tile
constexpr int TILE = THREADS * KPT;       // 4096 keys a tile
constexpr int WARP_KEYS = 32 * KPT;       // a warp's contiguous part of it
constexpr int BATCH = 4;                  // rounds a warp matches at once
constexpr int LOOK = 4;                   // look-back words a thread in flight
constexpr int CHUNK = 32768;              // keys a prologue block reads
constexpr int UNROLL = 8;                 // prologue loads a thread in flight
constexpr unsigned int NO_DIGIT = 0xffffffffu;  // past the row's end
// the rank inversion's buckets: the indices [b BUCKET, (b + 1) BUCKET) of a
// row, at most MAX_BUCKETS a row (rows of up to 8,388,608 keys; longer
// rows scatter `ranks` straight from the last pass)
constexpr int BUCKET_BITS = 13;
constexpr int BUCKET = 1 << BUCKET_BITS;
constexpr int MAX_BUCKETS = 1024;
static_assert(THREADS == RADIX, "one thread per digit");
static_assert(KPT % BATCH == 0, "whole batches of rounds");
static_assert(CHUNK % (THREADS * UNROLL) == 0, "whole prologue rounds");
static_assert(2 * MAX_BUCKETS <= WARPS * RADIX,
              "the bucket tables fit over the digit counts");
static_assert(2 * TILE <= BATCH * WARPS * RADIX,
              "a reordered tile fits in the match planes");
static_assert(MAX_BUCKETS == 4 * THREADS, "four buckets a thread");

// a tile's status word for one digit: a flag in the top two bits, the
// count below (so a row holds fewer than 2^30 keys)
constexpr uint32_t FLAG_AGGREGATE = 1u << 30;  // this tile's own count
constexpr uint32_t FLAG_PREFIX = 2u << 30;     // the row's count up to it
constexpr uint32_t COUNT = FLAG_AGGREGATE - 1u;
// a look-back that waits this many cycles (~10 s) is a hang: trap, so the
// launch fails instead of stalling its stream
constexpr long long WAIT_LIMIT = 1ll << 34;

// the per-row control words
enum RowWord { NOT_LO = 0, HI = 1, DONE = 2, TODO = 3, ROW_WORDS = 4 };

// The control words, one zeroed int32 allocation (kernels/rank_sort.py
// computes the same size, `ctl_words`):
struct Ctl {
  uint32_t* counts;   // (DIGITS,) rows in each list
  uint32_t* tickets;  // (DIGITS,) tiles handed out by each pass
  uint32_t* rows;     // (tb, ROW_WORDS): ~min and max of the keys (by
                      // atomicMax), histogram blocks done, digits to pass
  uint32_t* lists;    // (DIGITS, tb) the rows that take a pass by a digit
  uint32_t* hist;     // (tb, DIGITS, RADIX) digit histograms of key - min
  uint32_t* base;     // (tb, DIGITS, RADIX) each digit's first position
  uint32_t* status;   // (DIGITS, tb, tiles, RADIX) look-back words
  uint32_t* cursors;  // (tb, buckets) pairs written to each bucket
};

Ctl carve(uint32_t* w, int tb, int tiles) {
  Ctl c;
  c.counts = w;
  c.tickets = w + DIGITS;
  c.rows = c.tickets + DIGITS;
  c.lists = c.rows + (size_t)tb * ROW_WORDS;
  c.hist = c.lists + (size_t)DIGITS * tb;
  c.base = c.hist + (size_t)tb * DIGITS * RADIX;
  c.status = c.base + (size_t)tb * DIGITS * RADIX;
  c.cursors = c.status + (size_t)DIGITS * RADIX * tb * tiles;
  return c;
}

size_t ctl_words(int tb, int n) {
  const size_t tiles = ((size_t)n + TILE - 1) / TILE;
  const size_t buckets = ((size_t)n + BUCKET - 1) / BUCKET;
  return 2 * DIGITS + (size_t)tb * (ROW_WORDS + DIGITS + 2 * DIGITS * RADIX) +
         (size_t)DIGITS * RADIX * tb * tiles + (size_t)tb * buckets;
}

// The unsigned key whose order is the order torch.sort gives f32 keys on
// the card (cub's radix sort): -0 made +0, then the sign bit flipped for
// a positive float and every bit for a negative one. A NaN sorts by its
// bits, as there: a negative NaN before -inf, a positive one after +inf.
__device__ __forceinline__ uint32_t sort_key(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// f(sort key) for every key of row[j0, j1), UNROLL loads a thread in
// flight
template <typename F>
__device__ __forceinline__ void for_each_key(const float* row, int j0, int j1,
                                             F f) {
  for (int b = j0; b < j1; b += THREADS * UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = b + u * THREADS + (int)threadIdx.x;
      v[u] = j < j1 ? __ldcs(row + j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (b + u * THREADS + (int)threadIdx.x < j1) f(sort_key(v[u]));
  }
}

// ------------------------------------------------------------ prologue
// 1. Each row's key minimum and maximum: a block per CHUNK keys of a row.
__global__ void __launch_bounds__(THREADS) minmax_kernel(const float* keys,
                                                         Ctl C, int n,
                                                         int chunks) {
  __shared__ uint32_t red[2][WARPS];
  const int row = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t lo = 0xffffffffu, hi = 0u;
  for_each_key(keys + (size_t)row * n, c * CHUNK, min(n, (c + 1) * CHUNK),
               [&](uint32_t k) {
                 lo = min(lo, k);
                 hi = max(hi, k);
               });
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    red[0][warp] = lo;
    red[1][warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
      lo = min(lo, red[0][w]);
      hi = max(hi, red[1][w]);
    }
    atomicMax(&C.rows[(size_t)row * ROW_WORDS + NOT_LO], ~lo);
    atomicMax(&C.rows[(size_t)row * ROW_WORDS + HI], hi);
  }
}

// 2. The histogram of each digit of key - min that the row's span needs,
// a block per CHUNK keys of a row; the row's last block to finish then
// plans its sort: the digits that take a pass (a digit whose histogram
// holds the whole row in one bin does not; at least one pass), each
// pass's digit offsets, the row entered in each of its passes' lists.
__global__ void __launch_bounds__(THREADS) hist_kernel(const float* keys,
                                                       Ctl C, int* passes,
                                                       int tb, int n,
                                                       int chunks) {
  __shared__ unsigned int h[DIGITS][RADIX];
  __shared__ unsigned int wsum[WARPS];
  __shared__ int last;
  const int row = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int tid = threadIdx.x;
  uint32_t* rw = C.rows + (size_t)row * ROW_WORDS;
  const uint32_t lo = ~rw[NOT_LO];
  const uint32_t span = rw[HI] - lo;
  const int nd = span == 0u ? 0
                            : (32 - __clz((int)span) + RADIX_BITS - 1) /
                                  RADIX_BITS;
  for (int i = tid; i < DIGITS * RADIX; i += THREADS) (&h[0][0])[i] = 0u;
  __syncthreads();
  for_each_key(keys + (size_t)row * n, c * CHUNK, min(n, (c + 1) * CHUNK),
               [&](uint32_t k) {
                 const uint32_t x = k - lo;
#pragma unroll
                 for (int q = 0; q < DIGITS; ++q)
                   if (q < nd)
                     atomicAdd(&h[q][(x >> (RADIX_BITS * q)) & (RADIX - 1)],
                               1u);
               });
  __syncthreads();
  uint32_t* hist = C.hist + (size_t)row * DIGITS * RADIX;
  for (int q = 0; q < nd; ++q)
    if (h[q][tid]) atomicAdd(&hist[q * RADIX + tid], h[q][tid]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&rw[DONE], 1u) == (unsigned int)chunks - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  unsigned int hq[DIGITS];
#pragma unroll
  for (int q = 0; q < DIGITS; ++q)
    hq[q] = q < nd ? __ldcg(&hist[q * RADIX + tid]) : 0u;
  unsigned int todo = 0u;
#pragma unroll
  for (int q = 0; q < DIGITS; ++q)
    if (q < nd && !__syncthreads_or(hq[q] == (unsigned int)n))
      todo |= 1u << q;
  // every key alike: one pass by digit 0 (no histogram: bases of 0)
  if (todo == 0u) todo = 1u;
  uint32_t* base = C.base + (size_t)row * DIGITS * RADIX;
#pragma unroll
  for (int q = 0; q < DIGITS; ++q)
    if ((todo >> q) & 1u) {
      base[q * RADIX + tid] = block_exclusive_scan(hq[q], wsum);
      __syncthreads();
    }
  if (tid == 0) {
    rw[TODO] = todo;
    if (passes != nullptr) passes[row] = __popc(todo);
    for (int q = 0; q < DIGITS; ++q)
      if ((todo >> q) & 1u)
        C.lists[(size_t)q * tb + atomicAdd(&C.counts[q], 1u)] = row;
  }
}

// ------------------------------------------------------------ the passes
struct PassArgs {
  const float* keys;  // (tb, n)
  long long* order;   // (tb, n) the argsort; pairs between passes too
  long long* ranks;   // (tb, n) the inverse permutation
  uint2* work;        // (tb, n) (key, index) pairs between passes
  Ctl C;
  int tb, n, tiles;
  int buckets;        // per row, or 0: the last pass scatters `ranks`
};

// a staged tile as cp.async lands it (the first pass's keys, or a later
// pass's (key, index) pairs, after a head of up to 16 bytes); in the last
// pass, once the tile is ranked, its (index, position) pairs by bucket
constexpr int STAGED = 2 * TILE + 4;

struct PassSmem {
  uint32_t stage[2][STAGED];       // double buffered
  unsigned int match[BATCH][WARPS][RADIX];  // lanes by digit, by round;
                                            // then the tile by digit
  unsigned int cnt[WARPS][RADIX];  // a tile's digit counts by warp, then
                                   // each (warp, digit)'s first slot
  int delta[RADIX];                // row position - tile slot, by digit
  unsigned int wsum[WARPS];
  unsigned int next;               // the next tile's ticket
};
constexpr size_t SMEM_BYTES = sizeof(PassSmem);

// what a ticket names: tile t of the pass's k-th row, and where the row's
// pass reads and writes. Tickets go round the pass's rows (k = id % rows,
// t = id / rows), so a tile's predecessor in its row started about one
// tile's time before it, and its look-back is short.
struct Tile {
  int row, t, m;
  bool first, last;
  uint32_t lo;
  const uint2* src;  // the pairs the pass before wrote (not first)
  uint2* dst;        // the pairs this pass writes (not last)
};

__device__ __forceinline__ Tile describe(const PassArgs& A, int q,
                                         unsigned int rows,
                                         unsigned int id) {
  Tile T;
  T.row = (int)A.C.lists[(size_t)q * A.tb + id % rows];
  T.t = (int)(id / rows);
  T.m = min(TILE, A.n - T.t * TILE);
  const uint32_t* rw = A.C.rows + (size_t)T.row * ROW_WORDS;
  const unsigned int todo = rw[TODO];
  const int passes = __popc(todo), r = __popc(todo & ((1u << q) - 1u));
  T.first = r == 0;
  T.last = r == passes - 1;
  T.lo = ~rw[NOT_LO];
  // pass r < passes - 1 writes the workspace when passes - 2 - r is even,
  // `order`'s memory when odd; pass r > 0 reads what pass r - 1 wrote
  uint2* pairs_o = reinterpret_cast<uint2*>(A.order);
  T.src = T.first ? nullptr : ((passes - 1 - r) & 1 ? pairs_o : A.work);
  T.dst = T.last ? nullptr : ((passes - 2 - r) & 1 ? pairs_o : A.work);
  return T;
}

// cp.async of the tile's input into `buf`: the keys of its row's slice
// (first pass) or the pairs
__device__ __forceinline__ void stage_tile(const PassArgs& A, const Tile& T,
                                           uint32_t* buf) {
  const size_t j0 = (size_t)T.row * A.n + (size_t)T.t * TILE;
  if (T.first)
    stage_words<THREADS>(buf, A.keys, j0, T.m);
  else
    stage_words<THREADS>(buf, T.src, 2 * j0, 2 * T.m);
}

// the i-th key a thread ranks, from the staged tile: the sort key less the
// row's minimum (first pass) or the pair's key
template <bool FIRST>
__device__ __forceinline__ uint32_t staged_key(const uint32_t* kt, int j,
                                               uint32_t lo) {
  return FIRST ? sort_key(__uint_as_float(kt[j])) - lo : kt[2 * j];
}

// The look-back of tile t > 0 for one digit, `stat` its word in the
// row's tile 0. `look_ahead` publishes the tile's count and starts the
// loads of the LOOK words before it; `look_back` (after other work) adds
// the counts of the row's tiles before it back to the nearest one that
// has published its inclusive count, LOOK words in flight at once,
// publishes the tile's inclusive count and returns the count before it.
struct LookBack {
  uint32_t w[LOOK];
};

__device__ __forceinline__ LookBack look_ahead(uint32_t* stat, int t,
                                               unsigned int tot) {
  st_relaxed(stat + (size_t)t * RADIX, FLAG_AGGREGATE | tot);
  LookBack L;
#pragma unroll
  for (int u = 0; u < LOOK; ++u)
    L.w[u] = t - 1 - u >= 0 ? ld_relaxed(stat + (size_t)(t - 1 - u) * RADIX)
                            : FLAG_PREFIX;
  return L;
}

__device__ __forceinline__ unsigned int look_back(uint32_t* stat, int t,
                                                  unsigned int tot,
                                                  LookBack L) {
  unsigned int before = 0;
  const long long t_wait = clock64();
  for (int j = t - 1;; j -= LOOK) {
#pragma unroll
    for (int u = 0; u < LOOK; ++u) {
      while (!(L.w[u] & ~COUNT)) {
        if (clock64() - t_wait > WAIT_LIMIT) __trap();
        L.w[u] = ld_relaxed(stat + (size_t)(j - u) * RADIX);
      }
      before += L.w[u] & COUNT;
      if (L.w[u] & FLAG_PREFIX) {
        st_relaxed(stat + (size_t)t * RADIX, FLAG_PREFIX | (before + tot));
        return before;
      }
    }
#pragma unroll
    for (int u = 0; u < LOOK; ++u)
      L.w[u] = j - LOOK - u >= 0
                   ? ld_relaxed(stat + (size_t)(j - LOOK - u) * RADIX)
                   : FLAG_PREFIX;
  }
}

// The last pass's (index, row position) pairs of a tile, whose (key,
// index) pairs lie reordered by digit in `kv` (`s.delta` maps a digit's
// tile slot to its row position), written into `ranks`'s memory by
// bucket: the pairs of bucket b of the row (indices [b BUCKET,
// (b + 1) BUCKET)) go to [b BUCKET, (b + 1) BUCKET) of the row, in any
// order, for the inversion kernel. The tile counts its pairs by bucket,
// takes its place in each bucket from the row's cursor, reorders them by
// bucket into `buf` and writes each bucket's run coalesced. The bucket
// tables lie over the tile's (zeroed) digit counts.
__device__ __forceinline__ void bucket_pairs(const PassArgs& A, PassSmem& s,
                                             const Tile& T, int shift,
                                             const uint2* kv, uint32_t* buf) {
  const int tid = threadIdx.x, m = T.m;
  unsigned int* bcnt = &s.cnt[0][0];        // counts, then next slots
  unsigned int* goff = bcnt + MAX_BUCKETS;  // bucket - tile slot, mod 2^32
  uint2* kb = reinterpret_cast<uint2*>(buf);
  __syncthreads();  // the counts are zero
  for (int k = tid; k < m; k += THREADS)
    atomicAdd(&bcnt[kv[k].y >> BUCKET_BITS], 1u);
  __syncthreads();
  {  // thread t: buckets 4 t .. 4 t + 3
    unsigned int c[4], g[4], sum = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int b = 4 * tid + u;
      c[u] = bcnt[b];
      g[u] = c[u] ? atomicAdd(&A.C.cursors[(size_t)T.row * A.buckets + b],
                              c[u])
                  : 0u;
      sum += c[u];
    }
    unsigned int st = block_exclusive_scan(sum, s.wsum);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      goff[4 * tid + u] = g[u] - st;
      bcnt[4 * tid + u] = st;
      st += c[u];
    }
  }
  __syncthreads();
  for (int k = tid; k < m; k += THREADS) {
    const uint2 x = kv[k];
    const uint2 e =
        make_uint2(x.y, (uint32_t)(s.delta[(x.x >> shift) & (RADIX - 1)] + k));
    kb[atomicAdd(&bcnt[e.x >> BUCKET_BITS], 1u)] = e;
  }
  __syncthreads();
  uint2* pairs = reinterpret_cast<uint2*>(A.ranks) + (size_t)T.row * A.n;
  for (int k = tid; k < m; k += THREADS) {
    const uint2 x = kb[k];
    const unsigned int b = x.x >> BUCKET_BITS;
    __stcg(pairs + (size_t)b * BUCKET + (goff[b] + (unsigned int)k), x);
  }
}

// One tile of one row by the digit at `shift`, staged in `buf`. The first
// pass (FIRST) reads the keys, makes them sort keys less the row's
// minimum and takes their positions as indices; the others read the (key,
// index) pairs that the pass before wrote. All but the last write pairs,
// one 8-byte store a key; the last (LAST) writes order[pos] = index and
// the (index, pos) pairs by bucket (`bucket_pairs`), or ranks[index] = pos
// where a row has more than MAX_BUCKETS buckets.
//
// A key's row position is its digit's first position in the row
// (`base`), plus the count of the digit in the row's earlier tiles (the
// look-back), plus the count of earlier keys of the tile with its digit.
// Thread (warp w, lane l) holds the tile's slots w WARP_KEYS + 32 i + l,
// i < KPT, so the tile's order is (warp, i, lane). A warp finds, for
// BATCH rounds i at once, the lanes of round i that share each lane's
// digit (each lane sets its bit in its digit's word of round i's match
// plane, then reads the word back); the lowest such lane then takes the
// round's count from the warp's running count of the digit, round after
// round, and earlier warps come in by the per-digit prefix over the
// warps' counts. The tile is then reordered by digit into the match
// planes, and each digit's run written out at its row position, coalesced.
template <bool FIRST, bool LAST>
__device__ __forceinline__ void tile_pass(const PassArgs& A, PassSmem& s,
                                          int q, const Tile& T,
                                          uint32_t* buf) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned int lt = (1u << lane) - 1u;
  const int shift = RADIX_BITS * q;
  const size_t roff = (size_t)T.row * A.n;
  const int t0 = T.t * TILE, m = T.m;
  const int seg = warp * WARP_KEYS + lane;  // this thread's first slot
  const uint32_t* kt =
      buf + (FIRST ? head_of(A.keys + roff + t0)
                   : head_of(T.src + roff + t0));
  unsigned int dig[KPT], off[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
    dig[i] = seg + 32 * i < m
                 ? (staged_key<FIRST>(kt, seg + 32 * i, T.lo) >> shift) &
                       (RADIX - 1)
                 : NO_DIGIT;
#pragma unroll
  for (int i0 = 0; i0 < KPT; i0 += BATCH) {  // match BATCH rounds at once
    unsigned int peers[BATCH];
#pragma unroll
    for (int r = 0; r < BATCH; ++r)
      if (dig[i0 + r] != NO_DIGIT)
        atomicOr(&s.match[r][warp][dig[i0 + r]], 1u << lane);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < BATCH; ++r)
      peers[r] = dig[i0 + r] != NO_DIGIT ? s.match[r][warp][dig[i0 + r]] : 0u;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < BATCH; ++r) {
      const unsigned int d = dig[i0 + r];
      const bool leader = d != NO_DIGIT && lane == __ffs(peers[r]) - 1;
      unsigned int o = 0u;
      if (leader) {  // the lowest lane clears the word, bumps the count
        s.match[r][warp][d] = 0u;
        o = s.cnt[warp][d];
        s.cnt[warp][d] = o + __popc(peers[r]);
      }
      off[i0 + r] = __shfl_sync(0xffffffffu, o, __ffs(peers[r]) - 1) +
                    __popc(peers[r] & lt);
      __syncwarp();  // the count and the cleared word, before the next round
    }
  }
  __syncthreads();
  // thread b = digit b: the tile's count, published for the row's later
  // tiles, and the look-back's first loads; its warps' first slots
  unsigned int tot = 0, st;
  uint32_t* stat =
      A.C.status + (((size_t)q * A.tb + T.row) * A.tiles) * RADIX + tid;
  LookBack L;
  {
    unsigned int c[WARPS];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) c[w] = s.cnt[w][tid];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const unsigned int x = c[w];
      c[w] = tot;
      tot += x;
    }
    if (T.t == 0)
      st_relaxed(stat, FLAG_PREFIX | tot);
    else
      L = look_ahead(stat, T.t, tot);
    st = block_exclusive_scan(tot, s.wsum);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s.cnt[w][tid] = st + c[w];
  }
  __syncthreads();
  // reorder the tile by digit into the match planes, free until the next
  // tile's matching
  uint2* kv = reinterpret_cast<uint2*>(&s.match[0][0][0]);
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int j = seg + 32 * i;
    if (dig[i] != NO_DIGIT)
      kv[s.cnt[warp][dig[i]] + off[i]] =
          FIRST ? make_uint2(staged_key<FIRST>(kt, j, T.lo),
                             (uint32_t)(t0 + j))
                : reinterpret_cast<const uint2*>(kt)[j];
  }
  {  // the look-back, its loads landed meanwhile: the digit's row position
    const unsigned int before = T.t == 0 ? 0u : look_back(stat, T.t, tot, L);
    s.delta[tid] =
        (int)(A.C.base[((size_t)T.row * DIGITS + q) * RADIX + tid] + before) -
        (int)st;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s.cnt[w][tid] = 0u;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {  // each digit's run in order, coalesced
    const int idx = tid + THREADS * i;
    if (idx < m) {
      const uint2 x = kv[idx];
      const int g = s.delta[(x.x >> shift) & (RADIX - 1)] + idx;
      if (LAST) {
        __stcs(A.order + roff + g, (long long)x.y);
        if (A.buckets == 0) A.ranks[roff + x.y] = (long long)g;
      } else {
        __stcs(T.dst + roff + g, x);
      }
    }
  }
  if (LAST && A.buckets > 0) bucket_pairs(A, s, T, shift, kv, buf);
  __syncthreads();  // the tile is out: the match planes and counts zero
  uint4* z = reinterpret_cast<uint4*>(&s.match[0][0][0]);
  for (int i = tid; i < BATCH * WARPS * RADIX / 4; i += THREADS)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  if (LAST && A.buckets > 0)
    for (int i = tid; i < WARPS * RADIX; i += THREADS)
      (&s.cnt[0][0])[i] = 0u;
}

// The pass by digit q of every row that takes one: persistent blocks take
// the tiles of the pass's rows in ticket order, each staging its next
// tile by cp.async while it ranks, reorders and writes out this one.
// Row by row, the pairs of pass r go to the workspace or to `order`'s
// memory, alternately, so that the last pass reads the workspace while it
// writes `order` and, in `ranks`'s memory, the inversion's pairs.
__global__ void __launch_bounds__(THREADS, 2) pass_kernel(PassArgs A, int q) {
  extern __shared__ uint4 smem_raw[];
  PassSmem& s = *reinterpret_cast<PassSmem*>(smem_raw);
  const int tid = threadIdx.x;
  for (int i = tid; i < BATCH * WARPS * RADIX; i += THREADS)
    (&s.match[0][0][0])[i] = 0u;
  for (int i = tid; i < WARPS * RADIX; i += THREADS) (&s.cnt[0][0])[i] = 0u;
  const unsigned int rows = A.C.counts[q];
  const unsigned int total = rows * (unsigned int)A.tiles;
  if (tid == 0) s.next = atomicAdd(&A.C.tickets[q], 1u);
  __syncthreads();
  unsigned int id = s.next;
  if (id >= total) return;
  Tile T = describe(A, q, rows, id);
  stage_tile(A, T, s.stage[0]);
  sm90::cp_async_commit();
  for (int k = 0;; ++k) {
    __syncthreads();  // every thread has read `next`
    if (tid == 0) s.next = atomicAdd(&A.C.tickets[q], 1u);
    sm90::cp_async_wait<0>();
    __syncthreads();  // tile k staged; tile k - 1 written out everywhere
    const unsigned int next = s.next;
    Tile N;
    if (next < total) {
      N = describe(A, q, rows, next);
      stage_tile(A, N, s.stage[(k + 1) & 1]);
    }
    sm90::cp_async_commit();
    uint32_t* buf = s.stage[k & 1];
    if (T.first && T.last)
      tile_pass<true, true>(A, s, q, T, buf);
    else if (T.first)
      tile_pass<true, false>(A, s, q, T, buf);
    else if (T.last)
      tile_pass<false, true>(A, s, q, T, buf);
    else
      tile_pass<false, false>(A, s, q, T, buf);
    if (next >= total) return;
    T = N;
  }
}

// 3. ranks from the last pass's (index, position) pairs, a block per
// bucket of a row: the bucket's pairs (in `ranks`'s own memory, at the
// bucket's indices) are read, placed by index in shared memory and
// written back over them as the bucket's ranks, coalesced both ways.
__global__ void __launch_bounds__(THREADS) invert_kernel(long long* ranks,
                                                         int n, int buckets) {
  __shared__ int win[BUCKET];
  const int row = blockIdx.x / buckets, b = blockIdx.x % buckets;
  long long* out = ranks + (size_t)row * n + (size_t)b * BUCKET;
  const uint2* pairs = reinterpret_cast<const uint2*>(out);
  const int size = min(BUCKET, n - b * BUCKET);
#pragma unroll 4
  for (int k = threadIdx.x; k < size; k += THREADS) {
    const uint2 x = __ldcs(pairs + k);
    win[x.x & (BUCKET - 1)] = (int)x.y;
  }
  __syncthreads();
#pragma unroll 4
  for (int k = threadIdx.x; k < size; k += THREADS)
    __stcs(out + k, (long long)win[k]);
}

// the pass kernel's resident blocks a SM and the SM count, by device
struct Occupancy {
  int per_sm = 0, sms = 0;
};

cudaError_t occupancy(Occupancy* out) {
  static Occupancy cache[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cache[dev].per_sm > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  Occupancy o;
  e = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(pass_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, pass_kernel,
                                                    THREADS, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  if (o.per_sm < 1) return cudaErrorInvalidConfiguration;
  if (dev < 64) cache[dev] = o;
  *out = o;
  return cudaSuccess;
}

}  // namespace

// C interface, loaded with ctypes; all pointers are device pointers and
// `stream` is a cudaStream_t. keys (tb, n) f32; order and ranks (tb, n)
// int64, written; work (tb, n) pairs of int32 (8 bytes a key); ctl
// `rank_sort_ctl_words(tb, n)` int32 words, all zero; passes (tb,) int32,
// if not NULL, the passes each row took (1 to 4). n < 2^30. Returns a
// cudaError_t (0 = launched).
extern "C" long long rank_sort_ctl_words(int tb, int n) {
  return (long long)ctl_words(tb, n);
}

extern "C" int rank_sort(const float* keys, long long* order,
                         long long* ranks, void* work, int* ctl,
                         int* passes, int tb, int n, void* stream) {
  if (tb <= 0 || n <= 0) return cudaSuccess;
  if (n > (int)COUNT) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + TILE - 1) / TILE;
  const int chunks = (n + CHUNK - 1) / CHUNK;
  Occupancy occ;
  cudaError_t e = occupancy(&occ);
  if (e != cudaSuccess) return e;
  PassArgs A;
  A.keys = keys;
  A.order = order;
  A.ranks = ranks;
  A.work = static_cast<uint2*>(work);
  A.C = carve(reinterpret_cast<uint32_t*>(ctl), tb, tiles);
  A.tb = tb;
  A.n = n;
  A.tiles = tiles;
  const int buckets = (n + BUCKET - 1) / BUCKET;
  A.buckets = buckets <= MAX_BUCKETS ? buckets : 0;
  const long long blocks = (long long)tb * chunks;
  minmax_kernel<<<(unsigned int)blocks, THREADS, 0, st>>>(keys, A.C, n,
                                                          chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  hist_kernel<<<(unsigned int)blocks, THREADS, 0, st>>>(keys, A.C, passes,
                                                        tb, n, chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long tiles_all = (long long)tb * tiles;
  const long long resident = (long long)occ.per_sm * occ.sms;
  const unsigned int grid =
      (unsigned int)(tiles_all < resident ? tiles_all : resident);
  for (int q = 0; q < DIGITS; ++q) {
    pass_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(A, q);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (A.buckets == 0) return cudaSuccess;
  invert_kernel<<<(unsigned int)((long long)tb * A.buckets), THREADS, 0,
                  st>>>(ranks, n, A.buckets);
  return cudaGetLastError();
}
