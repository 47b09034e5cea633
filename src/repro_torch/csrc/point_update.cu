// The point update of the streaming step for knn_shapley and wknn: for a
// (tb, n) f32 contribution `u` in sorted coordinates and its (tb, n) int64
// `ranks`, adds into the (n,) f32 state
//
//     vec[i] += sum over rows p of s[p, ranks[p, i]],
//     s = knn_shapley_from_sorted(u, k)
//
// with the reference's roundings per term, in f32 (core/knn_shapley.py):
// last = u[n-1] * min(k, n) / (k n), step_j = (u[j] - u[j+1]) * (min(j+1,
// k) / (j+1)) / k, s[j] = last + (step_j + ... + step_{n-2}), s[n-1] =
// last. Only the order in which the suffix and the row sums add differs
// from the plain version's; it is fixed, so two runs give the same bits.
//
// Replaces no TPU kernel: the JAX package leaves this recurrence and the
// gather through `ranks` to XLA, and the port ran them as nine plain
// PyTorch passes over the (tb, n) plane (a diff, a product, two flips, a
// cumsum, an add, a cat, the gather, the row sum).
//
// What bounds it: bytes, and the gather's random reads. The function
// reads u (4 bytes a key) and ranks (8) once and the (n,) vector once
// each way: 12 bytes a key, 3.94 GB at the knn cell's 256 x 1,281,167
// (1.18 ms at 3.35 TB/s). The suffix runs along sorted positions and the
// sum along train indices, so the design takes two kernels and writes the
// per-row values `s` once and reads them once between them (20 bytes a
// key, 1.96 ms), and one 4-byte read of s a key lands at a random place
// of its row. What the design does about that (times on one H100 at 700
// W, 256 x 1,281,167 / 32 x 650,000):
//   * scan_kernel (sorted coordinates, 1.11 / 0.076 ms): each block takes
//     one tile of 4096 positions of a row by ticket, tickets going round
//     the rows from their last tiles, so the grid fills the card at any
//     (tb, n) (80,128 tiles at the knn cell, 5,088 at the Jamba cell) and
//     a tile's successors in its row started tb tickets before it. It
//     reads u once, forms the steps (their two divisions only where u
//     changes: 1.56 ms with them everywhere), scans them in the tile (warp
//     shuffles, then the warps' and chunks' sums) and finds the sum of the
//     row's later tiles by a decoupled look-back (Merrill and Garland).
//     Float sums do not associate, so the look-back folds the tiles' sums
//     from the nearest tile that holds its inclusive sum back to its own
//     tile, one at a time: that is exactly how that tile's inclusive sum
//     was formed, so the result is the chain's whatever the look-back
//     finds published, and the bits do not depend on timing;
//   * gather_kernel (train coordinates, 3.09 / 0.204 ms): one cooperative
//     wave of blocks, each owning a range of train indices, walks the rows
//     in order: it reads ranks[p, i] coalesced (evict-first), gathers
//     s[p, ranks[p, i]] and keeps the sum in registers, then adds it into
//     vec[i] once. No float atomics. Each random read costs an L2 request
//     of a 32-byte sector, and those requests bound it: gathering every
//     row from one L2-resident row takes as long. So the blocks are held
//     within AHEAD rows of each other, which keeps the rows they read in
//     L2 (unpaced, they drift apart and it takes 2.8x as long), and fewer,
//     fuller threads (24 indices each, two blocks an SM) beat more warps.
// Fusing the two into one kernel, the scan a few rows ahead of the
// gather, spilled and read 4.5-4.8 ms against these 4.22.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNKS = 16;               // chunks of THREADS positions
constexpr int TILE = THREADS * CHUNKS;   // 4096 positions a tile
constexpr int GATHER_THREADS = 256;
constexpr int PER_THREAD = 24;           // train indices a thread sums
constexpr int GATHER_BLOCKS_SM = 2;      // gather blocks an SM, at least
constexpr int AHEAD = 4;                 // rows a gather block may lead by

// a tile's look-back word: the flag in the high half, the bits of its f32
// sum in the low half, written and read as one 64-bit word
constexpr uint32_t FLAG_AGGREGATE = 1u;  // the tile's own sum
constexpr uint32_t FLAG_PREFIX = 2u;     // its sum and every later tile's

__device__ __forceinline__ unsigned long long ld_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_word(unsigned long long* p, uint32_t flag,
                                        float x) {
  const unsigned long long v =
      ((unsigned long long)flag << 32) | __float_as_uint(x);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// Folds the look-back words of lanes top .. 0 of a warp's window into
// `acc`, nearest last: a tile's inclusive sum replaces what was folded,
// its own sum is added in front of it (x + acc). Uniform across the warp.
__device__ __forceinline__ float fold(unsigned long long w, int top,
                                      float acc) {
  const uint32_t flag = (uint32_t)(w >> 32);
  const float x = __uint_as_float((uint32_t)w);
  for (int l = top; l >= 0; --l) {
    const uint32_t f = __shfl_sync(0xffffffffu, flag, l);
    const float v = __shfl_sync(0xffffffffu, x, l);
    acc = f == FLAG_PREFIX ? v : __fadd_rn(v, acc);
  }
  return acc;
}

// The sum of the row's tiles after tile t, by warp 0: publishes the
// tile's own sum `agg`, waits until the nearest later tile that holds its
// inclusive sum is found with every tile before it published, folds them
// (`fold`), publishes the tile's inclusive sum and returns the sum after
// it. The row's last tile publishes its sum as inclusive at once.
__device__ float look_back(unsigned long long* words, int t, int tiles,
                           float agg) {
  const int lane = threadIdx.x & 31;
  if (t == tiles - 1) {
    if (lane == 0) st_word(words + t, FLAG_PREFIX, __fadd_rn(agg, 0.f));
    return 0.f;
  }
  if (lane == 0) st_word(words + t, FLAG_AGGREGATE, agg);
  const long long t0 = clock64();
  int base = t + 1, first;
  unsigned long long w;
  for (;;) {
    const int j = base + lane;
    w = j < tiles ? ld_word(words + j) : 0ull;
    const uint32_t flag = (uint32_t)(w >> 32);
    const unsigned int prefix = __ballot_sync(0xffffffffu, flag == FLAG_PREFIX);
    const unsigned int empty = __ballot_sync(0xffffffffu, flag == 0u);
    first = prefix ? __ffs(prefix) - 1 : 32;
    const unsigned int below = first == 32 ? 0xffffffffu : (1u << first) - 1u;
    if (empty & below) {  // a tile before the nearest prefix is not ready
      if (clock64() - t0 > sm90::WAIT_LIMIT) __trap();
      continue;
    }
    if (prefix) break;
    base += 32;  // all 32 hold their sums: on to the next window
  }
  float acc = fold(w, first, 0.f);
  for (int b = base - 32; b > t; b -= 32) acc = fold(ld_word(words + b + lane),
                                                     31, acc);
  if (lane == 0) st_word(words + t, FLAG_PREFIX, __fadd_rn(agg, acc));
  return acc;
}

// Phase 1: one tile of one row a block (module note). Chunk q of the tile
// holds positions p0 + q THREADS + tid. A position's suffix sum is, in this
// order of additions, its warp's inclusive suffix (shuffles) + (the later
// tiles' sum + (the tile's later chunks' sum + the chunk's later warps'
// sum)).
__global__ void __launch_bounds__(THREADS) scan_kernel(
    const float* __restrict__ u, float* __restrict__ s,
    unsigned long long* words, unsigned int* ticket, int tb, int n,
    int tiles, int k) {
  __shared__ unsigned int s_ticket;
  __shared__ float wsum[CHUNKS][WARPS];
  __shared__ float off[CHUNKS][WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const unsigned int v = s_ticket;
  const int row = (int)(v % (unsigned int)tb);
  const int t = tiles - 1 - (int)(v / (unsigned int)tb);
  const float* ur = u + (size_t)row * n;
  float* sr = s + (size_t)row * n;
  const int p0 = t * TILE;
  const float kf = (float)k;
  const float last = __fdiv_rn(__fmul_rn(__ldg(ur + n - 1), (float)min(k, n)),
                               (float)((double)k * n));
  float a[CHUNKS], e[CHUNKS];
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {  // every load in flight at once
    const int j = p0 + q * THREADS + tid;
    a[q] = j < n ? __ldcs(ur + j) : 0.f;
    e[q] = lane == 31 && j + 1 < n ? __ldcs(ur + j + 1) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    const int j = p0 + q * THREADS + tid;
    float next = __shfl_down_sync(0xffffffffu, a[q], 1);
    if (lane == 31) next = e[q];
    // the step; where u does not change it is +0 whatever the
    // divisions would give (+0 * coef / k), so they are skipped
    float x = j < n - 1 ? __fsub_rn(a[q], next) : 0.f;
    if (x != 0.f) {
      const float i1 = __fadd_rn((float)j, 1.f);
      x = __fdiv_rn(__fmul_rn(x, __fdiv_rn(fminf(i1, kf), i1)), kf);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // inclusive suffix sum in the warp
      const float y = __shfl_down_sync(0xffffffffu, x, o);
      if (lane + o < 32) x = __fadd_rn(x, y);
    }
    a[q] = x;
    if (lane == 0) wsum[q][warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
    float later[WARPS], total = 0.f;  // lane q: chunk q's later warps
#pragma unroll
    for (int w = WARPS - 1; w >= 0; --w) {
      later[w] = total;
      if (lane < CHUNKS) total = __fadd_rn(total, wsum[lane][w]);
    }
    float carry = 0.f, mine = 0.f;  // the sums of the later chunks
    for (int q = CHUNKS - 1; q >= 0; --q) {
      const float tq = __shfl_sync(0xffffffffu, total, q);
      if (lane == q) mine = carry;
      carry = __fadd_rn(carry, tq);
    }
    const float after = look_back(
        words + (size_t)row * tiles, t, tiles, carry);
    if (lane < CHUNKS) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        off[lane][w] = __fadd_rn(after, __fadd_rn(mine, later[w]));
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    const int j = p0 + q * THREADS + tid;
    if (j < n) sr[j] = __fadd_rn(last, __fadd_rn(a[q], off[q][warp]));
  }
}

// Phase 2: block b sums train indices [start, start + per_block) of the
// launch's range, thread tid those at tid + GATHER_THREADS e, over the
// rows in order 0, 1, ..., then adds each sum into vec once. The sum over
// rows keeps each addition's rounding error (Knuth's 2Sum) and adds their
// sum at the end, so its error does not grow with the rows as a running
// f32 sum's does (~1e-6 of the largest value at 256 rows, where the plain
// row sum's tree reads ~2e-7), and a zero row changes neither part.
// Thread 0 counts the row done in done[r] and, before row r, waits until
// every block of the launch has counted row r - AHEAD (`base` counts the
// blocks of earlier launches), so the blocks stay within AHEAD rows of
// each other and the rows they gather from stay in L2 (with no wait the
// gather takes 2.8x as long at the knn cell's shape). The launch is
// cooperative: every block is resident, so the wait ends.
__global__ void __launch_bounds__(GATHER_THREADS, GATHER_BLOCKS_SM)
    gather_kernel(const float* __restrict__ s,
                  const long long* __restrict__ ranks,
                  float* __restrict__ vec, unsigned long long* done, int tb,
                  int n, int lo, int hi, int per_block,
                  unsigned long long base) {
  const int start = lo + blockIdx.x * per_block;
  const int end = min(start + per_block, hi);
  const int i0 = start + threadIdx.x;
  const unsigned long long all = base + gridDim.x;
  float acc[PER_THREAD], err[PER_THREAD];
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) acc[e] = err[e] = 0.f;
  for (int r = 0; r < tb; ++r) {
    if (r >= AHEAD) {
      if (threadIdx.x == 0) {
        const long long t0 = clock64();
        while (ld_word(done + r - AHEAD) < all)
          if (clock64() - t0 > sm90::WAIT_LIMIT) __trap();
      }
      __syncthreads();
    }
    const long long* rr = ranks + (size_t)r * n;
    const float* srow = s + (size_t)r * n;
    long long rk[PER_THREAD];
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const int i = i0 + e * GATHER_THREADS;
      rk[e] = i < end ? __ldcs(rr + i) : 0ll;
    }
    float x[PER_THREAD];
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const int i = i0 + e * GATHER_THREADS;
      x[e] = i < end ? __ldg(srow + rk[e]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {  // acc + x and its exact
      const float t = __fadd_rn(acc[e], x[e]);  // rounding error (2Sum)
      const float b = __fsub_rn(t, acc[e]);
      err[e] = __fadd_rn(err[e], __fadd_rn(__fsub_rn(acc[e], __fsub_rn(t, b)),
                                           __fsub_rn(x[e], b)));
      acc[e] = t;
    }
    if (threadIdx.x == 0) atomicAdd(done + r, 1ull);
  }
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = i0 + e * GATHER_THREADS;
    if (i < end) vec[i] = __fadd_rn(vec[i], __fadd_rn(acc[e], err[e]));
  }
}

// the workspace: the ticket counter, one look-back word a tile of a row,
// one row counter a row (8 bytes each)
size_t ws_bytes(int tb, int n) {
  const size_t tiles = ((size_t)n + TILE - 1) / TILE;
  return 8 * (1 + (size_t)tb * tiles + (size_t)tb);
}

// the gather's resident blocks on the card (SMs x blocks a SM), by device
cudaError_t gather_grid(int* out) {
  static int cache[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cache[dev] > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_kernel,
                                                    GATHER_THREADS, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (dev < 64) cache[dev] = sms * per_sm;
  *out = sms * per_sm;
  return cudaSuccess;
}

}  // namespace

// C interface, loaded with ctypes; all pointers are device pointers and
// `stream` is a cudaStream_t. u (tb, n) f32 and ranks (tb, n) int64, read;
// vec (n,) f32, added into; s (tb, n) f32 and ws `point_update_ws_bytes`
// bytes, scratch (any contents: ws is zeroed here). k >= 1, n < 2^31 -
// 4096. Returns a cudaError_t (0 = launched).
extern "C" long long point_update_ws_bytes(int tb, int n) {
  return (long long)ws_bytes(tb, n);
}

extern "C" int point_update(const float* u, const long long* ranks,
                            float* vec, float* s, void* ws, int tb, int n,
                            int k, void* stream) {
  if (tb <= 0 || n <= 0) return cudaSuccess;
  if (k < 1 || n > 0x7fffffff - TILE) return cudaErrorInvalidValue;
  const long long tiles = (n + TILE - 1) / TILE;
  if ((long long)tb * tiles > 0x7fffffffll) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(ws, 0, ws_bytes(tb, n), st);
  if (e != cudaSuccess) return e;
  unsigned int* ticket = static_cast<unsigned int*>(ws);
  unsigned long long* words = static_cast<unsigned long long*>(ws) + 1;
  unsigned long long* done = words + (size_t)tb * tiles;
  scan_kernel<<<(unsigned int)(tb * tiles), THREADS, 0, st>>>(
      u, s, words, ticket, tb, n, (int)tiles, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  int resident = 0;
  e = gather_grid(&resident);
  if (e != cudaSuccess) return e;
  // one wave of blocks covers up to resident x GATHER_THREADS x PER_THREAD
  // indices; a longer row takes one launch per such range
  const long long span = (long long)resident * GATHER_THREADS * PER_THREAD;
  unsigned long long base = 0;
  for (long long lo = 0; lo < n; lo += span) {
    int lo_i = (int)lo, hi = (int)(lo + span < n ? lo + span : n);
    const long long m = hi - lo;
    long long per_block = (m + resident - 1) / resident;
    per_block = (per_block + 31) / 32 * 32;  // warps start on whole lines
    int per = (int)per_block;
    const unsigned int blocks = (unsigned int)((m + per_block - 1) / per_block);
    void* args[] = {(void*)&s, (void*)&ranks, (void*)&vec, (void*)&done,
                    (void*)&tb, (void*)&n, (void*)&lo_i, (void*)&hi,
                    (void*)&per, (void*)&base};
    e = cudaLaunchCooperativeKernel((const void*)gather_kernel, dim3(blocks),
                                    dim3(GATHER_THREADS), args, 0, st);
    if (e != cudaSuccess) return e;
    base += blocks;
  }
  return cudaSuccess;
}
