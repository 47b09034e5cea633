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
//   2. per test row (a block each): a stable LSD radix sort, four 8-bit
//      passes over (key, index) pairs that start in index order -- the
//      order of torch.sort(stable=True), i.e. of `merge_sorted_tile`;
//   3. per test row, same block: the method's table along the sorted
//      stream (sti/sii: u = match*mask/k and the superdiagonal_g suffix
//      recurrence; knn_shapley/wknn: the knn_shapley_from_sorted suffix
//      recurrence, wknn's distance weights on the sorted d2 with a block
//      reduction for the rbf row mean over d2 < 1e20; loo: the window
//      delta), scattered to train coordinates with the ranks -- for
//      sti/sii g as (rank, g) pairs packed for the fill;
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
// fill runs two); for the point methods the distance's three TF32
// products on the tensor cores (3 * 2 t n d operations, 0.156 ms at 495
// TFLOP/s). The sort and the tables are O(t n) and take a few ms at one
// block per test row.
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
constexpr int RADIX = 256;
static_assert(THREADS == RADIX, "one thread per radix digit");
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
  uint32_t* keys_a;    // (tb, n) sort keys; sorted after phase 2
  int* idx_a;          // (tb, n) train indices; sorted after phase 2
  uint32_t* keys_b;    // (tb, n) radix ping-pong
  int* idx_b;          // (tb, n) radix ping-pong
  int2* pk;            // (tb, n) train coordinates: (rank, g bits), sti/sii
  float* tab;          // (tb, n) train coordinates: point values
  float* ut;           // (tb, n) train coordinates: u (sti/sii)
  int tb, n, d, nr, row_offset, k, kind, bf16;
};

struct SortSmem {
  unsigned int base[4][RADIX];     // per pass: histogram -> running offsets
  unsigned int cnt[WARPS][RADIX];  // one chunk's per-warp digit counts
  unsigned int total[RADIX];       // one chunk's digit counts
};

struct ScanSmem {
  float warp[WARPS];
  float incl[THREADS];
  float red[WARPS];
  int redi[WARPS];
};

// the phases' shared memory, one after another in the same dynamic
// allocation: phase 1's two k-step stages, or one of these
union Smem {
  fill_tile::Smem fill;
  SortSmem sort;
  ScanSmem scan;
};
constexpr int DIST_BYTES = 2 * dist_tile::STAGE_BYTES;
// +1024 to align the base for the swizzled tiles
constexpr size_t SMEM_BYTES =
    (DIST_BYTES > sizeof(Smem) ? DIST_BYTES : sizeof(Smem)) + 1024;

// Stable LSD radix sort of one row of n (key, index) pairs, 8 bits per
// pass, by one block. Each pass scatters a chunk of THREADS elements at a
// time: an element's place is the running offset of its digit plus the
// number of earlier elements of the chunk with the same digit (earlier
// warps through shared counts, earlier lanes through __match_any_sync).
// Four passes move the data a -> b -> a -> b -> a: it ends in (ka, va).
__device__ void radix_sort_row(uint32_t* __restrict__ ka, int* __restrict__ va,
                               uint32_t* __restrict__ kb, int* __restrict__ vb,
                               int n, SortSmem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 4 * RADIX; i += THREADS) (&s.base[0][0])[i] = 0u;
  for (int i = tid; i < WARPS * RADIX; i += THREADS) (&s.cnt[0][0])[i] = 0u;
  __syncthreads();
  for (int j = tid; j < n; j += THREADS) {
    const uint32_t key = ka[j];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      atomicAdd(&s.base[q][(key >> (8 * q)) & 255u], 1u);
  }
  __syncthreads();
  if (tid < 4) {  // exclusive scan of each pass's histogram
    unsigned int run = 0;
    for (int b = 0; b < RADIX; ++b) {
      const unsigned int c = s.base[tid][b];
      s.base[tid][b] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned int lt = (1u << lane) - 1u;
  uint32_t *sk = ka, *dk = kb;
  int *sv = va, *dv = vb;
  for (int q = 0; q < 4; ++q) {
    const int shift = 8 * q;
    unsigned int* base = s.base[q];
    for (int c0 = 0; c0 < n; c0 += THREADS) {
      const int j = c0 + tid;
      const bool valid = j < n;
      uint32_t key = 0u;
      int val = 0;
      unsigned int dig = RADIX;  // a digit no valid element has
      if (valid) {
        key = sk[j];
        val = sv[j];
        dig = (key >> shift) & 255u;
      }
      const unsigned int peers = __match_any_sync(0xffffffffu, dig);
      const unsigned int rank = __popc(peers & lt);
      if (valid && rank == 0) s.cnt[warp][dig] = __popc(peers);
      __syncthreads();
      {  // thread b: exclusive prefix of digit b over the warps
        unsigned int run = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const unsigned int c = s.cnt[w][tid];
          s.cnt[w][tid] = run;
          run += c;
        }
        s.total[tid] = run;
      }
      __syncthreads();
      if (valid) {
        const unsigned int pos = base[dig] + s.cnt[warp][dig] + rank;
        dk[pos] = key;
        dv[pos] = val;
      }
      __syncthreads();
      base[tid] += s.total[tid];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s.cnt[w][tid] = 0u;
      __syncthreads();
    }
    uint32_t* tk = sk; sk = dk; dk = tk;
    int* tv = sv; sv = dv; dv = tv;
  }
}

// Phase 3 for test row p: the method's table along the sorted stream of
// row p (keys_a / idx_a), scattered to train coordinates: for sti/sii
// pk[p, i] = (rank of train point i, bits of g at that rank) and
// ut[p, i], for the point methods tab[p, i] (the value of train point i).
// Suffix sums run over chunks of THREADS positions from the end of the
// row, a warp-shuffle scan within each chunk.
__device__ void tables_row(const Params& P, int p, ScanSmem& s) {
  const int n = P.n, k = P.k, kind = P.kind;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t off = (size_t)p * n;
  const uint32_t* keys = P.keys_a + off;
  const int* ord = P.idx_a + off;
  int2* pk = P.pk + off;
  float* tab = P.tab + off;
  float* ut = P.ut + off;
  const int yp = P.yb[p];
  const float maskp = P.mask[p];
  const float kf = (float)k;
  const float mk = maskp / kf;
  const bool inter = kind == STI || kind == SII;

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

  // u at sorted position j: the contribution the recurrence runs on
  auto u = [&](int j) -> float {
    const float m = P.ytr[ord[j]] == yp ? 1.f : 0.f;
    if (inter) return m * mk;
    if (kind == KNN_SHAPLEY || kind == LOO) return m * maskp;
    const float d2 = __uint_as_float(keys[j]);
    float w = 1.f;
    if (kind == WKNN_RBF) w = expf(-d2 / (2.f * sigma2));
    else if (kind == WKNN_INVERSE) w = 1.f / (1.f + sqrtf(d2));
    return __fmul_rn(__fmul_rn(w, m), maskp);
  };

  if (kind == LOO) {  // removing a point inside the window slides in #k
    const float nxt = n > k ? u(k) : 0.f;
    for (int j = tid; j < n; j += THREADS) {
      const float v = j < k ? (u(j) - nxt) / kf : 0.f;
      tab[ord[j]] = v;
    }
    return;
  }

  // the recurrence's last value and its per-position step term
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
  auto term = [&](int j) -> float {
    if (inter) {
      if (n <= k || j <= k || j < 2) return 0.f;
      const float jf = (float)j;
      const float c = kind == STI
                          ? __fdiv_rn(2.f * (jf - kf), (jf - 1.f) * jf)
                          : __fdiv_rn(1.f, jf - 1.f);
      return __fmul_rn(c, u(j) - u(j - 1));
    }
    if (j >= n - 1) return 0.f;
    const float i1 = (float)(j + 1);
    return __fdiv_rn(__fmul_rn(u(j) - u(j + 1), fminf(kf, i1) / i1), kf);
  };

  float carry = 0.f;  // sum of the terms at positions past this chunk
  for (int c0 = ((n - 1) / THREADS) * THREADS; c0 >= 0; c0 -= THREADS) {
    const int j = c0 + tid;
    const float tj = j < n ? term(j) : 0.f;
    float v = tj;  // inclusive suffix sum within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const float w = __shfl_down_sync(0xffffffffu, v, o);
      if (lane + o < 32) v = __fadd_rn(v, w);
    }
    if (lane == 0) s.warp[warp] = v;
    __syncthreads();
    float later = 0.f, total = 0.f;
    for (int w = WARPS - 1; w >= 0; --w) {
      if (w > warp) later = __fadd_rn(later, s.warp[w]);
      total = __fadd_rn(total, s.warp[w]);
    }
    const float incl = __fadd_rn(carry, __fadd_rn(v, later));  // over >= j
    s.incl[tid] = incl;
    __syncthreads();
    if (j < n) {
      const int i = ord[j];
      if (inter) {  // g[j] = last + sum over positions > j; g[0] = 0
        const float excl = tid + 1 < THREADS ? s.incl[tid + 1] : carry;
        const float val = j == 0 ? 0.f : __fadd_rn(last, excl);
        pk[i] = make_int2(j, __float_as_int(val));
        ut[i] = u(j);
      } else {      // s[j] = last + sum over positions >= j
        tab[i] = __fadd_rn(last, incl);
      }
    }
    carry = __fadd_rn(carry, total);
    __syncthreads();
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
  }
  grid.sync();

  // 1. distance tiles -> (key, index) pairs in index order
  {
    const int tiles_c = (n + dist_tile::BM - 1) / dist_tile::BM;
    const int tiles = (tb + dist_tile::BN - 1) / dist_tile::BN * tiles_c;
    const uint32_t stages = sm90::smem_u32(aligned);
    uint32_t* keys = P.keys_a;
    int* idx = P.idx_a;
    auto store = [keys, idx, n](int r, int c, float v) {
      uint32_t bits = __float_as_uint(v);
      if (bits == 0x80000000u) bits = 0u;  // -0 sorts as +0
      keys[(size_t)r * n + c] = bits;
      idx[(size_t)r * n + c] = c;
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
  for (int p = blockIdx.x; p < tb; p += gridDim.x) {
    const size_t off = (size_t)p * n;
    radix_sort_row(P.keys_a + off, P.idx_a + off, P.keys_b + off,
                   P.idx_b + off, n, sm.sort);
    __syncthreads();
    if (P.kind != RANK_ONLY) tables_row(P, p, sm.scan);
    __syncthreads();
  }
  if (P.kind == RANK_ONLY) return;
  grid.sync();

  // 4. the update of the row block at row_offset
  const bool inter = P.kind == STI || P.kind == SII;
  {
    const float* src = inter ? P.ut : P.tab;
    for (int a = blockIdx.x * THREADS + tid; a < P.nr;
         a += gridDim.x * THREADS) {
      float s = 0.f;
      for (int p = 0; p < tb; ++p) s += src[(size_t)p * n + P.row_offset + a];
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
// `stream` is a cudaStream_t. `scratch` is int32 (7, tb, n): sort keys,
// indices, their two ping-pong buffers, then (rank, g) pairs over planes
// 4-5 for sti/sii (the point values in plane 5 otherwise) and u. `norms` is
// f32 (tb + n,). acc (nr, n; NULL for point methods) and vec (nr,) are
// updated in place. `kind` is a Kind above; `bf16` rounds the cross-term
// operands to bf16. d must be a multiple of 4 and xb and xtr 16-byte
// aligned (the wrapper pads d with zero columns and copies a misaligned
// view, as for `distance.cu`). Returns a cudaError_t (0 = launched).
extern "C" int valuation_megakernel(float* acc, float* vec, const float* xb,
                                    const int* yb, const float* mask,
                                    const float* xtr, const int* ytr,
                                    float* norms, int* scratch, int tb, int n,
                                    int d, int nr, int row_offset, int k,
                                    int kind, int bf16, void* stream) {
  const size_t plane = (size_t)tb * n;
  Params P;
  P.acc = acc;
  P.vec = vec;
  P.xb = xb;
  P.yb = yb;
  P.mask = mask;
  P.xtr = xtr;
  P.ytr = ytr;
  P.norms = norms;
  P.keys_a = reinterpret_cast<uint32_t*>(scratch);
  P.idx_a = scratch + plane;
  P.keys_b = reinterpret_cast<uint32_t*>(scratch + 2 * plane);
  P.idx_b = scratch + 3 * plane;
  P.pk = reinterpret_cast<int2*>(scratch + 4 * plane);
  P.tab = reinterpret_cast<float*>(scratch + 5 * plane);
  P.ut = reinterpret_cast<float*>(scratch + 6 * plane);
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
// (4, tb, n); on return plane 0 holds the sorted d2 (f32 bits) and plane 1
// the sorted train indices of each test row. For tests and diagnostics.
extern "C" int megakernel_rank_phase(const float* xb, const float* xtr,
                                     float* norms, int* scratch, int tb,
                                     int n, int d, int bf16, void* stream) {
  const size_t plane = (size_t)tb * n;
  Params P = {};
  P.xb = xb;
  P.xtr = xtr;
  P.norms = norms;
  P.keys_a = reinterpret_cast<uint32_t*>(scratch);
  P.idx_a = scratch + plane;
  P.keys_b = reinterpret_cast<uint32_t*>(scratch + 2 * plane);
  P.idx_b = scratch + 3 * plane;
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
