// Forward attention with an online softmax (flash attention) for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:72, body `_kernel`): for q (BH, s, d)
// and k, v (BH, sk, d), with K/V heads already repeated to match Q's,
//
//   out[q] = sum_k softmax_k(q.k / sqrt(d) over the visible k) v[k]
//
// where key k is visible to query q when k < sk, k <= q (causal) and
// k > q - window (window). Both kernels compute the function of
// `repro.kernels.ref.flash_attention_ref` and of the model's blockwise path
// (`repro.models.attention._blockwise_attn`): f32 logits, running max and
// denominator, masked entries contributing exactly 0, and the output
// acc / max(l, 1e-30) rounded once to the input type. The ragged edge
// (k >= sk) is masked by index, not by padding, so non-causal calls with a
// ragged sk see no padded key. A query row that sees no key at all (only
// possible when s > sk) gives 0, as the blockwise path does, where the
// oracle averages v.
//
// What bounds it: at the serving path's shape (b, h, s, d) =
// (1, 16, 2048, 128) bf16 causal the function needs 4 b h d s(s+1)/2 =
// 17.2 GFLOP, 0.017 ms over the 989 TFLOP/s of the bf16 tensor cores, while
// q, k, v and out are 33.6 MB (0.010 ms at 3.35 TB/s): it is bound by
// operations, on the tensor cores.
//
// bf16: a Hopper kernel (`flash_attention_wgmma_kernel`). Both products are
// `wgmma` with f32 accumulators; K/V tiles arrive by TMA; the softmax runs
// in the registers that the first product leaves its logits in.
//
//   - One CTA per (128-query tile, b*h): two consumer warpgroups of 64
//     query rows each and one producer warpgroup, which gives its
//     registers to the consumers (`setmaxnreg`: 40 and 232 a thread) and
//     of which one thread issues every load. The grid's fast axis is b*h,
//     so the heaviest causal q tiles of every head are dispatched first.
//     Key tiles of 64 that the causal or window mask removes whole are
//     never loaded; a warpgroup skips the tiles that mask all of its rows.
//   - The producer loads the Q tile once and keeps K/V tiles in a ring of
//     STAGES shared-memory stages (3 up to d = 192, else 2), each guarded
//     by a full barrier (TMA transaction bytes) and an empty barrier (one
//     arrival per consumer warp, after the products that read the stage
//     have retired). Tensor maps are 3-D over (b*h, rows, d), so a box
//     never crosses into the next head; TMA's zero fill covers the ragged
//     edge of each load (rows >= s or sk, columns >= d).
//   - Tiles are 64 columns (128 bytes) wide, the span of the 128-byte
//     swizzle, so the head dim is held in 64-column boxes (d <= 64, 128,
//     192, 256 -> 1-4 boxes; zero columns add nothing) and every box starts
//     on a 1024-byte boundary, as the swizzled `wgmma` descriptors need.
//   - S = Q.K^T: `wgmma m64n64k16` with both operands in shared memory,
//     K-major (K row-major is already the K-major B operand). In the
//     accumulator layout a row sits on the four lanes of a quad, so a row's
//     max and sum take two shuffles. Only tiles at the causal diagonal, the
//     window's edge or the ragged end are masked, by index. The logits are
//     kept in log2 units (scale * log2(e) folded in), so p = 2^(x - m) is
//     one `ex2` on the special-function unit.
//   - O += P.V: `wgmma m64n64k16` with P from registers (the accumulator
//     layout of S is the A-fragment layout of a 16-bit operand, so P is
//     packed in place) and V from shared memory, MN-major (transpose bit).
//   - A two-stage software pipeline in each warpgroup: tile t's Q.K^T and
//     tile t-1's P.V are issued together, and t's softmax runs while t-1's
//     P.V is still on the tensor cores; O is rescaled by t's factor once
//     that P.V has retired.
//   - Epilogue: the warpgroup writes acc / max(l, 1e-30) as bf16 into its
//     own Q tile in the swizzled layout and stores it with TMA, which
//     clips rows >= s and columns >= d.
//
// Why P is split: the check holds this kernel to one bf16 ulp (+ 2e-5) of
// the plain version, which keeps P in f32. Rounding P once to bf16 before
// P.V, as the Pallas body does, puts ~11 % of the outputs of a
// (1, 4, 1024, 128) causal call outside that bound; p = hi + lo with
// hi = bf16(p), lo = bf16(p - hi) carries 16 bits of p, and the two
// products hi.V and lo.V into one f32 accumulator put none outside it. The
// split costs a third product (1.5x the tensor work of the function).
//
// f32: the CUDA-core kernel (`flash_attention_kernel`), unchanged: one
// 256-thread block per (64-query tile, b*h), heaviest causal tiles first.
// The query tile is staged once in shared memory (transposed, f32); a loop
// over 64-key tiles -- the Pallas grid's sequential `ki` axis -- stages K
// (transposed) and V (row-major) in shared memory and skips tiles that the
// causal or window mask removes whole. Thread (ty, tx) owns rows ty + 16 i
// and columns tx + 16 j (i, j < 4) of the 64 x 64 logit tile; a row's max
// and sum are reduced across the 16 threads of a half-warp by shuffles, so
// every thread keeps the running max and denominator of its own four rows
// in registers, and rescales its own (4, D/16) slice of the f32 output
// accumulator. P goes through shared memory (in the K tile's place) to the
// P.V product. The head dimension is padded to the next of 32, 64, 128,
// 256 with zeros (which add nothing); at d = 128 a block takes 97 KB of
// dynamic shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float NEG = -1e30f;

// ------------------------------------------- f32: the CUDA-core kernel

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16

// kt (the K tile) and ps (the P tile) share one region: P is written after
// every thread is done reading K for the tile
template <int D>
__host__ __device__ constexpr int kp_rows() { return D > BQ ? D : BQ; }

template <int D>
constexpr size_t smem_bytes() {
  // qt [D][BQ + 1], kt [D][BK + 1] | ps [BQ][BK + 1], vs [BK][D]
  return sizeof(float) * ((size_t)D * (BQ + 1) +
                          (size_t)kp_rows<D>() * (BK + 1) + (size_t)BK * D);
}

// `rows` rows of `x` starting at `row0` (row stride d) into shared memory,
// zero past `n_rows` and past d. Transposed: dst[c * (R + 1) + r];
// else dst[r * D + c].
template <int D, int R, bool TRANSPOSE>
__device__ __forceinline__ void stage(const float* __restrict__ x, int row0,
                                      int n_rows, int d, float* dst) {
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    const float val = (row < n_rows && c < d) ? x[(size_t)row * d + c] : 0.f;
    if (TRANSPOSE)
      dst[c * (R + 1) + r] = val;
    else
      dst[r * D + c] = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int s, int sk, int d, float scale, int causal,
                       int window) {
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                          // [D][BQ + 1]
  float* kt = qt + D * (BQ + 1);             // [D][BK + 1]
  float* ps = kt;                            // [BQ][BK + 1], after K
  float* vs = kt + kp_rows<D>() * (BK + 1);  // [BK][D]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_qtiles = (s + BQ - 1) / BQ;
  const int q0 = (n_qtiles - 1 - (int)blockIdx.x) * BQ;  // heaviest first
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * (size_t)s * d;
  const float* kb = k + bh * (size_t)sk * d;
  const float* vb = v + bh * (size_t)sk * d;

  // key tiles that hold a visible key for some row of [q0, q0 + BQ)
  int k_end = sk;
  if (causal) k_end = min(k_end, q0 + BQ);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int kt_begin = k_begin / BK;
  const int kt_end = (k_end + BK - 1) / BK;

  stage<D, BQ, true>(qb, q0, s, d, qt);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = kt_begin; t < kt_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's P.V is done with ps and vs
    stage<D, BK, true>(kb, k0, sk, d, kt);
    stage<D, BK, false>(vb, k0, sk, d, vs);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[c * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kt[c * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }
    __syncthreads();  // every thread is done with kt before ps overwrites it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool vis[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx + 16 * j;
        vis[j] = ki < sk && (!causal || ki <= qi) &&
                 (window <= 0 || ki > qi - window);
        sc[i][j] = vis[j] ? sc[i][j] * scale : NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the 16 threads of a row are the 16 lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  float* ob = out + bh * (size_t)s * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= s) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ob[(size_t)qi * d + c] = acc[i][j] * inv;
    }
  }
}

template <int D>
int launch_f32_d(const void* q, const void* k, const void* v, void* out,
                 int bh, int s, int sk, int d, float scale, int causal,
                 int window, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((s + BQ - 1) / BQ, bh);
  flash_attention_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, sk, d,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------- bf16: the Hopper kernel (wgmma + TMA)

constexpr int WG = 128;                   // threads of a warpgroup
constexpr int CONSUMERS = 2;              // consumer warpgroups
constexpr int WQ = 64;                    // query rows per warpgroup
constexpr int HQ = CONSUMERS * WQ;        // query rows per CTA
constexpr int HK = 64;                    // keys per tile
static_assert(WQ == HK, "Q and K boxes share their offsets in issue_qk");
constexpr int BOX = 64;                   // columns per box: 128 bytes
constexpr int ROW_BYTES = BOX * 2;        // one box row, the swizzle span
constexpr int H_THREADS = (CONSUMERS + 1) * WG;  // + a producer warpgroup
constexpr int CONSUMER_WARPS = CONSUMERS * WG / 32;
// registers a thread after `setmaxnreg`: the producer warpgroup gives up
// what the consumers take (launch: 168 each, 65536 over 384 threads)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

template <int DP>
struct HLayout {
  static constexpr int NB = DP / BOX;                  // boxes per row
  static constexpr int STAGES = DP <= 192 ? 3 : 2;     // K/V ring depth
  static constexpr int Q_BOX = WQ * ROW_BYTES;         // 8 KB
  static constexpr int Q_WG = NB * Q_BOX;              // one warpgroup's Q
  static constexpr int KV_BOX = HK * ROW_BYTES;        // 8 KB
  static constexpr int KV_STAGE = NB * KV_BOX;         // K (or V) of a stage
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = CONSUMERS * Q_WG;
  static constexpr int V_OFF = K_OFF + STAGES * KV_STAGE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_STAGE;
  // full[STAGES], empty[STAGES], q: 8 bytes each; +1024 to align the base
  static constexpr size_t BYTES = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

// after wgmma_wait: P's registers, which the P.V products read until they
// retire, stay live (and unreused) until then
__device__ __forceinline__ void fence_p(uint32_t (*p_hi)[4],
                                        uint32_t (*p_lo)[4]) {
#pragma unroll
  for (int kk = 0; kk < HK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile("" : "+r"(p_hi[kk][j]), "+r"(p_lo[kk][j])::"memory");
}

#define ACC32_REGS                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define ACC32_OPERANDS(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64); A and B in shared
// memory, both K-major; `accumulate` = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32_OPERANDS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16) . B (16 x 64); A from registers (four
// bf16x2 per thread, the A-fragment layout), B in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// 2^x on the special-function unit (results below 2^-126 flush to 0; a
// p that small adds nothing next to the row's largest, which is 1)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q.K^T for one warpgroup: 64 x 64 logits from its Q tile and a K
// stage, DP / 16 products of 16 columns; issued and committed, not waited
template <int NB>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t q_tile,
                                         uint32_t k_stage) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NB * 4; ++kk) {
    // box kk / 4, 16 columns = 32 bytes into its swizzled 128-byte rows
    const uint32_t off = (kk / 4) * WQ * ROW_BYTES + (kk % 4) * 32;
    wgmma_ss(sc, sw128_desc(q_tile + off, 16), sw128_desc(k_stage + off, 16),
             1);
  }
  wgmma_commit();
}

// O += P.V for one warpgroup: P as hi + lo from registers, one 64-column
// box of O at a time; issued and committed, not waited
template <int NB>
__device__ __forceinline__ void issue_pv(float (*o)[32],
                                         uint32_t (*p_hi)[4],
                                         uint32_t (*p_lo)[4],
                                         uint32_t v_stage) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HK / 16; ++kk)
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const uint64_t dv = sw128_desc(
          v_stage + b * HK * ROW_BYTES + kk * 16 * ROW_BYTES, HK * ROW_BYTES);
      wgmma_rs(o[b], p_hi[kk], dv);
      wgmma_rs(o[b], p_lo[kk], dv);
    }
  wgmma_commit();
}

// The online softmax of one 64 x 64 tile in a warpgroup's registers:
// sc[4 n8 + 2 h + j] holds the logit of row qrow[h] and key
// k0 + 8 n8 + 2 (lane % 4) + j. On return sc holds p (f32), the running
// max m (log2 units) and denominator l of the thread's two rows are
// updated, and alpha[h] is the factor that rescales row h's accumulator.
__device__ __forceinline__ void online_softmax(float* sc, float* m, float* l,
                                               float* alpha, const int* qrow,
                                               int k0, bool edge, int sk,
                                               int causal, int window,
                                               float scale2, int lane) {
  uint32_t vis = 0xffffffffu;
  float mx[2] = {NEG, NEG};
  if (edge) {
    const int kc = k0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2, key = kc + 8 * (i / 4) + i % 2;
      const bool v = key < sk && (!causal || key <= qrow[h]) &&
                     (window <= 0 || key > qrow[h] - window);
      if (!v) vis &= ~(1u << i);
      sc[i] = v ? sc[i] * scale2 : NEG;
      mx[h] = fmaxf(mx[h], sc[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] *= scale2;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // a row's 64 logits lie on the four lanes of a quad
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = exp2_approx(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i / 2) % 2;
    sc[i] = (vis >> i) & 1u ? exp2_approx(sc[i] - m[h]) : 0.f;
    sum[h] += sc[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * alpha[h] + sum[h];
  }
}

// O *= alpha row by row, and P (in sc) as the A operand of P.V: the 16-key
// slice kk is sc[8 kk .. 8 kk + 7] packed pairwise (the accumulator layout
// is the A-fragment layout of a 16-bit operand), split p = hi + lo
template <int NB>
__device__ __forceinline__ void rescale_and_split(float (*o)[32],
                                                  const float* alpha,
                                                  const float* sc,
                                                  uint32_t (*p_hi)[4],
                                                  uint32_t (*p_lo)[4]) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[b][i] *= alpha[(i / 2) % 2];
#pragma unroll
  for (int kk = 0; kk < HK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = sc[8 * kk + 2 * j], b = sc[8 * kk + 2 * j + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
      p_hi[kk][j] = bf16x2_bits(hi);
      p_lo[kk][j] = bf16x2_bits(
          __floats2bfloat162_rn(a - __low2float(hi), b - __high2float(hi)));
    }
}

template <int DP>
__global__ void __launch_bounds__(H_THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap to, int s,
                             int sk, float scale, int causal, int window) {
  using L = HLayout<DP>;
  constexpr int NB = L::NB, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::Q_OFF, sks = base + L::K_OFF,
                 svs = base + L::V_OFF, bars = base + L::BAR_OFF;
  const uint32_t q_bar = bars + 16 * STAGES;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * HQ;  // heaviest first
  const int q_end = min(q0 + HQ, s);
  // key tiles that hold a visible key for some row of [q0, q_end)
  int k_begin = 0, k_end = sk;
  if (causal) k_end = min(k_end, q_end);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin / HK;
  const int t_end = k_end > k_begin ? (k_end + HK - 1) / HK : t_begin;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), CONSUMER_WARPS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---- producer warpgroup: gives registers to the consumers; one
    // thread loads Q once, then K/V tiles into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(q_bar, HQ * NB * ROW_BYTES);
      for (int w = 0; w < CONSUMERS; ++w)
        for (int b = 0; b < NB; ++b)
          tma_load(sq + w * L::Q_WG + b * L::Q_BOX, &tq, q_bar, b * BOX,
                   q0 + w * WQ, bh);
      int st = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        mbar_wait(empty(st), phase ^ 1);
        mbar_expect_tx(full(st), 2 * L::KV_STAGE);
        for (int b = 0; b < NB; ++b) {
          tma_load(sks + st * L::KV_STAGE + b * L::KV_BOX, &tk, full(st),
                   b * BOX, t * HK, bh);
          tma_load(svs + st * L::KV_STAGE + b * L::KV_BOX, &tv, full(st),
                   b * BOX, t * HK, bh);
        }
        if (++st == STAGES) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [wq0, wq0 + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4;
  const int wq0 = q0 + wg * WQ;
  const bool has_rows = wq0 < s;
  // the rows of this thread: r and r + 8 of the warpgroup's tile
  const int r = (warp % 4) * 16 + lane / 4;
  const int qrow[2] = {wq0 + r, wq0 + r + 8};
  // the tiles of [t_begin, t_end) that hold a visible key for one of this
  // warpgroup's rows; it waits for and releases the others unread
  int wk_begin = 0, wk_end = sk;
  if (causal) wk_end = min(wk_end, min(wq0 + WQ, s));
  if (window > 0) wk_begin = max(0, wq0 - window + 1);
  int wt_begin = max(t_begin, wk_begin / HK);
  int wt_end = min(t_end, (wk_end + HK - 1) / HK);
  if (!has_rows || wt_end <= wt_begin) wt_begin = wt_end = t_end;
  const uint32_t q_tile = sq + wg * L::Q_WG;
  // logits in log2 units: p = 2^(x - m) with x = q.k * scale * log2(e)
  const float scale2 = scale * 1.4426950408889634f;

  float o[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[b][i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float sc[32];
  uint32_t p_hi[HK / 16][4], p_lo[HK / 16][4];

  mbar_wait(q_bar, 0);
  int st = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++st == STAGES) {
      st = 0;
      phase ^= 1;
    }
  };
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));
  };
  for (int t = t_begin; t < wt_begin; ++t, advance()) {
    mbar_wait(full(st), phase);
    release(st);
  }
  // Software pipeline: tile t's Q.K^T and tile t-1's P.V are issued
  // together, and t's softmax runs while t-1's P.V is on the tensor cores.
  // The first tile is peeled, so that no product is issued under a branch.
  auto tile_edge = [&](int k0) {
    // only a tile at the causal diagonal, the window's lower edge or the
    // ragged end needs the mask
    return k0 + HK > sk || (causal && k0 + HK - 1 > wq0) ||
           (window > 0 && k0 <= wq0 + WQ - 1 - window);
  };
  if (wt_begin < wt_end) {
    float alpha[2];
    mbar_wait(full(st), phase);
    issue_qk<NB>(sc, q_tile, sks + st * L::KV_STAGE);
    wgmma_wait<0>();
    fence_acc(sc);
    online_softmax(sc, m, l, alpha, qrow, wt_begin * HK,
                   tile_edge(wt_begin * HK), sk, causal, window, scale2, lane);
    rescale_and_split<NB>(o, alpha, sc, p_hi, p_lo);
    int prev = st;  // the stage whose P waits in p_hi / p_lo for its P.V
    advance();
    for (int t = wt_begin + 1; t < wt_end; ++t, advance()) {
      mbar_wait(full(st), phase);
      issue_qk<NB>(sc, q_tile, sks + st * L::KV_STAGE);
      issue_pv<NB>(o, p_hi, p_lo, svs + prev * L::KV_STAGE);
      wgmma_wait<1>();  // Q.K^T retired; P.V may still run
      fence_acc(sc);
      online_softmax(sc, m, l, alpha, qrow, t * HK, tile_edge(t * HK), sk,
                     causal, window, scale2, lane);
      wgmma_wait<0>();  // the previous tile's P.V retired
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_acc(o[b]);
      fence_p(p_hi, p_lo);
      release(prev);
      rescale_and_split<NB>(o, alpha, sc, p_hi, p_lo);
      prev = st;
    }
    issue_pv<NB>(o, p_hi, p_lo, svs + prev * L::KV_STAGE);
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_acc(o[b]);
    fence_p(p_hi, p_lo);
    release(prev);
  }
  for (int t = wt_end; t < t_end; ++t, advance()) {
    mbar_wait(full(st), phase);
    release(st);
  }

  if (!has_rows) return;
  // epilogue: acc / max(l, 1e-30) as bf16 into this warpgroup's Q tile,
  // 128-byte swizzled (16-byte chunk c of row r at chunk c ^ (r % 8)), then
  // one TMA store per box, which writes no row >= s and no column >= d
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;
        const uint32_t addr = q_tile + b * L::Q_BOX + row * ROW_BYTES +
                              ((n8 ^ (row % 8)) * 16) + (lane % 4) * 4;
        const uint32_t bits = bf16x2_bits(__floats2bfloat162_rn(
            o[b][4 * n8 + 2 * h] * inv[h], o[b][4 * n8 + 2 * h + 1] * inv[h]));
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(bits)
                     : "memory");
      }
  // the generic-proxy writes above are read by TMA (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(WG) : "memory");
  if (threadIdx.x % WG == 0) {
    for (int b = 0; b < NB; ++b)
      tma_store(&to, q_tile + b * L::Q_BOX, b * BOX, wq0, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// a 3-D map over x (bh, rows, d) bf16 with (64 columns, box_rows, 1) boxes,
// 128-byte swizzle, zero fill out of bounds
bool encode(EncodeTiled fn, CUtensorMap* map, const void* x, int bh,
            int rows, int d, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {BOX, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch_bf16_d(const CUtensorMap& tq, const CUtensorMap& tk,
                  const CUtensorMap& tv, const CUtensorMap& to, int bh,
                  int s, int sk, float scale, int causal, int window,
                  cudaStream_t stream) {
  constexpr size_t bytes = HLayout<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, (s + HQ - 1) / HQ);
  flash_attention_wgmma_kernel<DP><<<grid, H_THREADS, bytes, stream>>>(
      tq, tk, tv, to, s, sk, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. q, out: (bh, s, d); k, v: (bh, sk, d);
// contiguous device pointers of one type; 0 < d <= 256. `window` <= 0 means
// no window. `stream` is a cudaStream_t. Returns cudaGetLastError() after
// the launch (or the error of setting the shared-memory attribute).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int bh, int s,
                                   int sk, int d, float scale, int causal,
                                   int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_f32_d<32>(q, k, v, out, bh, s, sk, d, scale, causal,
                            window, st);
  if (d <= 64)
    return launch_f32_d<64>(q, k, v, out, bh, s, sk, d, scale, causal,
                            window, st);
  if (d <= 128)
    return launch_f32_d<128>(q, k, v, out, bh, s, sk, d, scale, causal,
                             window, st);
  if (d <= 256)
    return launch_f32_d<256>(q, k, v, out, bh, s, sk, d, scale, causal,
                             window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 kernel also needs d % 8 == 0 (TMA's 16-byte row strides; the
// wrapper zero-pads other head dims) and 16-byte aligned pointers (the
// wrapper copies a misaligned view to a fresh allocation). Returns
// -1 when the driver's cuTensorMapEncodeTiled cannot be reached, -2 when a
// tensor map is refused.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int bh, int s,
                                    int sk, int d, float scale, int causal,
                                    int window, void* stream) {
  if (d <= 0 || d > 256 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  CUtensorMap tq, tk, tv, to;
  if (!encode(fn, &tq, q, bh, s, d, WQ) || !encode(fn, &tk, k, bh, sk, d, HK) ||
      !encode(fn, &tv, v, bh, sk, d, HK) || !encode(fn, &to, out, bh, s, d, WQ))
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_bf16_d<64>(tq, tk, tv, to, bh, s, sk, scale, causal, window,
                             st);
  if (d <= 128)
    return launch_bf16_d<128>(tq, tk, tv, to, bh, s, sk, scale, causal,
                              window, st);
  if (d <= 192)
    return launch_bf16_d<192>(tq, tk, tv, to, bh, s, sk, scale, causal,
                              window, st);
  return launch_bf16_d<256>(tq, tk, tv, to, bh, s, sk, scale, causal, window,
                            st);
}
