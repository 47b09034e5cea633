// Device code of the squared-L2 distance, shared by `distance.cu` (the
// standalone kernel) and `sti_megakernel.cu` (its distance phase), so the
// two issue the same `wgmma` sequence on the same operands and produce the
// same f32 bits.
//
// A tile is BM = 128 train points (two warpgroups of 64, the wgmma M side)
// by BN = 256 test points (the wgmma N side), and d is walked in k-steps of
// one 128-byte row: 32 f32 or 64 bf16 columns. Each operand tile lies in
// shared memory K-major (rows as they sit in memory), 128-byte swizzled on
// a 1024-byte boundary, which is both TMA's SWIZZLE_128B layout and the
// layout the wgmma descriptors read.
//
// f32 ("3xTF32"): a . b = hi_a hi_b + hi_a lo_b + lo_a hi_b + lo_a lo_b,
// with hi = x with its low 13 mantissa bits cleared (a TF32 value) and
// lo = x - hi (exact in f32). The product drops lo_a lo_b (~2^-22 of
// |a||b| per product) and the tensor cores read lo as TF32. Integer
// features up to |x| <= 2047 have lo = 0, so every product is exact and
// the distances equal the plain version's whenever its sums are exact.
// The train tile's hi and lo are formed in registers (the A operand); the
// test tile's are written to shared memory beside each other (B and L).
// Per 8-column step the passes run small terms first: hi_train . lo_test,
// lo_train . hi_test, hi_train . hi_test, into one f32 accumulator.
// bf16: one `m64n256k16` pass per 16 columns, both operands from shared
// memory (bf16 products are exact in f32).
//
// The norms are one warp-shuffle reduction per row (`row_sq_norm`), and
// the epilogue is max(|a|^2 - 2 a.b + |b|^2, 0) with explicit roundings.
// See `distance.cu` for what bounds it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace dist_tile {

constexpr int WG = 128;            // threads of a warpgroup
constexpr int WM = 64;             // train rows of a warpgroup (wgmma M)
constexpr int BM = 2 * WM;         // train rows of a tile: two warpgroups
constexpr int BN = 256;            // test rows of a tile (wgmma N)
constexpr int ROW = 128;           // bytes of a tile row: the swizzle span
constexpr int A_BYTES = BM * ROW;  // 16 KB: the train tile
constexpr int B_BYTES = BN * ROW;  // 32 KB: the test tile (its hi for f32)
// one k-step: A (train), B (test, or its hi), L (test lo, f32 only)
constexpr int A_OFF = 0, B_OFF = A_BYTES, L_OFF = A_BYTES + B_BYTES;
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;  // 80 KB
constexpr int CHUNKS = ROW / 16;   // 16-byte chunks of a row
constexpr uint32_t HI_MASK = 0xffffe000u;  // the TF32 bits of an f32

// columns of d in one k-step
template <typename T>
__host__ __device__ constexpr int kstep_cols() {
  return ROW / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// sum_j row[j]^2 for one row, by the 32 lanes of a warp (lane-strided FMA,
// then a butterfly): every lane returns the same value. Zero columns past
// the row's end leave it unchanged, bit for bit.
template <typename T>
__device__ __forceinline__ float row_sq_norm(const T* __restrict__ row, int d,
                                             int lane) {
  float s = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = to_f32(row[j]);
    s = fmaf(v, v, s);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint4 lds_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// the TF32 part of x, and what is left
__device__ __forceinline__ uint32_t hi_bits(uint32_t x) { return x & HI_MASK; }
__device__ __forceinline__ uint32_t lo_bits(uint32_t x) {
  return __float_as_uint(__fsub_rn(__uint_as_float(x),
                                   __uint_as_float(x & HI_MASK)));
}

// one 16-byte chunk of four f32 split into its hi and lo chunks
__device__ __forceinline__ void split4(uint4 x, uint4& hi, uint4& lo) {
  hi = make_uint4(hi_bits(x.x), hi_bits(x.y), hi_bits(x.z), hi_bits(x.w));
  lo = make_uint4(lo_bits(x.x), lo_bits(x.y), lo_bits(x.z), lo_bits(x.w));
}

#define ACC128_REGS                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "    \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "    \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "    \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "        \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "        \
  "%122, %123, %124, %125, %126, %127}"
#define ACC128_OPERANDS(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),       \
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),       \
      "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),       \
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),       \
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),       \
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),       \
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),       \
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),      \
      "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),  \
      "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),  \
      "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),  \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),  \
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),  \
      "+f"(d[126]), "+f"(d[127])

// d (64 x 256, f32) += A (64 x 8, TF32 from registers: the A-fragment
// layout) . B (8 x 256, TF32 in shared memory, K-major)
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 " ACC128_REGS
      ", {%128, %129, %130, %131}, %132, p, 1, 1;\n"
      "}\n"
      : ACC128_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256, f32) += A (64 x 16) . B (16 x 256), bf16, both in shared
// memory, K-major
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ACC128_REGS
      ", %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC128_OPERANDS(d)
      : "l"(a), "l"(b), "r"(1));
}

#undef ACC128_REGS
#undef ACC128_OPERANDS

// The train tile's A fragments of one 8-column step, split: register j
// of this thread holds row 16 w + lane / 4 + 8 (j % 2) and column
// 8 kk + lane % 4 + 4 (j / 2) of the warpgroup's 64 rows at `a`
// (w = the thread's warp within its warpgroup). Two sets alternate, so
// one 8-column step's products can run while the next one's fragments
// load, and the accumulator (128 registers) and the fragments (16) stay
// within the 168 registers a thread of a 384-thread block has.
struct TF32Frags {
  uint32_t hi[2][4], lo[2][4];
};

__device__ __forceinline__ void load_frags(uint32_t* hi, uint32_t* lo,
                                           uint32_t a, int kk) {
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row = w * 16 + lane / 4, col = (lane % 4) * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = row + 8 * (j % 2);
    const uint32_t x = __float_as_uint(
        lds_f32(a + sm90::sw128_offset(r, 2 * kk + j / 2) + col));
    hi[j] = hi_bits(x);
    lo[j] = lo_bits(x);
  }
}

// One f32 k-step (32 columns) of one warpgroup: acc (64 train x 256 test)
// += A . B^T in 3xTF32, with A the warpgroup's 64 rows at `a` and the
// test tile's hi at `bh`, lo at `bl`. Each 8-column step is one commit
// group of three products; before a fragment set is reloaded, the group
// that read it retires (wgmma_wait<1>), so on return every group of the
// previous k-step has retired and at most two of this one are in flight.
// `f` must stay untouched until they retire.
__device__ __forceinline__ void kstep_tf32(float* acc, TF32Frags& f,
                                           uint32_t a, uint32_t bh,
                                           uint32_t bl) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t* hi = f.hi[kk % 2];
    uint32_t* lo = f.lo[kk % 2];
    sm90::wgmma_wait<1>();
    sm90::fence_regs<4>(hi);
    sm90::fence_regs<4>(lo);
    load_frags(hi, lo, a, kk);
    sm90::wgmma_fence();
    // 8 f32 columns = 32 bytes into the swizzled 128-byte rows
    const uint64_t dh = sm90::sw128_desc(bh + kk * 32, 16);
    const uint64_t dl = sm90::sw128_desc(bl + kk * 32, 16);
    wgmma_tf32(acc, hi, dl);  // hi_train . lo_test
    wgmma_tf32(acc, lo, dh);  // lo_train . hi_test
    wgmma_tf32(acc, hi, dh);  // hi_train . hi_test
    sm90::wgmma_commit();
  }
}

// One bf16 k-step (64 columns) of one warpgroup, issued and committed, not
// waited: acc += A . B^T with A the warpgroup's 64 rows at `a`, B at `b`.
__device__ __forceinline__ void kstep_bf16(float* acc, uint32_t a,
                                           uint32_t b) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_bf16(acc, sm90::sw128_desc(a + kk * 32, 16),
               sm90::sw128_desc(b + kk * 32, 16));
  sm90::wgmma_commit();
}

// after the products of a k-step retired: the accumulator and the A
// fragments they used are the thread's again
__device__ __forceinline__ void retire(float* acc, TF32Frags& f) {
  sm90::fence_acc<128>(acc);
  sm90::fence_regs<8>(&f.hi[0][0]);
  sm90::fence_regs<8>(&f.lo[0][0]);
}

// The test tile of an f32 k-step at `b` split in place: b keeps hi, `l`
// receives lo. The calling threads take 16-byte chunks first, first +
// step, ...; the split maps each chunk to the same offset, so it holds for
// any layout of the tile.
__device__ __forceinline__ void split_in_place(uint32_t b, uint32_t l,
                                               int first, int step) {
  for (int i = first; i < BN * CHUNKS; i += step) {
    uint4 hi, lo;
    split4(lds_v4(b + 16 * i), hi, lo);
    sts_v4(b + 16 * i, hi);
    sts_v4(l + 16 * i, lo);
  }
}

// The first of the two train rows (r and r + 8) of this thread's
// accumulator elements in a warpgroup tile at train row `train0`.
__device__ __forceinline__ int acc_row(int train0) {
  return train0 + ((threadIdx.x / 32) % 4) * 16 + (threadIdx.x % 32) / 4;
}

// The epilogue of one warpgroup's 64 x 256 accumulator: store(test, train,
// d2) for every in-range element, d2 = max(nt - 2 acc + nr, 0) rounded as
// written (no FMA contraction, whichever kernel inlines this). Element i of
// acc is train row acc_row(train0) + 8 ((i / 2) % 2), whose squared norm
// is nr[(i / 2) % 2], and test row test0 + 8 (i / 4) + 2 (lane % 4) + i % 2.
template <typename Store>
__device__ __forceinline__ void epilogue(const float* acc,
                                         const float* __restrict__ nt,
                                         const float (&nr)[2], int t, int n,
                                         int test0, int train0, Store store) {
  const int r = acc_row(train0);
  const int c = test0 + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    const int h = (i / 2) % 2;
    const int tr = r + 8 * h, te = c + 8 * (i / 4) + i % 2;
    if (tr < n && te < t)
      store(te, tr,
            fmaxf(__fadd_rn(__fsub_rn(nt[te], 2.f * acc[i]), nr[h]), 0.f));
  }
}

// 16 bytes of row `row` (of `rows`, row stride d) from column `col` (a
// multiple of 4), as four f32; zero past the row's end and past the last
// row. The rows must be 16-byte aligned with d % 4 == 0: the wrappers pad
// d with zero columns (`kernels/distance.py::tma_operands`, the contract
// TMA sets for `distance.cu`), so a ragged d reaches both kernels alike.
__device__ __forceinline__ float4 load4(const float* __restrict__ x, int row,
                                        int rows, int col, int d) {
  if (row >= rows || col >= d) return make_float4(0.f, 0.f, 0.f, 0.f);
  return *reinterpret_cast<const float4*>(x + (size_t)row * d + col);
}

__device__ __forceinline__ uint32_t bf16x2_rn(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One k-step of the tile at (test0, train0) staged from f32 rows in global
// memory by the block's THREADS threads, into the stage at `buf` in the
// layout TMA gives `distance.cu`: A <- x_train, and the test tile split
// into hi (B) and lo (L), or, with ROUND_BF16, both tiles rounded to bf16
// (round to nearest even, as torch's .to(torch.bfloat16)) for a bf16
// k-step. Rows past n or t and columns past d are zero. Each thread loads
// GROUP chunks before it stores them, so their loads are in flight
// together.
template <bool ROUND_BF16, int THREADS>
__device__ __forceinline__ void stage_tile(uint32_t buf,
                                           const float* __restrict__ xt,
                                           const float* __restrict__ xn,
                                           int t, int n, int d, int test0,
                                           int train0, int k0) {
  constexpr int GROUP = 4;
  constexpr int TRAIN = BM * CHUNKS, TOTAL = (BM + BN) * CHUNKS;
  static_assert(TRAIN % (GROUP * THREADS) == 0 &&
                    TOTAL % (GROUP * THREADS) == 0,
                "a group of chunks is all train or all test");
  constexpr int LOADS = ROUND_BF16 ? 2 : 1;  // float4 loads per chunk
#pragma unroll 1
  for (int g = 0; g < TOTAL; g += GROUP * THREADS) {
    const bool train = g < TRAIN;  // uniform over the block
    const float* x = train ? xn : xt;
    const int rows = train ? n : t;
    const int row0 = train ? train0 : test0;
    float4 v[GROUP][LOADS];
    uint32_t off[GROUP];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int e = g + u * THREADS + threadIdx.x - (train ? 0 : TRAIN);
      const int row = e / CHUNKS, ch = e % CHUNKS;
      off[u] = sm90::sw128_offset(row, ch);
#pragma unroll
      for (int q = 0; q < LOADS; ++q)
        v[u][q] = load4(x, row0 + row, rows, k0 + (4 * LOADS) * ch + 4 * q,
                        d);
    }
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      if (ROUND_BF16) {
        const float4 a = v[u][0], b = v[u][LOADS - 1];
        sts_v4(buf + (train ? A_OFF : B_OFF) + off[u],
               make_uint4(bf16x2_rn(a.x, a.y), bf16x2_rn(a.z, a.w),
                          bf16x2_rn(b.x, b.y), bf16x2_rn(b.z, b.w)));
      } else {
        const float4 a = v[u][0];
        const uint4 bits =
            make_uint4(__float_as_uint(a.x), __float_as_uint(a.y),
                       __float_as_uint(a.z), __float_as_uint(a.w));
        if (train) {
          sts_v4(buf + A_OFF + off[u], bits);
        } else {
          uint4 hi, lo;
          split4(bits, hi, lo);
          sts_v4(buf + B_OFF + off[u], hi);
          sts_v4(buf + L_OFF + off[u], lo);
        }
      }
    }
  }
}

// One whole tile by a block of two warpgroups (256 threads) with no
// producer: each k-step is staged by all threads (`stage_tile`) into one
// of two stages at `smem` (2 * STAGE_BYTES, 1024-byte aligned) while the
// previous one's products run, then every warpgroup runs the k-step
// function that `distance.cu`'s consumers run on their TMA tiles, so the
// bits are the same. Calls __syncthreads(): every thread of the block must
// call it, and THREADS must be 2 * WG.
template <bool ROUND_BF16, int THREADS, typename Store>
__device__ __forceinline__ void block_tile(const float* __restrict__ xt,
                                           const float* __restrict__ xn,
                                           const float* __restrict__ nt,
                                           const float* __restrict__ nn,
                                           int t, int n, int d, int test0,
                                           int train0, uint32_t smem,
                                           Store store) {
  constexpr int KC = ROUND_BF16 ? kstep_cols<__nv_bfloat16>()
                                : kstep_cols<float>();
  const int wg = threadIdx.x / WG;
  const int steps = (d + KC - 1) / KC;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  TF32Frags f;
  stage_tile<ROUND_BF16, THREADS>(smem, xt, xn, t, n, d, test0, train0, 0);
  sm90::fence_proxy_async();
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const uint32_t buf = smem + (s % 2) * STAGE_BYTES;
    if (ROUND_BF16)
      kstep_bf16(acc, buf + A_OFF + wg * WM * ROW, buf + B_OFF);
    else
      kstep_tf32(acc, f, buf + A_OFF + wg * WM * ROW, buf + B_OFF,
                 buf + L_OFF);
    // the next k-step into the other stage, whose products retired before
    // the last barrier
    if (s + 1 < steps)
      stage_tile<ROUND_BF16, THREADS>(smem + ((s + 1) % 2) * STAGE_BYTES, xt,
                                      xn, t, n, d, test0, train0,
                                      (s + 1) * KC);
    sm90::wgmma_wait<0>();
    if constexpr (ROUND_BF16)
      sm90::fence_acc<128>(acc);
    else
      retire(acc, f);
    sm90::fence_proxy_async();
    __syncthreads();
  }
  const int row = acc_row(train0 + wg * WM);
  const float nr[2] = {row < n ? nn[row] : 0.f,
                       row + 8 < n ? nn[row + 8] : 0.f};
  epilogue(acc, nt, nr, t, n, test0, train0 + wg * WM, store);
}

}  // namespace dist_tile
