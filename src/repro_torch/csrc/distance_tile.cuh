// Device code of the squared-L2 distance, shared by `distance.cu` (the
// standalone kernel) and `sti_megakernel.cu` (its distance phase), so the
// two produce the same f32 bits on the same inputs.
//
// Per output element the cross term is one sequential f32 FMA chain over
// the feature index (k = 0, 1, ..., d - 1), the norms are one warp-shuffle
// reduction per row, and the epilogue is max(|a|^2 - 2 a.b + |b|^2, 0).
// See `distance.cu` for the design and what bounds it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dist_tile {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, THREADS = 256;

// both operand tiles of one k-step, staged transposed
struct Smem {
  float As[BK][BM + 4];
  float Bs[BK][BN + 4];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The value a cross-term operand takes: as stored, or rounded to bf16
// (round to nearest even, as torch's .to(torch.bfloat16)) when the
// megakernel runs its cross term in bf16 on f32 inputs.
template <bool ROUND_BF16, typename T>
__device__ __forceinline__ float operand(T v) {
  const float f = to_f32(v);
  return ROUND_BF16 ? __bfloat162float(__float2bfloat16_rn(f)) : f;
}

// sum_j row[j]^2 for one row, by the 32 lanes of a warp (lane-strided FMA,
// then a butterfly): every lane returns the same value.
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

// One BM x BN tile of squared distances at (row0, col0) of the (t, n)
// output, computed by all THREADS threads of the block (each a TM x TN
// register micro-tile). `store(r, c, v)` receives every in-range element.
// nt / nn hold the row squared norms of xt / xn. Ragged t, n and d are
// masked. Calls __syncthreads(): every thread of the block must call it.
template <bool ROUND_BF16, typename T, typename Store>
__device__ __forceinline__ void sq_dist_tile(
    const T* __restrict__ xt, const T* __restrict__ xn,
    const float* __restrict__ nt, const float* __restrict__ nn, int t, int n,
    int d, int row0, int col0, Smem& s, Store store) {
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK, gk = k0 + kk;
      const int ga = row0 + r, gb = col0 + r;
      s.As[kk][r] =
          (ga < t && gk < d) ? operand<ROUND_BF16>(xt[(size_t)ga * d + gk])
                             : 0.f;
      s.Bs[kk][r] =
          (gb < n && gk < d) ? operand<ROUND_BF16>(xn[(size_t)gb * d + gk])
                             : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s.As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s.Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= t) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      // explicit roundings: no FMA contraction, whichever kernel inlines
      // this, so every caller gets the bits of the plain expression
      if (c < n)
        store(r, c,
              fmaxf(__fadd_rn(__fsub_rn(nt[r], 2.f * acc[i][j]), nn[c]),
                    0.f));
    }
  }
}

}  // namespace dist_tile
