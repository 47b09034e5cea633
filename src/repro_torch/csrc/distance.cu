// Squared L2 distances for the STI-KNN streaming step, for sm_90a.
//
// Replaces the Pallas TPU kernel `distance_pallas` (src/repro/kernels/
// distance.py, body `_kernel`): out[i, j] = max(|a_i|^2 - 2 a_i.b_j +
// |b_j|^2, 0) for a = x_test (t, d) and b = x_train (n, d), with f32
// accumulation and f32 or bf16 inputs.
//
// What bounds it here: at the main path's shape (t = 256, n = 65536,
// d = 768) the cross term is 2 t n d = 2.6e10 float operations against
// 67 TFLOP/s of f32 FMA outside the tensor cores, and the bytes (x_train
// once, the (t, n) output once) are ~0.27 GB against 3.35 TB/s: it is
// bound by operations. The f32 path must not use TF32 tensor cores, so
// that ranks on integer-valued features match the plain version bit for
// bit; it runs on the CUDA cores.
//
// Design: a pre-pass writes the row squared norms of both operands (one
// warp per row). The main kernel is a shared-memory tiled product, one
// 64 x 64 output tile per 256-thread block, each thread a 4 x 4 register
// micro-tile, the k-loop over d in steps of 16 with both operand tiles
// staged transposed in shared memory (converted to f32 as they are
// staged), and the JAX kernel's norm epilogue fused into the store.
// Ragged t, n and d are masked. wgmma/TMA are later work. The tile and
// norm code lives in `distance_tile.cuh`, which the megakernel's distance
// phase shares, so both give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "distance_tile.cuh"

namespace {

using dist_tile::BM;
using dist_tile::BN;
using dist_tile::THREADS;

template <typename T>
__global__ void sq_norms_kernel(const T* __restrict__ x, int rows, int d,
                                float* __restrict__ out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;  // whole warp leaves together
  const float s = dist_tile::row_sq_norm(x + (size_t)warp * d, d, lane);
  if (lane == 0) out[warp] = s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sq_dist_kernel(const T* __restrict__ xt, const T* __restrict__ xn,
               const float* __restrict__ nt, const float* __restrict__ nn,
               float* __restrict__ out, int t, int n, int d) {
  __shared__ dist_tile::Smem s;
  dist_tile::sq_dist_tile<false>(
      xt, xn, nt, nn, t, n, d, blockIdx.y * BM, blockIdx.x * BN, s,
      [out, n](int r, int c, float v) { out[(size_t)r * n + c] = v; });
}

template <typename T>
int launch(const void* xt, const void* xn, float* nt, float* nn, float* out,
           int t, int n, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(xt);
  const T* b = static_cast<const T*>(xn);
  const int warps_per_block = 8;
  sq_norms_kernel<T><<<(t + warps_per_block - 1) / warps_per_block,
                       32 * warps_per_block, 0, s>>>(a, t, d, nt);
  sq_norms_kernel<T><<<(n + warps_per_block - 1) / warps_per_block,
                       32 * warps_per_block, 0, s>>>(b, n, d, nn);
  dim3 grid((n + BN - 1) / BN, (t + BM - 1) / BM);
  sq_dist_kernel<T><<<grid, THREADS, 0, s>>>(a, b, nt, nn, out, t, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. `nt` (t,) and `nn` (n,) are f32 scratch
// for the norms; all pointers are device pointers; `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the launches.
extern "C" int sq_dist_f32(const void* xt, const void* xn, float* nt,
                           float* nn, float* out, int t, int n, int d,
                           void* stream) {
  return launch<float>(xt, xn, nt, nn, out, t, n, d, stream);
}

extern "C" int sq_dist_bf16(const void* xt, const void* xn, float* nt,
                            float* nn, float* out, int t, int n, int d,
                            void* stream) {
  return launch<__nv_bfloat16>(xt, xn, nt, nn, out, t, n, d, stream);
}
