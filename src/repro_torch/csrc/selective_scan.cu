// Mamba-1's selective scan, fused: one thread per (row, channel) carries
// that channel's d_state-entry state in f32 registers across the sequence,
//
//   delta_t = softplus(dt_t)                  (dt: dt_proj's output + bias)
//   h_t     = exp(delta_t A) * h_{t-1} + delta_t B_t x_t
//   y_t     = (C_t . h_t + D x_t) * silu(z_t)
//
// and writes y once, in the inputs' type, with the final state (f32) for a
// prefill's cache. Nothing of size (b, s, d_inner, d_state) exists.
//
// x, dt: (b, s, di) float or bf16; z the same but `zs` elements apart from
// one position to the next (the gate half of in_proj's output, read where
// it lies); A: (di, 16) f32 (A = -exp(A_log)); B, C: (b, s, 16) f32; D:
// (di,) f32; h0: (b, di, 16) f32 or null (zeros); lengths: (b,) int32 or
// null (s); order: (b,) int32 or null, the rows in the order their blocks
// start (longest first, so that the longest rows do not start last). A
// row stops at its length: positions at or past it get y = 0 and leave
// the state alone, so the final state is the state at the row's length.
//
// A block holds 128 channels of one row; per round of CH positions it
// stages B and C in shared memory and each thread loads its x, dt and z
// for the round into registers before the dependent chain runs. exp(dt A)
// is one ex2.approx a channel-state (A is scaled by log2 e once).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CH = 16;
constexpr int DS = 16;  // d_state: every Mamba config of the port
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) selective_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ z,
    const T* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ Dv, const float* __restrict__ h0,
    const int* __restrict__ lengths, const int* __restrict__ order,
    T* __restrict__ y, float* __restrict__ h_out, int s, int di,
    long long zs) {
  __shared__ __align__(16) float sB[CH][DS];
  __shared__ __align__(16) float sC[CH][DS];
  const int b = order != nullptr ? order[blockIdx.y] : blockIdx.y;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const bool active = c < di;
  int len = s;
  if (lengths != nullptr) len = min(max(lengths[b], 0), s);
  float a[DS], h[DS];
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    a[n] = active ? A[(size_t)c * DS + n] * LOG2E : 0.f;
    h[n] = (active && h0 != nullptr) ? h0[((size_t)b * di + c) * DS + n]
                                     : 0.f;
  }
  const float d = active ? Dv[c] : 0.f;
  const size_t row = (size_t)b * s;
  for (int t0 = 0; t0 < len; t0 += CH) {
    const int nt = min(CH, len - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < CH * DS; i += THREADS) {
      const int j = i / DS, n = i % DS;
      if (j < nt) {
        sB[j][n] = Bm[(row + t0 + j) * DS + n];
        sC[j][n] = Cm[(row + t0 + j) * DS + n];
      }
    }
    __syncthreads();
    if (!active) continue;
    float xv[CH], dv[CH], zv[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j < nt) {
        const size_t off = (row + t0 + j) * di + c;
        xv[j] = load(x + off);
        dv[j] = load(dt + off);
        zv[j] = load(z + (row + t0 + j) * zs + c);
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j < nt) {
        // softplus as torch's (beta 1, threshold 20)
        const float delta = dv[j] > 20.f ? dv[j] : log1pf(__expf(dv[j]));
        const float dx = delta * xv[j];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < DS; ++n) {
          const float dA = ex2(delta * a[n]);
          h[n] = fmaf(dA, h[n], dx * sB[j][n]);
          acc = fmaf(sC[j][n], h[n], acc);
        }
        acc = fmaf(d, xv[j], acc);
        const float g = zv[j];
        store(y + (row + t0 + j) * di + c,
              acc * __fdividef(g, 1.f + __expf(-g)));
      }
    }
  }
  if (!active) return;
  for (int t = len; t < s; ++t) store(y + (row + t) * di + c, 0.f);
  if (h_out != nullptr) {
#pragma unroll
    for (int n = 0; n < DS; ++n) h_out[((size_t)b * di + c) * DS + n] = h[n];
  }
}

template <typename T>
int launch(const void* x, const void* z, const void* dt, const float* A,
           const float* B, const float* C, const float* D, const float* h0,
           const int* lengths, const int* order, void* y, float* h_out,
           int b, int s, int di, long long zs, cudaStream_t stream) {
  dim3 grid((di + THREADS - 1) / THREADS, b);
  selective_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(z),
      static_cast<const T*>(dt), A, B, C, D, h0, lengths, order,
      static_cast<T*>(y), h_out, s, di, zs);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float, 1 bf16; d_state is 16. Returns 0 or a CUDA error code.
extern "C" int selective_scan(int dtype, const void* x, const void* z,
                              const void* dt, const float* A, const float* B,
                              const float* C, const float* D, const float* h0,
                              const int* lengths, const int* order, void* y,
                              float* h_out, int b, int s, int di,
                              long long zs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || s == 0 || di == 0) return 0;
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, z, dt, A, B, C, D, h0, lengths, order,
                                 y, h_out, b, s, di, zs, st);
  return launch<float>(x, z, dt, A, B, C, D, h0, lengths, order, y, h_out,
                       b, s, di, zs, st);
}
