// Forward attention with an online softmax (flash attention) for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_kernel`): for q (BH, s, d)
// and k, v (BH, sk, d), with K/V heads already repeated to match Q's,
//
//   out[q] = sum_k softmax_k(q.k / sqrt(d) over the visible k) v[k]
//
// where key k is visible to query q when k < sk, k <= q (causal) and
// k > q - window (window). All arithmetic is f32 on the CUDA cores for f32
// and bf16 inputs alike (bf16 is widened as it is staged): the logits, P
// and P.V are f32, masked entries contribute exactly 0, and the output
// acc / max(l, 1e-30) is rounded once to the input type. This is the
// function of `repro.kernels.ref.flash_attention_ref` and of the model's
// blockwise path (`repro.models.attention._blockwise_attn`). Unlike the
// Pallas body, P is not rounded to v's type before the second product,
// and the ragged edge (k >= sk) is masked by index, not by padding, so
// non-causal calls with a ragged sk see no padded key. A query row that
// sees no key at all (only possible when s > sk) gives 0, as the blockwise
// path does, where the oracle averages v.
//
// What bounds it here: at the serving path's shape (b, h, s, d) =
// (1, 16, 2048, 128) bf16 causal, the function needs 4 b h d s(s+1)/2 =
// 17.2 GFLOP; over the 989 TFLOP/s of bf16 tensor cores that is 0.017 ms,
// while q, k, v and out are 33.6 MB (0.010 ms at 3.35 TB/s): it is bound
// by operations. This kernel runs the same work on the f32 CUDA cores
// (67 TFLOP/s, 0.26 ms at best), and shared-memory reads cap it at about
// half of that; moving the two products onto the tensor cores (mma.sync,
// then wgmma with TMA) is the later work that closes the gap.
//
// Design: one 256-thread block per (64-query tile, b*h), heaviest causal
// tiles first. The query tile is staged once in shared memory (transposed,
// f32); a loop over 64-key tiles -- the Pallas grid's sequential `ki`
// axis -- stages K (transposed) and V (row-major) in shared memory and
// skips tiles that the causal or window mask removes whole. Thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j (i, j < 4) of the
// 64 x 64 logit tile; a row's max and sum are reduced across the 16
// threads of a half-warp by shuffles, so every thread keeps the running
// max and denominator of its own four rows in registers, and rescales its
// own (4, D/16) slice of the f32 output accumulator. P goes through shared
// memory (in the K tile's place) to the P.V product. The head dimension
// is padded to the next of 32, 64, 128, 256 with zeros (which add
// nothing); at d = 128 a block takes 97 KB of dynamic shared memory, so two
// fit an SM, and at d = 256 194 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

// `rows` rows of `x` starting at `row0` (row stride d) into shared memory as
// f32, zero past `n_rows` and past d. Transposed: dst[c * (R + 1) + r];
// else dst[r * D + c].
template <typename T, int D, int R, bool TRANSPOSE>
__device__ __forceinline__ void stage(const T* __restrict__ x, int row0,
                                      int n_rows, int d, float* dst) {
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    const float val =
        (row < n_rows && c < d) ? to_f32(x[(size_t)row * d + c]) : 0.f;
    if (TRANSPOSE)
      dst[c * (R + 1) + r] = val;
    else
      dst[r * D + c] = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s,
                       int sk, int d, float scale, int causal, int window) {
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
  const T* qb = q + bh * (size_t)s * d;
  const T* kb = k + bh * (size_t)sk * d;
  const T* vb = v + bh * (size_t)sk * d;

  // key tiles that hold a visible key for some row of [q0, q0 + BQ)
  int k_end = sk;
  if (causal) k_end = min(k_end, q0 + BQ);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int kt_begin = k_begin / BK;
  const int kt_end = (k_end + BK - 1) / BK;

  stage<T, D, BQ, true>(qb, q0, s, d, qt);

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
    stage<T, D, BK, true>(kb, k0, sk, d, kt);
    stage<T, D, BK, false>(vb, k0, sk, d, vs);
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

  T* ob = out + bh * (size_t)s * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= s) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(ob + (size_t)qi * d + c, acc[i][j] * inv);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int bh,
             int s, int sk, int d, float scale, int causal, int window,
             cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  // set on every launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((s + BQ - 1) / BQ, bh);
  flash_attention_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, sk, d, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int s, int sk, int d, float scale, int causal, int window,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_d<T, 32>(q, k, v, out, bh, s, sk, d, scale, causal, window,
                           st);
  if (d <= 64)
    return launch_d<T, 64>(q, k, v, out, bh, s, sk, d, scale, causal, window,
                           st);
  if (d <= 128)
    return launch_d<T, 128>(q, k, v, out, bh, s, sk, d, scale, causal,
                            window, st);
  if (d <= 256)
    return launch_d<T, 256>(q, k, v, out, bh, s, sk, d, scale, causal,
                            window, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
  return launch<float>(q, k, v, out, bh, s, sk, d, scale, causal, window,
                       stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int bh, int s,
                                    int sk, int d, float scale, int causal,
                                    int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, bh, s, sk, d, scale, causal,
                               window, stream);
}
