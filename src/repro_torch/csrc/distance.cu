// Squared L2 distances for the STI-KNN streaming step, for sm_90a.
//
// Replaces the Pallas TPU kernel `distance_pallas` (src/repro/kernels/
// distance.py, body `_kernel`): out[i, j] = max(|a_i|^2 - 2 a_i.b_j +
// |b_j|^2, 0) for a = x_test (t, d) and b = x_train (n, d), with f32
// accumulation and f32 or bf16 inputs.
//
// What bounds it: at the main path's shape (t = 256, n = 65536, d = 768)
// the cross term is 2 t n d = 2.6e10 operations, 0.052 ms at the tensor
// cores' TF32 rate (495 TFLOP/s), and the bytes (x_train and x_test read
// once, the (t, n) output written once) are 0.27 GB: 0.080 ms, so the
// function is bound by bytes. The f32 path runs the cross term as three
// TF32 products (3xTF32, `distance_tile.cuh`), which keeps f32 accuracy
// (~2^-22 of |a||b| per product) and, unlike one TF32 pass, gives
// integer-valued features their exact products, so their distances and
// ranks match the plain version bit for bit; that triples the tensor work,
// whose 7.7e10 operations set this design's own floor at 0.156 ms. The
// norm pre-pass reads both inputs again (0.14 ms of bytes in all). bf16
// inputs take one bf16 pass (0.026 ms of tensor work), so they are bound
// by their 0.17 GB of bytes (0.050 ms).
//
// Design: a pre-pass writes the row squared norms of both operands (one
// warp per row, `row_sq_norm`: the bits of the megakernel's phase 0). The
// main kernel is persistent, one CTA per SM walking tiles of 128 train
// points by 256 test points (all of a 256-point batch, so every x_train
// tile is read once), with the JAX kernel's norm epilogue fused into the
// store:
//   - three warpgroups: a producer, which gives its registers to the two
//     consumers (`setmaxnreg`), and two consumers of 64 train rows each;
//   - the producer's first thread keeps up to STAGES k-steps (32 f32 or 64
//     bf16 columns: one 128-byte swizzle row) of TMA loads in flight in a
//     ring of shared-memory stages, both operand tiles K-major as they lie
//     in memory, TMA's zero fill covering ragged t, n and d; its other
//     three warps split each f32 test tile in place into hi and lo
//     (`split_in_place`) as it lands and signal it ready;
//   - each consumer runs the k-step function that the megakernel's
//     distance phase runs (`kstep_tf32`: A fragments split in registers,
//     twelve `m64n256k8` TF32 products in four commit groups; `kstep_bf16`:
//     four `m64n256k16`), hands the stage back as soon as its products
//     retire, and the shared epilogue masks and stores its 64 x 256 tile.
// TMA needs 16-byte row strides: the wrapper pads d with zero columns to
// a multiple of 4 (f32) or 8 (bf16) and hands over 16-byte aligned rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "distance_tile.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;
using dist_tile::A_BYTES;
using dist_tile::A_OFF;
using dist_tile::B_BYTES;
using dist_tile::B_OFF;
using dist_tile::BM;
using dist_tile::BN;
using dist_tile::L_OFF;
using dist_tile::ROW;
using dist_tile::WG;
using dist_tile::WM;

constexpr int CONSUMERS = 2;                    // warpgroups of 64 rows
constexpr int THREADS = (CONSUMERS + 1) * WG;   // + a producer warpgroup
constexpr int CONSUMER_WARPS = CONSUMERS * WG / 32;
// the producer warpgroup's warps after its first, which split f32 tiles
constexpr int SPLIT_WARPS = WG / 32 - 1;
constexpr int SPLITTERS = SPLIT_WARPS * 32;
// registers a thread after `setmaxnreg`: the producer warpgroup gives up
// what the consumers take (launch: 168 each, 65536 over 384 threads)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(BM == CONSUMERS * WM, "one consumer per 64 train rows");

// The shared-memory ring of one input type: STAGES k-steps, each the
// train tile, the test tile and (f32) the test tile's lo, then the
// full / ready / empty barriers of every stage.
template <typename T>
struct Ring {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int STAGES = F32 ? 2 : 4;
  static constexpr int STAGE = F32 ? dist_tile::STAGE_BYTES
                                   : A_BYTES + B_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE;
  // +1024 to align the base
  static constexpr size_t BYTES = BAR_OFF + 8 * 3 * STAGES + 1024;
};

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
__global__ void __launch_bounds__(THREADS, 1)
sq_dist_kernel(const __grid_constant__ CUtensorMap tm_test,
               const __grid_constant__ CUtensorMap tm_train,
               const float* __restrict__ nt, const float* __restrict__ nn,
               float* __restrict__ out, int t, int n, int d) {
  using R = Ring<T>;
  constexpr int STAGES = R::STAGES;
  constexpr int KC = dist_tile::kstep_cols<T>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + R::BAR_OFF;
  auto stage = [&](int st) { return base + st * R::STAGE; };
  auto full = [&](int st) { return bars + 8 * st; };
  auto ready = [&](int st) { return bars + 8 * (STAGES + st); };
  auto empty = [&](int st) { return bars + 8 * (2 * STAGES + st); };

  const int tiles_c = (n + BM - 1) / BM;
  const int tiles = tiles_c * ((t + BN - 1) / BN);
  const int steps = (d + KC - 1) / KC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(ready(st), SPLIT_WARPS);
      mbar_init(empty(st), CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the ring runs on across the CTA's tiles
  int st = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++st == STAGES) {
      st = 0;
      phase ^= 1;
    }
  };

  if (warp >= CONSUMER_WARPS) {
    // ---- producer warpgroup: its first thread keeps up to STAGES k-steps
    // of loads in flight; for f32 its other three warps split each test
    // tile into hi and lo as it lands
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pwarp = warp - CONSUMER_WARPS;
    if (pwarp == 0) {
      if (lane != 0) return;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int train0 = tile % tiles_c * BM, test0 = tile / tiles_c * BN;
        for (int s = 0; s < steps; ++s, advance()) {
          mbar_wait(empty(st), phase ^ 1);
          mbar_expect_tx(full(st), A_BYTES + B_BYTES);
          tma_load(stage(st) + A_OFF, &tm_train, full(st), s * KC, train0);
          tma_load(stage(st) + B_OFF, &tm_test, full(st), s * KC, test0);
        }
      }
    } else if constexpr (R::F32) {
      const int stid = threadIdx.x - (CONSUMER_WARPS + 1) * 32;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int s = 0; s < steps; ++s, advance()) {
          mbar_wait(full(st), phase);
          dist_tile::split_in_place(stage(st) + B_OFF, stage(st) + L_OFF,
                                    stid, SPLITTERS);
          // the generic-proxy writes above are read by wgmma (async proxy)
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(ready(st));
        }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns train rows [train0 + 64 wg, + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4;
  float acc[128];
  dist_tile::TF32Frags f;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int train0 = tile % tiles_c * BM, test0 = tile / tiles_c * BN;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int s = 0; s < steps; ++s, advance()) {
      const uint32_t a = stage(st) + A_OFF + wg * WM * ROW;
      if constexpr (R::F32) {
        mbar_wait(ready(st), phase);
        dist_tile::kstep_tf32(acc, f, a, stage(st) + B_OFF,
                              stage(st) + L_OFF);
      } else {
        mbar_wait(full(st), phase);
        dist_tile::kstep_bf16(acc, a, stage(st) + B_OFF);
      }
      // the stage goes back to the producer as soon as its products retire
      wgmma_wait<0>();
      if constexpr (R::F32)
        dist_tile::retire(acc, f);
      else
        fence_acc<128>(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }
    const int row = dist_tile::acc_row(train0 + wg * WM);
    const float nr[2] = {row < n ? nn[row] : 0.f,
                         row + 8 < n ? nn[row + 8] : 0.f};
    dist_tile::epilogue(acc, nt, nr, t, n, test0, train0 + wg * WM,
                        [out, n](int r, int c, float v) {
                          out[(size_t)r * n + c] = v;
                        });
  }
}

// a 2-D map over x (rows, cols) of boxes one k-step (128 bytes) wide and
// `box_rows` rows high, 128-byte swizzle, zero fill out of bounds
template <typename T>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* x, int rows,
            int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)dist_tile::kstep_cols<T>(),
                             (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, 2, const_cast<void*>(x), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* xt, const void* xn, float* nt, float* nn, float* out,
           int t, int n, int d, void* stream) {
  // TMA: 16-byte row strides and 16-byte aligned rows
  if (d <= 0 || (d * sizeof(T)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xt) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xn) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  CUtensorMap tm_test, tm_train;
  if (!encode<T>(fn, &tm_test, xt, t, d, BN) ||
      !encode<T>(fn, &tm_train, xn, n, d, BM))
    return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(xt);
  const T* b = static_cast<const T*>(xn);
  const int warps_per_block = 8;
  sq_norms_kernel<T><<<(t + warps_per_block - 1) / warps_per_block,
                       32 * warps_per_block, 0, s>>>(a, t, d, nt);
  sq_norms_kernel<T><<<(n + warps_per_block - 1) / warps_per_block,
                       32 * warps_per_block, 0, s>>>(b, n, d, nn);
  constexpr size_t bytes = Ring<T>::BYTES;
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      sq_dist_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one CTA per SM (the ring takes most of its shared memory)
  // walks the tiles, so each tile's loads overlap the last one's epilogue
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (n + BM - 1) / BM * ((t + BN - 1) / BN);
  sq_dist_kernel<T><<<tiles < sms ? tiles : sms, THREADS, bytes, s>>>(
      tm_test, tm_train, nt, nn, out, t, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. `nt` (t,) and `nn` (n,) are f32 scratch
// for the norms; all pointers are device pointers; `stream` is a
// cudaStream_t. d * sizeof(element) must be a multiple of 16 and both
// inputs 16-byte aligned (the wrapper pads d with zero columns and copies a
// misaligned view). Returns cudaGetLastError() after the launches (or the
// error of setting the shared-memory attribute), -1 when the driver's
// cuTensorMapEncodeTiled cannot be reached, -2 when a tensor map is
// refused.
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
