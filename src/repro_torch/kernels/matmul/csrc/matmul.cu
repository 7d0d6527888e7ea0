// K1: blocked matmul x @ w with an fp32 accumulator on the CUDA cores, for
// Hopper (sm_90a).  The route of fp32, and of bf16 shapes TMA cannot address.
//
// Replaces the TPU kernel src/repro/kernels/matmul/kernel.py::matmul_pallas
// (body _matmul_kernel): the same function, (M,K) @ (K,N) -> (M,N) in
// x's dtype, fp32 accumulation, cast once on store.
//
// What bounds it on the card: at the main path's fp32 shape
// (32768x3584)@(3584x12288) the product does 2*M*N*K = 2.9e15 operations
// on 0.83 GB, ~3500 operations per byte, so it is bound by arithmetic: the
// CUDA cores' fp32 FMA, 67 TFLOP/s, 43.1 ms.  It stays off the tensor cores
// on purpose: TF32 keeps 10 mantissa bits and misses the fp32 tolerance.
// What keeps an FMA kernel from that rate is feeding it.  An SM's shared
// memory delivers 128 bytes a clock, one 4-byte word for each of 32 lanes,
// broadcast or not, while its 4 schedulers issue 128 FMAs: a lane has to do
// 4 FMAs for every word it reads from shared memory.  Then come copies that
// wait on device memory, and barriers.
//
// What the design does about it:
// - A 128x256 output tile per block of 256 threads; each thread owns an
//   8x16 register tile, as 2x4 sub-tiles of 4x4 (rows ty*4 and 16 + ty*4
//   of its warp's 32, columns tx*4 + 32h of its 128), so one k-step reads
//   2 + 4 float4 from shared memory for 128 FMAs: 21.3 FMAs a 16-byte load,
//   5.3 a word (8x8 gives 4.0, the bare minimum).  Each x load of a warp
//   covers 64 contiguous bytes and each w load 128: no bank conflict.  The
//   accumulator takes 128 of the thread's 255 registers: one block an SM.
// - x and w reach shared memory through a 4-stage cp.async ring of 16-deep
//   k-slices (25,088 bytes a stage, 100,352 a block, one barrier a slice).
//   While slice k is multiplied, slices k+1..k+3 are in flight.  x is
//   stored k-major (transposed) by 4-byte copies whose lanes take 8 rows x
//   4 k: rows padded to BM + 8 floats put those 32 stores in 32 banks.  w
//   goes as 16-byte copies when its rows allow (fp32, N % 4 == 0, a 16-byte
//   base), else as 4-byte copies.
// - Edges stay in this kernel: masked copies zero-fill ragged M, N and K
//   (any K, K % 4 != 0 included); bf16 goes through registers (loaded,
//   widened to fp32, stored to the same slots); stores are 16 bytes where
//   the output allows and guarded scalars elsewhere.
//
// The contract fusion rests on: every output element is one fp32 fmaf
// chain from 0 over k = 0..K-1 in increasing order (no split-K, no
// atomics), whatever M, the tile a row lands in, or how many rows a call
// has; zero-filled slots past K add fmaf(0, 0, acc) = acc.  So per-chunk
// calls are bit-identical to one whole-M call.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/cp_async.cuh"
#include "../../csrc/geometry.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 16;
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int XPAD = 8;  // floats after each k-row of the x slice
constexpr int WARPS_N = BN / 128;  // a warp takes 32 rows x 128 columns
constexpr int XROW = BM + XPAD;
constexpr int STAGE_FLOATS = BK * XROW + BK * BN;  // x slice (k-major), then w slice
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
static_assert(THREADS == (BM / 8) * (BN / 16), "one thread per 8x16 register tile");
static_assert((BM / 8) * (BK / 4) == BM * BK / 32, "x copies: 8 rows x 4 k a warp instruction");
static_assert((XROW * 4) % 16 == 0 && (STAGE_FLOATS * 4) % 16 == 0, "16-byte aligned rows");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// The x slice rows row0.., k k0.. into xs[k][r] (k-major).  Warp instruction
// i of warp w copies rows (idx % 16) * 8 + lane / 4 at k (idx / 16) * 4 +
// lane % 4, idx = i * 8 + w: 8 rows x 16 bytes of device memory, 32
// distinct banks of shared memory.
template <typename T>
__device__ __forceinline__ void load_x(float* xs, const T* __restrict__ x, int M, int K,
                                       int64_t row0, int k0, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < BM * BK / THREADS; ++i) {
    const int idx = i * (THREADS / 32) + warp;
    const int r = (idx % (BM / 8)) * 8 + (lane >> 2);
    const int c = (idx / (BM / 8)) * 4 + (lane & 3);
    const int64_t gr = row0 + r;
    const int gc = k0 + c;
    const bool ok = gr < M && gc < K;
    float* dst = xs + c * XROW + r;
    if constexpr (std::is_same<T, float>::value) {
      cp_async::copy4(dst, ok ? x + gr * K + gc : x, ok);
    } else {
      *dst = ok ? to_f32(x[gr * K + gc]) : 0.0f;
    }
  }
}

// The w slice k k0.., columns col0.. into ws[k][n]: 16-byte copies when
// w16, else one element a thread (a warp on 32 contiguous columns).
template <typename T>
__device__ __forceinline__ void load_w(float* ws, const T* __restrict__ w, int N, int K,
                                       int64_t col0, int k0, int tid, bool w16) {
  if constexpr (std::is_same<T, float>::value) {
    if (w16) {
#pragma unroll
      for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const int gr = k0 + r;
        const int64_t gc = col0 + c;
        const bool ok = gr < K && gc < N;  // N % 4 == 0: a piece is all in or all out
        cp_async::copy16(ws + r * BN + c, ok ? w + (int64_t)gr * N + gc : w, ok);
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < BK * BN / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / BN, c = e % BN;
    const int gr = k0 + r;
    const int64_t gc = col0 + c;
    const bool ok = gr < K && gc < N;
    if constexpr (std::is_same<T, float>::value) {
      cp_async::copy4(ws + r * BN + c, ok ? w + (int64_t)gr * N + gc : w, ok);
    } else {
      ws[r * BN + c] = ok ? to_f32(w[(int64_t)gr * N + gc]) : 0.0f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
              int M, int N, int K) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int64_t col0 = (int64_t)blockIdx.y * BN;
  const int wm = (warp / WARPS_N) * 32;  // the warp's 32 rows and 128 columns of the tile
  const int wn = (warp % WARPS_N) * 128;
  const int ty = lane >> 3, tx = lane & 7;
  const bool is_f32 = std::is_same<T, float>::value;
  const bool w16 = is_f32 && N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int n_k = (K + BK - 1) / BK;

  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;

  // the ring: slice s in slot s % STAGES, one commit group a slice
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) {
      float* xs = smem + s * STAGE_FLOATS;
      load_x(xs, x, M, K, row0, s * BK, tid);
      load_w(xs + BK * XROW, w, N, K, col0, s * BK, tid, w16);
    }
    cp_async::commit();
  }

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async::wait<STAGES - 2>();  // this thread's copies of slice kt have landed
    __syncthreads();               // everyone's have; slot (kt - 1) % STAGES is free
    const int next = kt + STAGES - 1;
    if (next < n_k) {
      float* xs = smem + (next % STAGES) * STAGE_FLOATS;
      load_x(xs, x, M, K, row0, next * BK, tid);
      load_w(xs + BK * XROW, w, N, K, col0, next * BK, tid, w16);
    }
    cp_async::commit();

    const float* xs = smem + (kt % STAGES) * STAGE_FLOATS + wm + ty * 4;
    const float* ws = smem + (kt % STAGES) * STAGE_FLOATS + BK * XROW + wn + tx * 4;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + kk * XROW);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + kk * XROW + 16);
      float4 b4[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) b4[h] = *reinterpret_cast<const float4*>(ws + kk * BN + 32 * h);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          acc[i][4 * h] = fmaf(a[i], b4[h].x, acc[i][4 * h]);
          acc[i][4 * h + 1] = fmaf(a[i], b4[h].y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(a[i], b4[h].z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(a[i], b4[h].w, acc[i][4 * h + 3]);
        }
    }
  }

  // row i of the thread: wm + (i / 4) * 16 + ty * 4 + i % 4; columns
  // wn + h * 32 + tx * 4 + 0..3 for h = 0..3
  const bool o16 = is_f32 && N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gr = row0 + wm + (i >> 2) * 16 + ty * 4 + (i & 3);
    if (gr >= M) continue;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int64_t gc = col0 + wn + h * 32 + tx * 4;
      if (gc >= N) continue;
      T* dst = out + gr * N + gc;
      if constexpr (std::is_same<T, float>::value) {
        if (o16) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(from_f32<float>(acc[i][4 * h]), from_f32<float>(acc[i][4 * h + 1]),
                          from_f32<float>(acc[i][4 * h + 2]), from_f32<float>(acc[i][4 * h + 3]));
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gc + j < N) dst[j] = from_f32<T>(acc[i][4 * h + j]);
    }
  }
}

// The launch: one block per BM x BN (128x256) output tile, (row tile, column tile),
// with the ring in dynamic shared memory.
geometry::Launch launch_geometry(int M, int N) {
  return {dim3((M + BM - 1) / BM, (N + BN - 1) / BN), THREADS, SMEM_BYTES};
}

template <typename T>
int launch(const void* x, const void* w, void* out, int M, int N, int K, void* stream) {
  const geometry::Launch g = launch_geometry(M, N);
  cudaError_t err = cudaFuncSetAttribute(matmul_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err == cudaSuccess)  // all of L1 as shared memory: the ring of every resident block fits
    err = cudaFuncSetAttribute(matmul_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_kernel<T><<<g.grid, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int pccl_matmul(int dtype, const void* x, const void* w, void* out,
                           int M, int N, int K, void* stream) {
  if (dtype == 0) return launch<float>(x, w, out, M, N, K, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, M, N, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// What pccl_matmul launches for (M, N) in dtype: grid, threads, dynamic
// smem and (attrs, may be null) the kernel's static smem and thread limit.
extern "C" int pccl_matmul_geometry(int dtype, int M, int N, int* grid3, int* threads,
                                    long long* smem, long long* attrs) {
  const geometry::Launch g = launch_geometry(M, N);
  if (dtype == 0) return geometry::export_launch(g, matmul_kernel<float>, grid3, threads, smem, attrs);
  if (dtype == 1)
    return geometry::export_launch(g, matmul_kernel<__nv_bfloat16>, grid3, threads, smem, attrs);
  return static_cast<int>(cudaErrorInvalidValue);
}
