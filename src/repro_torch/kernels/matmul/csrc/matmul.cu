// K1: blocked matmul x @ w with an fp32 accumulator, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/matmul/kernel.py::matmul_pallas
// (body _matmul_kernel): the same function, (M,K) @ (K,N) -> (M,N) in
// x's dtype, fp32 accumulation, cast once on store.
//
// What bounds it on the card: at the main path's shapes the product does
// about 2*M*N*K / ((M*K + K*N + M*N) * bytes) ~ 1000+ operations per byte,
// far above the H100's ~295 for bf16, so it is bound by arithmetic.  This
// first version runs that arithmetic on the CUDA cores (fp32 FMA, 67
// TFLOP/s peak), not on the tensor cores (wgmma/TMA come in a later
// change), so it is far from the bf16 bound by design.
//
// What the design does about it: a 128x128 output tile per block of 256
// threads, each thread owning an 8x8 register tile, with 8-deep slices of
// x and w staged in shared memory (converted to fp32 on load), so each
// value loaded from device memory feeds 128 FMAs.
//
// The contract fusion rests on: every output element is one fp32 sum over
// k = 0..K-1 in increasing order (one FMA per k, no split-K, no atomics),
// whatever M, the tile a row lands in, or how many rows a call has.  So
// per-chunk calls are bit-identical to one whole-M call.  Ragged edges are
// masked in the kernel (zero-filled loads, guarded stores): any shape runs
// and nothing is padded.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "../../csrc/geometry.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = 256;
static_assert(THREADS == (BM / TM) * (BN / TN), "one thread per 8x8 register tile");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
              int M, int N, int K) {
  __shared__ float xs[BK][BM];  // x slice, k-major so a thread reads a row run
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int64_t col0 = (int64_t)blockIdx.y * BN;
  const int tr = tid / (BN / TN);  // this thread's 8 rows: tr*8 ..
  const int tc = tid % (BN / TN);  // this thread's 8 cols: tc*8 ..

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x slice (BM x BK): neighbouring threads read neighbouring k of a row
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int64_t gr = row0 + r;
      const int gc = k0 + c;
      xs[c][r] = (gr < M && gc < K) ? to_f32(x[gr * K + gc]) : 0.0f;
    }
    // w slice (BK x BN): neighbouring threads read neighbouring columns
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r;
      const int64_t gc = col0 + c;
      ws[r][c] = (gr < K && gc < N) ? to_f32(w[(int64_t)gr * N + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][tr * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tc * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + tr * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = col0 + tc * TN + j;
      if (gc < N) out[gr * N + gc] = from_f32<T>(acc[i][j]);
    }
  }
}

// The launch: one block per 128x128 output tile, (row tile, column tile).
geometry::Launch launch_geometry(int M, int N) {
  return {dim3((M + BM - 1) / BM, (N + BN - 1) / BN), THREADS, 0};
}

template <typename T>
int launch(const void* x, const void* w, void* out, int M, int N, int K, void* stream) {
  const geometry::Launch g = launch_geometry(M, N);
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
