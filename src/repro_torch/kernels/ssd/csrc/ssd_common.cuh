// What K4's two routes share (ssd.cu, fp32 FMA; ssd_sm90.cu, bf16 wgmma):
// the block-to-chunk map of passes 1 and 3, the chunk's cumsum of the log
// decay, and pass 2, the recurrence across chunks.
//
// The scan runs as three passes over (b, h, chunk c), with cum the inclusive
// cumsum of la over the chunk and total_c = cum[L-1]:
//   1. chunk states   S_c = (X * exp(total_c - cum))^T B    one block per chunk
//   2. recurrence     R_before_c = R;  R = exp(total_c) R + S_c   elementwise
//   3. outputs        Y = exp(cum_t) (C R_before^T) + (tril(exp(cum_t - cum_s)) * (C B^T)) X
// Passes 1 and 3 compute cum with the same function, so they agree bit for
// bit on total_c and the decays.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Blocks of passes 1 and 3 walk (b, c, h) with h fastest, so the blocks
// that run at once share a chunk of shared B and C in L2.  chunk_of maps a
// block index x (blockIdx.x, or what is left of it once a pass has taken
// its tile index off) to its (b, h, c).
struct Chunk {
  int b, h, c;
};

__device__ __forceinline__ Chunk chunk_of(int x, int H, int nc) {
  Chunk k;
  k.h = x % H;
  x /= H;
  k.c = x % nc;
  k.b = x / nc;
  return k;
}

__device__ __forceinline__ Chunk chunk_of_block(int H, int nc) {
  return chunk_of(blockIdx.x, H, nc);
}

// cum[r] = la[0] + ... + la[r] for r < L, with steps at or past n_valid read
// as 0 (the reference's zero padding).  la[r] is at la[r * stride].  Run by
// one whole warp: lane l sums its own run of ceil(L/32) steps, a shuffle
// scan adds the runs before it.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ la, int64_t stride,
                                             int n_valid, int L, float* cum) {
  const int lane = threadIdx.x & 31;
  const int per = (L + 31) / 32;
  const int r0 = lane * per;
  float run = 0.0f;
  for (int i = 0; i < per; ++i) {
    const int r = r0 + i;
    if (r < L) {
      run += r < n_valid ? la[r * stride] : 0.0f;
      cum[r] = run;
    }
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.0f;
  for (int i = 0; i < per; ++i) {
    const int r = r0 + i;
    if (r < L) cum[r] += before;
  }
}

// Pass 2: one thread per element e of a (b, h)'s P x N state.  The state
// before each chunk goes to R_before in RT (what pass 3 reads: bf16 on the
// tensor-core route, fp32 on the FMA route); the state after the last chunk
// to fin in FT (X's dtype, as ssd_reference returns it).  The loads of S_c
// and total_c do not depend on R, so UNROLL chunks of them are issued before
// the chain of updates that uses them.
constexpr int RECURRENCE_THREADS = 256;
constexpr int UNROLL = 8;

template <typename RT, typename FT>
__global__ void __launch_bounds__(RECURRENCE_THREADS)
ssd_recurrence_kernel(const float* __restrict__ states, const float* __restrict__ totals,
                      const float* __restrict__ init, RT* __restrict__ before,
                      FT* __restrict__ fin, int BH, int nc, int PN) {
  const int64_t i = (int64_t)blockIdx.x * RECURRENCE_THREADS + threadIdx.x;
  if (i >= (int64_t)BH * PN) return;
  const int64_t bh = i / PN, e = i % PN;
  const float* s = states + bh * nc * PN + e;
  const float* tot = totals + bh * nc;
  RT* r = before + bh * nc * PN + e;
  float R = init ? init[i] : 0.0f;
  for (int c0 = 0; c0 < nc; c0 += UNROLL) {
    float sv[UNROLL], dv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool ok = c0 + u < nc;
      sv[u] = ok ? s[(int64_t)(c0 + u) * PN] : 0.0f;
      dv[u] = ok ? tot[c0 + u] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c0 + u < nc) {
        r[(int64_t)(c0 + u) * PN] = from_f32<RT>(R);
        R = R * expf(dv[u]) + sv[u];
      }
    }
  }
  fin[i] = from_f32<FT>(R);
}

template <typename RT, typename FT>
int launch_recurrence(const float* states, const float* totals, const float* init, void* before,
                      void* fin, int BH, int nc, int PN, cudaStream_t stream) {
  const int64_t n = (int64_t)BH * PN;
  const int blocks = (int)((n + RECURRENCE_THREADS - 1) / RECURRENCE_THREADS);
  ssd_recurrence_kernel<RT, FT><<<blocks, RECURRENCE_THREADS, 0, stream>>>(
      states, totals, init, static_cast<RT*>(before), static_cast<FT*>(fin), BH, nc, PN);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd
