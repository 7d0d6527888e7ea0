// K3: causal / non-causal GQA flash-attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash/kernel.py::flash_attention_pallas
// (body _flash_fwd_kernel): the same function.  q (B,S,H,D), k/v (B,T,K,D);
// q head h reads kv head h / (H/K) by index (no repeat); online softmax with
// running max m, normaliser l and accumulator acc in fp32; sm_scale = 1/sqrt(D)
// applied to q in fp32; masked scores are -1e30; the output acc / max(l, 1e-30)
// is cast to the input dtype.  KV tiles above the causal diagonal are skipped.
//
// What bounds it on the card: at Zamba2 prefill (4, 4096, 32, 80) causal it
// does 2*B*H*S^2*D ~ 3.4e11 operations on ~0.34 GB of q, k, v and o: ~1000
// operations per byte, far above the H100's ~295 for bf16, so it is bound by
// arithmetic.  This first version runs that arithmetic on the CUDA cores
// (fp32 FMA, 67 TFLOP/s peak), not on the tensor cores (wgmma and TMA come in
// a later change), so it is far from the bf16 bound by design.
//
// What the design does about it: one block of 256 threads per (b*H + h,
// 64-row q tile), looping over 64-row KV tiles staged in shared memory as
// fp32.  The block's 64x64 score tile is split 4x4 per thread (rows ty+16i,
// columns tx+16j), so each value read from shared memory feeds 4 FMAs; the
// row max and sum are reduced across the 16 lanes of a row with shuffles.
// The P tile goes through shared memory into the 64 x D accumulator, which
// each thread holds as 4 rows x ceil(D/16) columns in registers.  Rows of
// K are padded to D+1 floats so the column reads of Q K^T hit distinct banks.
// Heavy q tiles (late rows of a causal problem) are launched first.
//
// No shape is padded: D need not be a power of two (Zamba2 has D = 80; the
// thread's columns tx+16j are guarded by j < D), and the ragged edges of S
// and T are masked in the kernel (zero-filled loads, -1e30 scores, guarded
// stores), where the TPU kernel asserted S % block == 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 16 x 16
constexpr int PP = BK + 1;    // padded row of the P tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, 16));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off, 16);
  return v;
}

// DJ = ceil(D / 16) columns of the accumulator per thread (D <= 16 * DJ).
template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int T_, int H, int K, int D, int causal,
                 float sm_scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Qs = smem;              // BQ x DP, pre-scaled by sm_scale
  float* Ks = Qs + BQ * DP;      // BK x DP
  float* Vs = Ks + BK * DP;      // BK x D
  float* Ps = Vs + BK * D;       // BQ x PP

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;               // b * H + h
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);              // GQA: kv head of q head h
  const int nq = gridDim.y;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;  // heavy (late) tiles first

  const int64_t q_row = (int64_t)H * D;    // stride of s in q / o
  const int64_t kv_row = (int64_t)K * D;   // stride of t in k / v
  const T* qb = q + ((int64_t)b * S * H + h) * D;
  const T* kb = k + ((int64_t)b * T_ * K + kh) * D;
  const T* vb = v + ((int64_t)b * T_ * K + kh) * D;
  T* ob = o + ((int64_t)b * S * H + h) * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int s = q0 + r;
    Qs[r * DP + d] = s < S ? to_f32(qb[s * q_row + d]) * sm_scale : 0.0f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  int n_kv = (T_ + BK - 1) / BK;
  if (causal) {
    const int q_last = min(q0 + BQ, S) - 1;  // causal => S == T
    n_kv = min(n_kv, q_last / BK + 1);
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks / Vs / Ps are no longer read
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const int t = k0 + r;
      const bool ok = t < T_;
      Ks[r * DP + d] = ok ? to_f32(kb[t * kv_row + d]) : 0.0f;
      Vs[r * D + d] = ok ? to_f32(vb[t * kv_row + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= T_ || (causal && kpos > qpos)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int n_t = min(BK, T_ - k0);
    for (int t = 0; t < n_t; ++t) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PP + t];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < D ? Vs[t * D + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) ob[s * q_row + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
                          (size_t)BQ * PP);
}

template <typename T, int DJ>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_, int H,
           int K, int D, int causal, float sm_scale, void* stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_kernel<T, DJ><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, T_, H, K, D, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_, int H,
             int K, int D, int causal, float sm_scale, void* stream) {
  if (D <= 16) return launch<T, 1>(q, k, v, o, B, S, T_, H, K, D, causal, sm_scale, stream);
  if (D <= 32) return launch<T, 2>(q, k, v, o, B, S, T_, H, K, D, causal, sm_scale, stream);
  if (D <= 64) return launch<T, 4>(q, k, v, o, B, S, T_, H, K, D, causal, sm_scale, stream);
  if (D <= 80) return launch<T, 5>(q, k, v, o, B, S, T_, H, K, D, causal, sm_scale, stream);
  if (D <= 128) return launch<T, 8>(q, k, v, o, B, S, T_, H, K, D, causal, sm_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16.  Tensors
// are contiguous: q and o (B,S,H,D), k and v (B,T,K,D), H % K == 0, D <= 128,
// causal => S == T.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int pccl_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                              int B, int S, int T, int H, int K, int D, int causal,
                              float sm_scale, void* stream) {
  if (dtype == 0) return dispatch<float>(q, k, v, o, B, S, T, H, K, D, causal, sm_scale, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, T, H, K, D, causal, sm_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
