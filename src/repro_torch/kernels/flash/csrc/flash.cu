// K3: causal / non-causal GQA flash-attention forward on the CUDA cores, for
// Hopper (sm_90a).  The route of fp32, and of bf16 head widths that are not
// multiples of 16.
//
// Replaces the TPU kernel src/repro/kernels/flash/kernel.py::flash_attention_pallas
// (body _flash_fwd_kernel): the same function.  q (B,S,H,D), k/v (B,T,K,D);
// q head h reads kv head h / (H/K) by index (no repeat); online softmax with
// running max m, normaliser l and accumulator acc in fp32; sm_scale = 1/sqrt(D);
// masked scores are -1e30; the output acc / max(l, 1e-30) is cast to the
// input dtype.  KV tiles above the causal diagonal are skipped, and heavy q
// tiles (late rows of a causal problem) are launched first.
//
// What bounds it on the card: at OLMoE's prefill (4, 4096, 16, 128) causal it
// does 2*B*H*S^2*D = 2.7e11 operations on 0.13 GB of fp32 q, k, v and o,
// ~2000 operations per byte, so it is bound by arithmetic: in fp32 on the
// CUDA cores' FMA, 67 TFLOP/s, 4.1 ms (Zamba2's (4, 4096, 32, 80): 5.1 ms).
// It stays off the tensor cores on purpose: TF32 misses the fp32 tolerance.
// What keeps an FMA kernel from that rate is feeding it.  An SM's shared
// memory delivers one 4-byte word a clock to each of 32 lanes, broadcast or
// not, while it issues 128 FMAs: a lane has to do 4 FMAs for every word it
// reads (or shuffles) to run at the FMA rate.  Then come copies that wait
// on device memory, barriers, and the registers and shared memory that
// bound the blocks an SM holds.
//
// What the design does about it:
// - A block of 4 warps takes 64 q rows, 16 a warp, and walks the kv rows in
//   tiles of 32.  Lane (ty, tx) = (lane / 8, lane % 8) owns the 4x4 scores
//   of rows ty + 4r and kv columns tx + 8c, read as float4 along d: per 4 d,
//   4 q and 4 k loads feed 64 FMAs (8 a 16-byte load, 2 a word).  Q and K
//   rows are padded to an odd number of 16-byte pieces, so the 4 q rows and
//   8 k rows a warp load reads sit in distinct banks.  A larger tile needs more than the 255 registers a
//   thread has at D = 128 (the accumulator and the scores hold 80).
// - P stays in registers.  For P V the lane owns rows ty + 4r and the
//   16-byte d-pieces tx + 8m; each kv column's P comes from its owner lane by
//   4 shuffles, each V piece by one float4 load: at D = 128, 4 shuffles and
//   4 loads feed 64 FMAs a column (8 a load or shuffle, 3.2 a word; D = 80:
//   3 loads, 48 FMAs, 3.0 a word; D = 64: 2.7).
// - K and V reach shared memory through a 2-stage cp.async ring (the next
//   tile's copy in flight while this one is computed) with one barrier a
//   tile; Q is copied once with the first tile.  V's rows are VP = 32 * DM
//   floats, the columns past D4 zeros, so no lane's P V load needs a guard,
//   which would branch inside the unrolled loop.  Shared memory per block
//   is 4 * (64 * DP + 2 * 32 * (DP + VP)) bytes, DP the padded row: 100,352
//   B at D = 128 (two blocks an SM), 67,584 B at D = 80 (three).
// - exp2f with log2(e) folded into the scale: s2 = (q . k) * sm_scale *
//   log2(e), p = exp2(s2 - m2).  Each score carries one more fp32 rounding
//   (relative 6e-8), far inside the fp32 tolerance of 1e-4.  The row sum l
//   is kept per lane and reduced across its 8 lanes once, at the end.
// - Edges stay in this kernel: rows past S or T are zero-filled copies and
//   -1e30 scores; a warp skips a kv tile wholly above its causal diagonal;
//   bf16, D % 4 != 0 (any D <= 128: D = 8 and 72 too) or a base off 16
//   bytes go through a masked scalar path (loaded through registers,
//   widened to fp32, stored to the same slots, zeros past D); stores are
//   16 bytes where o allows and guarded scalars elsewhere.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/cp_async.cuh"
#include "../../csrc/geometry.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int STAGES = 2;
constexpr int THREADS = 128;  // 4 warps of 16 q rows
constexpr int WQ = 16;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(THREADS / 32 * WQ == BQ && BK == 4 * 8, "lane (ty, tx) owns 4 rows x 4 columns");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// D rounded up to 16-byte pieces, and the padded row of Q and K: an odd
// number of pieces, so consecutive rows start in distinct banks.
__host__ __device__ __forceinline__ int d4_of(int D) { return (D + 3) & ~3; }
__host__ __device__ __forceinline__ int dp_of(int D) { return d4_of(D) + ((d4_of(D) & 4) ? 8 : 4); }

__device__ __forceinline__ float max8(float v) {  // over the 8 lanes of a row group
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float sum8(float v) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows of src (row r at src + r * stride, r < valid) into dst (row r at
// dst + r * dst_row), D4 floats a row, zeros past D and past `valid`: a
// warp a row, lane l on its 16-byte piece l (copied when vec), or on
// elements l, l + 32, .. (through registers).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int dst_row, const T* __restrict__ src,
                                          int64_t stride, int rows, int valid, int D, bool vec,
                                          int tid) {
  const int D4 = d4_of(D), lane = tid & 31;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {  // D == D4 <= 128: one piece a lane
      const int d = 4 * lane;
      if (d < D4)
        for (int r = tid >> 5; r < rows; r += THREADS / 32) {
          const bool ok = r < valid;
          cp_async::copy16(dst + r * dst_row + d, ok ? src + r * stride + d : src, ok);
        }
      return;
    }
  }
  for (int r = tid >> 5; r < rows; r += THREADS / 32)
    for (int d = lane; d < D4; d += 32)
      dst[r * dst_row + d] = (r < valid && d < D) ? to_f32(src[r * stride + d]) : 0.0f;
}

// DM = ceil(D4 / 32): 16-byte d-pieces of the accumulator a lane holds.
template <typename T, int DM>
__global__ void __launch_bounds__(THREADS, DM <= 3 ? 3 : 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int T_, int H, int K, int D, int causal,
                 float sm_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D4 = d4_of(D), DP = dp_of(D), VP = 32 * DM;
  float* Qs = smem;                 // BQ x DP
  float* ring = Qs + BQ * DP;       // STAGES x (K: BK x DP, V: BK x VP)
  const int stage = BK * (DP + VP);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty = lane >> 3, tx = lane & 7;
  const int bh = blockIdx.x;                // b * H + h
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);               // GQA: kv head of q head h
  const int nq = gridDim.y;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;  // heavy (late) tiles first
  const int qw = q0 + warp * WQ;            // the warp's first row

  const int64_t q_row = (int64_t)H * D;    // stride of s in q / o
  const int64_t kv_row = (int64_t)K * D;   // stride of t in k / v
  const T* qb = q + ((int64_t)b * S * H + h) * D;
  const T* kb = k + ((int64_t)b * T_ * K + kh) * D;
  const T* vb = v + ((int64_t)b * T_ * K + kh) * D;
  T* ob = o + ((int64_t)b * S * H + h) * D;
  const bool is_f32 = std::is_same<T, float>::value;
  const bool vec = is_f32 && D % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const float scale_log2 = sm_scale * LOG2E;

  int n_kv = (T_ + BK - 1) / BK;
  if (causal) {
    const int q_last = min(q0 + BQ, S) - 1;  // causal => S == T
    n_kv = min(n_kv, q_last / BK + 1);
  }

  // V's columns D4..VP stay 0, so every lane's P V pieces are in range
  for (int e = tid; e < STAGES * BK * (VP - D4); e += THREADS) {
    const int r = e / (VP - D4);
    ring[(r / BK) * stage + BK * DP + (r % BK) * VP + D4 + e % (VP - D4)] = 0.0f;
  }
  // Q and the first K/V tile: one commit group
  load_rows(Qs, DP, qb + (int64_t)q0 * q_row, q_row, BQ, S - q0, D, vec, tid);
  load_rows(ring, DP, kb, kv_row, BK, T_, D, vec, tid);
  load_rows(ring + BK * DP, VP, vb, kv_row, BK, T_, D, vec, tid);
  cp_async::commit();

  float m[4], l[4], acc[4][DM][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DM; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][i][e] = 0.0f;
  }
  const float* Qw = Qs + (warp * WQ + ty) * DP;  // row r at + 4 r DP

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    cp_async::wait<0>();  // this thread's copies of tile kt have landed
    __syncthreads();      // everyone's have; the other slot is free
    if (kt + 1 < n_kv) {
      float* Kn = ring + ((kt + 1) % STAGES) * stage;
      const int64_t t1 = (int64_t)(k0 + BK) * kv_row;
      load_rows(Kn, DP, kb + t1, kv_row, BK, T_ - k0 - BK, D, vec, tid);
      load_rows(Kn + BK * DP, VP, vb + t1, kv_row, BK, T_ - k0 - BK, D, vec, tid);
    }
    cp_async::commit();
    if (causal && k0 > qw + WQ - 1) continue;  // wholly above this warp's diagonal

    const float* Ks = ring + (kt % STAGES) * stage;
    const float* Vs = Ks + BK * DP;

    // S = Q K^T: the lane's rows ty + 4r, columns tx + 8c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
    const float* Kl = Ks + tx * DP;  // column c at + 8 c DP
#pragma unroll 2
    for (int d = 0; d < D4; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = *reinterpret_cast<const float4*>(Qw + 4 * r * DP + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = *reinterpret_cast<const float4*>(Kl + 8 * c * DP + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r].x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv[r].y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv[r].z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv[r].w, kv[c].w, s[r][c]);
        }
    }

    // online softmax in the log2 domain; masks only on edge tiles
    const bool edge = k0 + BK > T_ || (causal && k0 + BK - 1 > qw);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = qw + ty + 4 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[r][c] * scale_log2;
        if (edge) {
          const int kpos = k0 + tx + 8 * c;
          if (kpos >= T_ || (causal && kpos > qpos)) x = NEG_INF;
        }
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], max8(mx));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = exp2f(s[r][c] - m_new);
        sum += s[r][c];
      }
      const float alpha = exp2f(m[r] - m_new);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DM; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][i][e] *= alpha;
    }

    // O += P V: column j's P from lane (ty, j % 8), register c = j / 8
    const float* Vl = Vs + 4 * tx;  // d-piece i at + 32 i
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = __shfl_sync(0xffffffffu, s[r][j >> 3], (lane & 24) | (j & 7));
#pragma unroll
      for (int i = 0; i < DM; ++i) {  // no guard: pieces past D4 read V's zero columns
        const float4 vv = *reinterpret_cast<const float4*>(Vl + j * VP + 32 * i);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][i][0] = fmaf(p[r], vv.x, acc[r][i][0]);
          acc[r][i][1] = fmaf(p[r], vv.y, acc[r][i][1]);
          acc[r][i][2] = fmaf(p[r], vv.z, acc[r][i][2]);
          acc[r][i][3] = fmaf(p[r], vv.w, acc[r][i][3]);
        }
      }
    }
  }

  const bool o16 = is_f32 && D % 4 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float inv = 1.0f / fmaxf(sum8(l[r]), 1e-30f);
    const int s_ = qw + ty + 4 * r;
    if (s_ >= S) continue;
#pragma unroll
    for (int i = 0; i < DM; ++i) {
      const int d = 4 * (tx + 8 * i);
      if (d >= D) continue;
      T* dst = ob + s_ * q_row + d;
      if constexpr (std::is_same<T, float>::value) {
        if (o16) {
          *reinterpret_cast<float4*>(dst) = make_float4(
              from_f32<float>(acc[r][i][0] * inv), from_f32<float>(acc[r][i][1] * inv),
              from_f32<float>(acc[r][i][2] * inv), from_f32<float>(acc[r][i][3] * inv));
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < D) dst[e] = from_f32<T>(acc[r][i][e] * inv);
    }
  }
}

// V's row: the DM = ceil(D4 / 32) pieces of 32 floats the lanes read
int vp_of(int D) { return 32 * ((d4_of(D) + 31) / 32); }

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)BQ * dp_of(D) + (size_t)STAGES * BK * (dp_of(D) + vp_of(D)));
}

// The launch: one block per (b * H + h, 64-row q tile).
geometry::Launch launch_geometry(int B, int S, int H, int D) {
  return {dim3(B * H, (S + BQ - 1) / BQ), THREADS, (int)smem_bytes(D)};
}

// f(std::integral_constant<int, DM>) for the accumulator's d-pieces a lane
// of head dim D <= 128 holds: ceil(D4 / 32).
template <typename F>
int with_dm(int D, F&& f) {
  if (D <= 32) return f(std::integral_constant<int, 1>());
  if (D <= 64) return f(std::integral_constant<int, 2>());
  if (D <= 96) return f(std::integral_constant<int, 3>());
  if (D <= 128) return f(std::integral_constant<int, 4>());
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int DM>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_, int H,
           int K, int D, int causal, float sm_scale, void* stream) {
  const geometry::Launch g = launch_geometry(B, S, H, D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err == cudaSuccess)  // all of L1 as shared memory: two or three blocks an SM fit
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, DM>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<T, DM><<<g.grid, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, T_, H, K, D, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_, int H,
             int K, int D, int causal, float sm_scale, void* stream) {
  return with_dm(D, [&](auto dm) {
    return launch<T, decltype(dm)::value>(q, k, v, o, B, S, T_, H, K, D, causal, sm_scale, stream);
  });
}

template <typename T>
int geometry_of(int B, int S, int H, int D, int* grid3, int* threads, long long* smem,
                long long* attrs) {
  return with_dm(D, [&](auto dm) {
    return geometry::export_launch(launch_geometry(B, S, H, D),
                                   flash_fwd_kernel<T, decltype(dm)::value>, grid3, threads, smem,
                                   attrs);
  });
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

// What pccl_flash_fwd launches for q (B,S,H,D) in dtype: grid, threads,
// dynamic smem and (attrs, may be null) the kernel's static smem and thread
// limit.
extern "C" int pccl_flash_fwd_geometry(int dtype, int B, int S, int H, int D, int* grid3,
                                       int* threads, long long* smem, long long* attrs) {
  if (dtype == 0) return geometry_of<float>(B, S, H, D, grid3, threads, smem, attrs);
  if (dtype == 1) return geometry_of<__nv_bfloat16>(B, S, H, D, grid3, threads, smem, attrs);
  return static_cast<int>(cudaErrorInvalidValue);
}
