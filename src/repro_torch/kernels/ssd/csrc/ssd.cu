// K4: the Mamba-2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py::ssd_pallas (body
// _ssd_kernel).  For each (batch b, head h) and each chunk of L steps, with
// cum = cumsum(la) over the chunk and total = cum[L-1]:
//
//     Y_diag = (tril(exp(cum_t - cum_s)) * (C B^T)) X         (L x P)
//     Y_off  = exp(cum_t) * (C R^T)                            (L x P)
//     R'     = exp(total) * R + (X * exp(total - cum))^T B    (P x N)
//
// and emits Y = Y_diag + Y_off and the state after the last chunk.  Unlike
// the TPU kernel it takes an fp32 initial state R (the model's prefill hands
// one in), and it reads B and C shared across heads, (B,S,N), by index: the
// TPU path broadcast them to (B,S,H,N), which would read H times the bytes.
// Per-head (B,S,H,N) B and C work too.  A ragged last chunk is masked in the
// kernel: rows past S load as zeros, as the reference's zero padding, and are
// not stored.  The final state is written in X's dtype, as ssd_reference
// returns it.
//
// What bounds it on the card: per chunk it does four L x L x N-sized products
// (~4 * 64^3 FMA at Zamba2's L = P = N = 64) on 2 * L * P + 2 * L * N values,
// about 70 operations per byte read: below the H100's ~295 for bf16, so the
// least time is the bytes, X read once and Y written once (~0.1 ms at Zamba2
// prefill in bf16).  This first version is far from that: the chunks of one
// (b, h) are sequential, and the products run as fp32 FMA on the CUDA cores.
//
// What the design does about it: the TPU carried R across the sequential
// chunk grid axis in VMEM.  On Hopper, blocks run in no order, so one block
// of 256 threads per (b, h) loops over the chunks itself and keeps R (P x N
// fp32, 16 KB at 64 x 64) in shared memory for the whole sequence: R never
// touches device memory, and X, B, C are read once and Y written once.  Each
// product is register-tiled 4 x 4 per thread over 64 x 64 output tiles, so
// each shared-memory read feeds 4 FMAs; rows are padded to odd strides so
// transposed reads hit distinct banks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// acc[i][j] += sum_k A(i0+ty+16i, k) * B(k, j0+tx+16j) for k < K, with
// A(i, k) = A[i*a_i + k*a_k] and B(k, j) = B[k*b_k + j*b_j] in shared memory.
// Rows >= M and columns >= NC read as 0.  One fp32 FMA per k, k in order.
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], int i0, int j0, int M, int NC,
                                         int K, const float* A, int a_i, int a_k,
                                         const float* B, int b_k, int b_j, int ty, int tx) {
  int ai[4], bj[4];
  bool iv[4], jv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty + 16 * i;
    iv[i] = r < M;
    ai[i] = iv[i] ? r * a_i : 0;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = j0 + tx + 16 * j;
    jv[j] = c < NC;
    bj[j] = jv[j] ? c * b_j : 0;
  }
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = iv[i] ? A[ai[i] + k * a_k] : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = jv[j] ? B[k * b_k + bj[j]] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ X, const float* __restrict__ la, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ init, T* __restrict__ Y,
           T* __restrict__ fin, int S, int H, int P, int N, int L, int bc_per_head) {
  extern __shared__ float smem[];
  const int NP = N + 1, LP = L + 1;
  float* xs = smem;             // L x P   (X of the chunk; later X * exp(total - cum))
  float* bs = xs + L * P;       // L x NP
  float* cs = bs + L * NP;      // L x NP
  float* ws = cs + L * NP;      // L x LP  (masked decay * C B^T)
  float* rs = ws + L * LP;      // P x NP  (the carried state R)
  float* cum = rs + P * NP;     // L
  float* ecum = cum + L;        // L: exp(cum)
  float* dte = ecum + L;        // L: exp(total - cum)
  float* las = dte + L;         // L

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / H, h = blockIdx.x % H;

  const int64_t x_row = (int64_t)H * P;               // stride of s in X / Y
  const T* xb = X + ((int64_t)b * S * H + h) * P;
  T* yb = Y + ((int64_t)b * S * H + h) * P;
  const float* lab = la + (int64_t)b * S * H + h;     // stride H
  const int64_t bc_row = bc_per_head ? (int64_t)H * N : (int64_t)N;
  const int64_t bc_off = bc_per_head ? ((int64_t)b * S * H + h) * N : (int64_t)b * S * N;
  const T* bb = Bm + bc_off;
  const T* cb = Cm + bc_off;

  const float* ib = init ? init + (int64_t)blockIdx.x * P * N : nullptr;
  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e % N;
    rs[p * NP + n] = ib ? ib[e] : 0.0f;
  }

  const int nc = (S + L - 1) / L;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * L;
    __syncthreads();  // the previous chunk's xs / bs are no longer read
    for (int e = tid; e < L * P; e += THREADS) {
      const int r = e / P, p = e % P;
      const int s = s0 + r;
      xs[e] = s < S ? to_f32(xb[s * x_row + p]) : 0.0f;
    }
    for (int e = tid; e < L * N; e += THREADS) {
      const int r = e / N, n = e % N;
      const int s = s0 + r;
      const bool ok = s < S;
      bs[r * NP + n] = ok ? to_f32(bb[s * bc_row + n]) : 0.0f;
      cs[r * NP + n] = ok ? to_f32(cb[s * bc_row + n]) : 0.0f;
    }
    for (int r = tid; r < L; r += THREADS) {
      const int s = s0 + r;
      las[r] = s < S ? lab[(int64_t)s * H] : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int r = 0; r < L; ++r) {
        run += las[r];
        cum[r] = run;
      }
    }
    __syncthreads();
    const float total = cum[L - 1];
    for (int r = tid; r < L; r += THREADS) {
      ecum[r] = expf(cum[r]);
      dte[r] = expf(total - cum[r]);
    }

    // W = tril(exp(cum_t - cum_s)) * (C B^T): A = C (t, n), B(n, s) = B[s][n]
    for (int i0 = 0; i0 < L; i0 += 64)
      for (int j0 = 0; j0 < L; j0 += 64) {
        float acc[4][4];
        zero(acc);
        tile_mma(acc, i0, j0, L, L, N, cs, NP, 1, bs, 1, NP, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = i0 + ty + 16 * i;
          if (t >= L) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = j0 + tx + 16 * j;
            if (s < L) ws[t * LP + s] = t >= s ? expf(cum[t] - cum[s]) * acc[i][j] : 0.0f;
          }
        }
      }
    __syncthreads();

    // Y = W X + exp(cum_t) * (C R^T), with R the state before this chunk
    for (int i0 = 0; i0 < L; i0 += 64)
      for (int j0 = 0; j0 < P; j0 += 64) {
        float yd[4][4], yo[4][4];
        zero(yd);
        zero(yo);
        tile_mma(yd, i0, j0, L, P, L, ws, LP, 1, xs, P, 1, ty, tx);
        tile_mma(yo, i0, j0, L, P, N, cs, NP, 1, rs, 1, NP, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = i0 + ty + 16 * i;
          if (t >= L || s0 + t >= S) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = j0 + tx + 16 * j;
            if (p < P) yb[(s0 + t) * x_row + p] = from_f32<T>(yd[i][j] + ecum[t] * yo[i][j]);
          }
        }
      }
    __syncthreads();

    // X * exp(total - cum), in place: Y no longer reads xs
    for (int e = tid; e < L * P; e += THREADS) xs[e] *= dte[e / P];
    __syncthreads();

    // R' = exp(total) * R + (X * dte)^T B: A(p, s) = xs[s][p], B(s, n) = bs[s][n]
    const float etot = expf(total);
    for (int i0 = 0; i0 < P; i0 += 64)
      for (int j0 = 0; j0 < N; j0 += 64) {
        float acc[4][4];
        zero(acc);
        tile_mma(acc, i0, j0, P, N, L, xs, 1, P, bs, NP, 1, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = i0 + ty + 16 * i;
          if (p >= P) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = j0 + tx + 16 * j;
            if (n < N) rs[p * NP + n] = etot * rs[p * NP + n] + acc[i][j];
          }
        }
      }
  }
  __syncthreads();

  T* fb = fin + (int64_t)blockIdx.x * P * N;
  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e % N;
    fb[e] = from_f32<T>(rs[p * NP + n]);
  }
}

size_t smem_bytes(int P, int N, int L) {
  const size_t NP = N + 1, LP = L + 1;
  return sizeof(float) * ((size_t)L * P + 2 * L * NP + L * LP + (size_t)P * NP + 4 * (size_t)L);
}

template <typename T>
int launch(const void* X, const float* la, const void* Bm, const void* Cm, const float* init,
           void* Y, void* fin, int B, int S, int H, int P, int N, int L, int bc_per_head,
           void* stream) {
  const size_t smem = smem_bytes(P, N, L);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<T><<<B * H, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), la, static_cast<const T*>(Bm), static_cast<const T*>(Cm), init,
      static_cast<T*>(Y), static_cast<T*>(fin), S, H, P, N, L, bc_per_head);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs, in bytes (the wrapper refuses more than the
// card gives a block).
extern "C" long long pccl_ssd_smem_bytes(int P, int N, int L) {
  return static_cast<long long>(smem_bytes(P, N, L));
}

// Plain C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16 (X, B, C,
// Y, fin); la and init are float32; init may be null (zero state).  X and Y
// (B,S,H,P), la (B,S,H), B and C (B,S,N) or (B,S,H,N) by bc_per_head, init
// and fin (B,H,P,N), all contiguous.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int pccl_ssd(int dtype, const void* X, const void* la, const void* Bm, const void* Cm,
                        const void* init, void* Y, void* fin, int B, int S, int H, int P, int N,
                        int L, int bc_per_head, void* stream) {
  const float* laf = static_cast<const float*>(la);
  const float* initf = static_cast<const float*>(init);
  if (dtype == 0)
    return launch<float>(X, laf, Bm, Cm, initf, Y, fin, B, S, H, P, N, L, bc_per_head, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(X, laf, Bm, Cm, initf, Y, fin, B, S, H, P, N, L, bc_per_head,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
