// K4: the Mamba-2 SSD chunked scan, for Hopper (sm_90a): the CUDA-core route
// (fp32, and bf16 shapes off the tensor-core route of ssd_sm90.cu).
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
// Per-head (B,S,H,N) B and C work too.  A ragged last chunk is masked: rows
// past S load as zeros, as the reference's zero padding, and are not stored.
// The final state is written in X's dtype, as ssd_reference returns it.
//
// The TPU carried R across a sequential chunk grid axis.  Hopper's blocks
// run in no order, so the scan is three passes (ssd_common.cuh): chunk
// states, the recurrence across chunks, outputs.  Passes 1 and 3 run one
// block of 256 threads per (b, h, chunk); 20,480 blocks at Zamba2's prefill
// (4, 4096, 80, 64), where one block per (b, h) walking its 64 chunks in
// order gave 320.  What bounds each pass on the card:
//   1. states: one L x P x N product per chunk, (X * dte)^T B, in fp32 FMA
//      on the CUDA cores: operations.
//   2. recurrence: elementwise, reads S and writes R_before, both fp32:
//      bytes.
//   3. outputs: three products per chunk, C B^T, W X and C R^T, in fp32
//      FMA: operations.
// Each product is register-tiled 4 x 4 per thread over 64 x 64 output tiles
// (tile_mma), so each shared-memory read feeds 4 FMAs; rows are padded to
// odd strides so transposed reads hit distinct banks.  fp32 stays off the
// tensor cores: TF32, their fp32 input, misses the fp32 tolerance.

#include "ssd_common.cuh"

namespace {

using namespace ssd;

constexpr int THREADS = 256;  // 16 x 16

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

// Where one chunk's operands lie in device memory.
template <typename T>
struct ChunkIn {
  const T* x;        // X[b, s0, h, :], rows H*P apart
  const T* bm;       // B[b, s0, (h,) :], rows bc_row apart
  const T* cm;
  const float* la;   // la[b, s0, h], H apart
  int64_t x_row, bc_row;
  int valid;         // rows of the chunk before S

  __device__ ChunkIn(const T* X, const T* Bm, const T* Cm, const float* la_, int S, int H,
                     int P, int N, int L, int bc_per_head, const Chunk& k) {
    const int s0 = k.c * L;
    x_row = (int64_t)H * P;
    x = X + ((int64_t)k.b * S + s0) * x_row + (int64_t)k.h * P;
    bc_row = bc_per_head ? (int64_t)H * N : (int64_t)N;
    const int64_t bc_off = ((int64_t)k.b * S + s0) * bc_row + (bc_per_head ? (int64_t)k.h * N : 0);
    bm = Bm + bc_off;
    cm = Cm ? Cm + bc_off : nullptr;
    la = la_ + ((int64_t)k.b * S + s0) * H + k.h;
    valid = min(L, S - s0);
  }
};

// rows x cols of a chunk operand into shared memory (row stride ld) as fp32,
// rows at or past `valid` as zeros
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, int64_t src_row,
                                          int rows, int cols, int valid) {
  for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
    const int r = e / cols, q = e % cols;
    dst[r * ld + q] = r < valid ? to_f32(src[r * src_row + q]) : 0.0f;
  }
}

// Pass 1: S_c = (X * exp(total - cum))^T B, fp32, and total_c.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_states_kernel(const T* __restrict__ X, const float* __restrict__ la, const T* __restrict__ Bm,
                  float* __restrict__ states, float* __restrict__ totals, int S, int H, int P,
                  int N, int L, int nc, int bc_per_head) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* xs = smem;          // L x P: X, then X * exp(total - cum)
  float* bs = xs + L * P;    // L x NP
  float* cum = bs + L * NP;  // L
  float* dte = cum + L;      // L: exp(total - cum)

  const int tid = threadIdx.x;
  const Chunk k = chunk_of_block(H, nc);
  const ChunkIn<T> in(X, Bm, nullptr, la, S, H, P, N, L, bc_per_head, k);
  load_rows(xs, P, in.x, in.x_row, L, P, in.valid);
  load_rows(bs, NP, in.bm, in.bc_row, L, N, in.valid);
  if (tid < 32) chunk_cumsum(in.la, H, in.valid, L, cum);
  __syncthreads();
  const float total = cum[L - 1];
  for (int r = tid; r < L; r += THREADS) dte[r] = expf(total - cum[r]);
  __syncthreads();
  for (int e = tid; e < L * P; e += THREADS) xs[e] *= dte[e / P];
  __syncthreads();

  const int ty = tid >> 4, tx = tid & 15;
  const int64_t bhc = ((int64_t)k.b * H + k.h) * nc + k.c;
  float* out = states + bhc * P * N;
  for (int i0 = 0; i0 < P; i0 += 64)
    for (int j0 = 0; j0 < N; j0 += 64) {
      float acc[4][4];
      zero(acc);
      // A(p, s) = xs[s][p], B(s, n) = bs[s][n]
      tile_mma(acc, i0, j0, P, N, L, xs, 1, P, bs, NP, 1, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = i0 + ty + 16 * i;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = j0 + tx + 16 * j;
          if (n < N) out[p * N + n] = acc[i][j];
        }
      }
    }
  if (tid == 0) totals[bhc] = total;
}

// Pass 3: Y = (tril(exp(cum_t - cum_s)) * (C B^T)) X + exp(cum_t) * (C R^T),
// with R the (fp32) state before the chunk.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_outputs_kernel(const T* __restrict__ X, const float* __restrict__ la,
                   const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const float* __restrict__ before, T* __restrict__ Y, int S, int H, int P,
                   int N, int L, int nc, int bc_per_head) {
  extern __shared__ float smem[];
  const int NP = N + 1, LP = L + 1;
  float* xs = smem;             // L x P
  float* bs = xs + L * P;       // L x NP
  float* cs = bs + L * NP;      // L x NP
  float* ws = cs + L * NP;      // L x LP: masked decay * C B^T
  float* rs = ws + L * LP;      // P x NP: the state before this chunk
  float* cum = rs + P * NP;     // L
  float* ecum = cum + L;        // L: exp(cum)

  const int tid = threadIdx.x;
  const Chunk k = chunk_of_block(H, nc);
  const ChunkIn<T> in(X, Bm, Cm, la, S, H, P, N, L, bc_per_head, k);
  const int64_t bhc = ((int64_t)k.b * H + k.h) * nc + k.c;
  load_rows(xs, P, in.x, in.x_row, L, P, in.valid);
  load_rows(bs, NP, in.bm, in.bc_row, L, N, in.valid);
  load_rows(cs, NP, in.cm, in.bc_row, L, N, in.valid);
  load_rows(rs, NP, before + bhc * P * N, N, P, N, P);
  if (tid < 32) chunk_cumsum(in.la, H, in.valid, L, cum);
  __syncthreads();
  for (int r = tid; r < L; r += THREADS) ecum[r] = expf(cum[r]);

  const int ty = tid >> 4, tx = tid & 15;
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

  // Y = W X + exp(cum_t) * (C R^T)
  T* yb = Y + ((int64_t)k.b * S + k.c * L) * in.x_row + (int64_t)k.h * P;
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
        if (t >= in.valid) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = j0 + tx + 16 * j;
          if (p < P) yb[t * in.x_row + p] = from_f32<T>(yd[i][j] + ecum[t] * yo[i][j]);
        }
      }
    }
}

size_t states_smem(int P, int N, int L) {
  return sizeof(float) * ((size_t)L * P + (size_t)L * (N + 1) + 2 * (size_t)L);
}

size_t outputs_smem(int P, int N, int L) {
  const size_t NP = N + 1, LP = L + 1;
  return sizeof(float) *
         ((size_t)L * P + 2 * L * NP + L * LP + (size_t)P * NP + 2 * (size_t)L);
}

template <typename T>
int launch(const void* X, const float* la, const void* Bm, const void* Cm, const float* init,
           void* Y, void* fin, float* states, float* totals, float* before, int B, int S, int H,
           int P, int N, int L, int bc_per_head, cudaStream_t stream) {
  const int nc = (S + L - 1) / L;
  const int blocks = B * H * nc;
  const size_t smem1 = states_smem(P, N, L), smem3 = outputs_smem(P, N, L);
  cudaError_t err = cudaFuncSetAttribute(ssd_states_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_outputs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* x = static_cast<const T*>(X);
  const T* bm = static_cast<const T*>(Bm);
  ssd_states_kernel<T><<<blocks, THREADS, smem1, stream>>>(x, la, bm, states, totals, S, H, P, N,
                                                           L, nc, bc_per_head);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  e = launch_recurrence<float, T>(states, totals, init, before, fin, B * H, nc, P * N, stream);
  if (e != 0) return e;
  ssd_outputs_kernel<T><<<blocks, THREADS, smem3, stream>>>(
      x, la, bm, static_cast<const T*>(Cm), before, static_cast<T*>(Y), S, H, P, N, L, nc,
      bc_per_head);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the larger of passes 1 and 3 needs per block, in bytes (the
// wrapper refuses more than the card gives a block).
extern "C" long long pccl_ssd_smem_bytes(int P, int N, int L) {
  const size_t a = states_smem(P, N, L), b = outputs_smem(P, N, L);
  return static_cast<long long>(a > b ? a : b);
}

// Plain C interface for ctypes.  dtype: 0 = float32, 1 = bfloat16 (X, B, C,
// Y, fin); la and init are float32; init may be null (zero state).  X and Y
// (B,S,H,P), la (B,S,H), B and C (B,S,N) or (B,S,H,N) by bc_per_head, init
// and fin (B,H,P,N), all contiguous.  Scratch from the caller, fp32: states
// and before (B,H,nc,P,N), totals (B,H,nc), nc = ceil(S / L).  Three
// launches on `stream`; returns the first non-zero cudaGetLastError() after
// a launch (0 = all three launched).
extern "C" int pccl_ssd(int dtype, const void* X, const void* la, const void* Bm, const void* Cm,
                        const void* init, void* Y, void* fin, void* states, void* totals,
                        void* before, int B, int S, int H, int P, int N, int L, int bc_per_head,
                        void* stream) {
  const float* laf = static_cast<const float*>(la);
  const float* initf = static_cast<const float*>(init);
  float* st = static_cast<float*>(states);
  float* tot = static_cast<float*>(totals);
  float* rb = static_cast<float*>(before);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(X, laf, Bm, Cm, initf, Y, fin, st, tot, rb, B, S, H, P, N, L,
                         bc_per_head, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(X, laf, Bm, Cm, initf, Y, fin, st, tot, rb, B, S, H, P, N, L,
                                 bc_per_head, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
